"""Training checkpoints with ``torch.save`` (counterpart of
``midgpt_tpu.checkpoint``, which saves through Orbax's asynchronous
checkpointer).

One file per saved step, ``<rundir>/checkpoints/step_<N>.pt``, holding
the named items (f32 master parameters, Adam moments and count, step)
and JSON-able metadata (step, loader state, model fingerprint, config).
A save between intervals is a no-op unless forced; the newest ``keep``
files are kept. Files are written to a temporary name and renamed, so a
crash mid-save never leaves a torn checkpoint behind.

A save is asynchronous by default: ``save`` copies every tensor into
host buffers (pinned for card tensors, allocated at the first save and
reused), waits once for the copies, hands the write to a background
thread and returns. The items may change as soon as it returns. One
write is in flight at a time: the next save waits for it. ``wait`` and
``close`` join it, and an exception raised by the writer is raised at
the next ``save``, ``wait`` or ``close``. The step being written counts
as saved (``all_steps``, ``latest_step``).
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
import threading
import typing as tp

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def config_fingerprint(config_dict: tp.Mapping[str, tp.Any]) -> str:
    """Stable hash of a config dict for resume-compatibility checks."""
    blob = json.dumps(config_dict, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class Checkpointer:
    def __init__(self, rundir: str, *, keep: int = 1,
                 save_interval_steps: int = 1000, async_save: bool = True):
        self.directory = os.path.join(os.path.abspath(rundir), "checkpoints")
        self.keep = keep
        self.interval = save_interval_steps
        self.async_save = async_save
        self._buffers: tp.Dict[str, torch.Tensor] = {}
        self._writer: tp.Optional[threading.Thread] = None
        self._in_flight: tp.Optional[int] = None
        self._error: tp.Optional[BaseException] = None
        self._card_copies = False

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def _disk_steps(self) -> tp.List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def all_steps(self) -> tp.List[int]:
        """Steps on disk, and the step being written."""
        steps = set(self._disk_steps())
        if self._in_flight is not None:
            steps.add(self._in_flight)
        return sorted(steps)

    def latest_step(self) -> tp.Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, items: tp.Mapping[str, tp.Any],
             meta: tp.Mapping[str, tp.Any], force: bool = False,
             owned: bool = False) -> bool:
        """Save at interval steps, or any step with ``force``; a step
        already saved (or being written) is not written again. Returns
        whether it saved. ``owned``: the items' tensors are host tensors
        the caller hands over and never changes, written as they are
        (no snapshot into this checkpointer's buffers)."""
        if self._writer is not None and not self._writer.is_alive():
            self.wait()  # reap a finished write, raising its error
        if step in self.all_steps():
            return False
        if not force and step % self.interval != 0:
            return False
        self.wait()  # one write in flight; its buffers are reused below
        self._card_copies = False
        blob = {"items": dict(items) if owned
                 else self._snapshot(items, ""),
                "meta": copy.deepcopy(dict(meta))}
        if self._card_copies:
            torch.cuda.synchronize()  # the snapshot is whole from here on
        self._in_flight = step
        if self.async_save:
            self._writer = threading.Thread(target=self._write,
                                            args=(step, blob), daemon=True)
            self._writer.start()
        else:
            self._write(step, blob)
            self.wait()
        return True

    @torch.no_grad()
    def _snapshot(self, obj: tp.Any, path: str) -> tp.Any:
        """``obj`` with every tensor copied into this checkpointer's host
        buffer for ``path`` (a card tensor's copy is asynchronous)."""
        if isinstance(obj, torch.Tensor):
            buf = self._buffers.get(path)
            if (buf is None or buf.shape != obj.shape
                    or buf.dtype != obj.dtype):
                buf = torch.empty(obj.shape, dtype=obj.dtype,
                                  pin_memory=obj.is_cuda)
                self._buffers[path] = buf
            buf.copy_(obj, non_blocking=obj.is_cuda)
            self._card_copies |= obj.is_cuda
            return buf
        if isinstance(obj, tp.Mapping):
            return {k: self._snapshot(v, f"{path}/{k}")
                    for k, v in obj.items()}
        return copy.deepcopy(obj)

    def _write(self, step: int, blob: tp.Dict[str, tp.Any]) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(self.directory, exist_ok=True)
            torch.save(blob, tmp)
            os.replace(tmp, path)
            for old in self._disk_steps()[: -self.keep]:
                os.remove(self._path(old))
        except BaseException as exc:  # raised on the training thread
            self._error = exc
            if os.path.exists(tmp):
                os.remove(tmp)

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._in_flight = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def close(self) -> None:
        """Flush the write in flight and drop the host buffers."""
        try:
            self.wait()
        finally:
            self._buffers.clear()

    def restore(self, step: tp.Optional[int] = None,
                map_location: tp.Union[None, str, torch.device] = None,
                ) -> tp.Tuple[tp.Dict[str, tp.Any], tp.Dict[str, tp.Any]]:
        """``(items, meta)`` of ``step`` (default the newest). The tensors
        are memory-mapped from the file (copy-on-write), so an item never
        used (the Adam moments, for sampling) is never read."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        blob = torch.load(self._path(step), map_location=map_location,
                          weights_only=True, mmap=True)
        return blob["items"], blob["meta"]
