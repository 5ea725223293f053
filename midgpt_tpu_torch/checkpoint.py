"""Training checkpoints with ``torch.save`` (counterpart of
``midgpt_tpu.checkpoint``, which saves through Orbax).

One file per saved step, ``<rundir>/checkpoints/step_<N>.pt``, holding
the named items (f32 master parameters, Adam moments and count, step)
and JSON-able metadata (step, loader state, model fingerprint, config).
A save between intervals is a no-op unless forced; the newest ``keep``
files are kept. Files are written to a temporary name and renamed, so a
crash mid-save never leaves a torn checkpoint behind.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import typing as tp

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def config_fingerprint(config_dict: tp.Mapping[str, tp.Any]) -> str:
    """Stable hash of a config dict for resume-compatibility checks."""
    blob = json.dumps(config_dict, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class Checkpointer:
    def __init__(self, rundir: str, *, keep: int = 1,
                 save_interval_steps: int = 1000):
        self.directory = os.path.join(os.path.abspath(rundir), "checkpoints")
        self.keep = keep
        self.interval = save_interval_steps

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> tp.List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> tp.Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, items: tp.Mapping[str, tp.Any],
             meta: tp.Mapping[str, tp.Any], force: bool = False) -> bool:
        """Save at interval steps, or any step with ``force``; a step
        already on disk is not written again. Returns whether it saved."""
        if step in self.all_steps():
            return False
        if not force and step % self.interval != 0:
            return False
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"items": dict(items), "meta": dict(meta)}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.keep]:
            os.remove(self._path(old))
        return True

    def restore(self, step: tp.Optional[int] = None,
                map_location: tp.Union[None, str, torch.device] = None,
                ) -> tp.Tuple[tp.Dict[str, tp.Any], tp.Dict[str, tp.Any]]:
        """``(items, meta)`` of ``step`` (default the newest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        blob = torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
        return blob["items"], blob["meta"]
