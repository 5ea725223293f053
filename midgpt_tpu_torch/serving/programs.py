"""The serving engine's one-dispatch programs: the counterpart of the JAX
engine's ``_cached_program`` programs, ``make_decode_window`` and
``make_verify_program``, each jitted with donation and run as one
launch.

A :class:`Program` owns static tensors: the slots' integer state in one
int32 buffer (an int64 view holds the request seeds) and, for soft
drafts, the draft probabilities. Its body reads them with the engine's
carried logits and page pool, writes the new logits and the pages in
place, and returns its results packed in one int32 tensor. A dispatch
is three calls:

- :meth:`Program.load`: the host state into a pinned host mirror, then
  one host-to-device copy (two with soft drafts). The mirrors are a
  ring of :data:`MIRRORS`, each with an event recorded after its copy:
  a dispatch that reads nothing back (a prefill chunk) may be loaded
  again before its copy has run, and a mirror is rewritten only once
  its last copy is done;
- :meth:`Program.run`: on the card one replay of the body's CUDA graph,
  captured at the first run; on the CPU the body, eagerly;
- :meth:`Program.read`: one device-to-host copy of the packed results,
  then a wait for the stream.

The capture is what a program's first run pays: an eager warm-up call of
the body on a quiet state (every slot done, so no page is written; the
carried logits are restored after it) builds the kernels' libraries and
makes their scratch buffers and cached tables outside the capture, then
the capture on a stream of its own. Both run under
:func:`~midgpt_tpu_torch.ops.launches.recording`: the warm-up's
launches are kept on the program, and every replay counts the capture's
launches, kernel by kernel. A capture holds one lock for the process and
runs in ``capture_error_mode="thread_local"``, so another thread may
queue, allocate and wait for its own stream meanwhile (a serving
cluster's replica workers). CUDA forbids a device-wide synchronize
(``torch.cuda.synchronize``) while any stream captures: one made on
another thread invalidates the capture, and no serving path makes one
while it steps. A capture or a replay that fails raises: nothing falls
back to eager launches on the card.
"""

from __future__ import annotations

import contextlib
import gc
import math
import threading
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.ops import launches

_NP = {torch.int32: np.int32, torch.int64: np.int64}
# pinned host mirrors of a program's integer inputs on the card, used in
# turn (the CPU copies at once and keeps one)
MIRRORS = 4
# one capture at a time in the process (torch.cuda.graph's contract)
_CAPTURE_LOCK = threading.Lock()
_LOCAL = threading.local()


@contextlib.contextmanager
def capturing() -> tp.Iterator[None]:
    """Hold the process's capture lock with Python's cyclic garbage
    collector paused. ``torch.cuda.graph`` no longer collects before it
    begins, so a collection inside a capture could free a dead engine's
    graph or graph pool, CUDA calls a capture forbids (the process
    aborts); the garbage is collected after the capture instead."""
    with _CAPTURE_LOCK:
        paused = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if paused:
                gc.enable()


def warming_up() -> bool:
    """True while this thread runs a program's warm-up call, whose
    results are discarded (for instruments that record model calls)."""
    return getattr(_LOCAL, "warmup", False)


class Program:
    """One dispatch kind's program on one engine.

    ``fields`` lays out the integer inputs, ``(name, shape, dtype)`` with
    dtype int32 or int64; ``probs_shape`` adds a float32 input ``probs``.
    The body, ``body(inputs, probs)``, returns the packed int32 results;
    it is passed to each run (the engine's bound method: a program keeps
    no reference to its engine). ``quiet(inputs)`` sets the inputs to a
    state in which the body writes no page; ``carry`` are the tensors the
    body updates in place that the warm-up must leave as it found them.
    ``pool`` is the CUDA graph memory pool the engine's programs share."""

    def __init__(self, key: tp.Tuple, device: torch.device,
                 fields: tp.Sequence[tp.Tuple[str, tp.Tuple[int, ...],
                                              torch.dtype]],
                 quiet: tp.Callable[[tp.Dict[str, torch.Tensor]], None],
                 carry: tp.Sequence[torch.Tensor] = (),
                 probs_shape: tp.Optional[tp.Tuple[int, ...]] = None,
                 pool=None):
        self.key = key
        self.device = device
        self.quiet, self.carry = quiet, tuple(carry)
        self.pool = pool
        cuda = device.type == "cuda"
        spans, n = [], 0
        for name, shape, dtype in fields:
            width = 2 if dtype == torch.int64 else 1
            n += n % width  # an int64 view starts 8-byte aligned
            size = math.prod(shape) * width
            spans.append((name, n, size, shape, dtype))
            n += size
        self._ints = torch.zeros(n, dtype=torch.int32, device=device)
        self._hosts = [torch.zeros(n, dtype=torch.int32, pin_memory=cuda)
                       for _ in range(MIRRORS if cuda else 1)]
        self._copied = ([torch.cuda.Event() for _ in self._hosts] if cuda
                        else [])
        self._turn = 0  # the mirror the next load() writes
        self._last = 0  # the mirror the last load() wrote
        self._host = self._hosts[0]
        self.inputs: tp.Dict[str, torch.Tensor] = {}
        self._mirrors: tp.List[tp.Dict[str, np.ndarray]] = [
            {} for _ in self._hosts]
        for name, o, size, shape, dtype in spans:
            self.inputs[name] = self._ints[o : o + size].view(dtype).view(
                shape)
            for host, mirror in zip(self._hosts, self._mirrors):
                mirror[name] = host.numpy()[o : o + size].view(
                    _NP[dtype]).reshape(shape)
        self.probs = self._probs_host = None
        if probs_shape is not None:
            self.probs = torch.zeros(probs_shape, dtype=torch.float32,
                                     device=device)
            self._probs_host = torch.zeros(probs_shape, dtype=torch.float32,
                                           pin_memory=cuda)
        self.graph: tp.Optional[torch.cuda.CUDAGraph] = None
        self.out: tp.Optional[torch.Tensor] = None
        self._out_host: tp.Optional[torch.Tensor] = None
        self.capture_ms: tp.Optional[float] = None
        # {wrapper: launches} of one replay, and of the warm-up call
        self.replay_launches: tp.Dict[tp.Callable, int] = {}
        self.warmup_launches: tp.Dict[tp.Callable, int] = {}

    def load(self, probs: tp.Optional[np.ndarray] = None,
             **arrays: np.ndarray) -> None:
        """Copy host arrays (by field name) into the static inputs. The
        mirror is pinned, so the copy is queued, not waited for. The next
        mirror of the ring is written once its previous copy has run (its
        event); fields not given keep what the last load gave. The probs
        mirror is one: only a verify dispatch, whose :meth:`read` waits
        for its stream, loads it."""
        i = self._turn
        self._turn = (i + 1) % len(self._hosts)
        if self._copied:
            self._copied[i].synchronize()
            self._hosts[i].numpy()[...] = self._host.numpy()
        for name, a in arrays.items():
            self._mirrors[i][name][...] = a
        self._host, self._last = self._hosts[i], i
        self._ints.copy_(self._host, non_blocking=True)
        if self._copied:
            self._copied[i].record(torch.cuda.current_stream(self.device))
        if probs is not None:
            self._probs_host.numpy()[...] = probs
            self.probs.copy_(self._probs_host, non_blocking=True)

    def run(self, body: tp.Callable[..., torch.Tensor]) -> None:
        """One dispatch of ``body``: on the card the graph's replay (its
        capture at the first run), on the CPU the body itself."""
        if self.device.type != "cuda":
            self.out = body(self.inputs, self.probs)
            return
        if self.graph is None:
            self._capture(body)
        self.graph.replay()
        launches.add(self.replay_launches)

    def run_eager(self, body: tp.Callable[..., torch.Tensor]) -> None:
        """``body``'s eager launches on the same static inputs, never the
        graph: the twin a check compares a replay with."""
        self.out = body(self.inputs, self.probs)

    def read(self) -> np.ndarray:
        """The packed results on the host: one copy, then a wait for the
        current stream."""
        if self.device.type != "cuda":
            return self.out.numpy().copy()
        if self._out_host is None or self._out_host.shape != self.out.shape:
            self._out_host = torch.empty(self.out.shape, dtype=torch.int32,
                                         pin_memory=True)
        self._out_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy().copy()

    def _capture(self, body: tp.Callable[..., torch.Tensor]) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with capturing():
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                saved = [t.clone() for t in self.carry]
                self.quiet(self.inputs)
                _LOCAL.warmup = True
                try:
                    with launches.recording() as warm:
                        body(self.inputs, self.probs)
                finally:
                    _LOCAL.warmup = False
                for t, s in zip(self.carry, saved):
                    t.copy_(s)
                # the state load() copied in, in place of the quiet one
                self._ints.copy_(self._host, non_blocking=True)
            with launches.recording() as rec:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = body(self.inputs, self.probs)
            cur.wait_stream(stream)
            # the capture's stream read the last mirror too
            self._copied[self._last].record(cur)
        self.graph, self.out = graph, out
        self.replay_launches, self.warmup_launches = rec, warm
        self.capture_ms = 1e3 * (time.perf_counter() - t0)


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in CUDA graph memory pool
    ``pool`` (the segments a graph capture made there)."""
    want = tuple(pool)
    return int(sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == want))
