"""The trainer's dispatch programs: the counterpart of the JAX trainer's
``make_train_step`` (one jitted, donated step a dispatch) and of
``make_train_window`` / ``get_train_window`` (K steps fused into one
``lax.scan`` dispatch, memoized by program key).

A :class:`StepProgram` owns static tensors for a window of up to
``depth`` steps: the batches ``xs``/``ys [depth, G, B, T]``, one int32
input buffer that holds the step index ``idx`` (an int64 view), every
step's dropout site keys ``keys [depth, G, sites]`` (int64 views) and its
``scalars [depth, 3]`` (f32 views: lr, Adam's two bias corrections), and
the stacked results ``out [depth, 3]`` (f32: loss, grad norm, lr). The
step's body (``train.step_body``) reads row ``idx`` of each, runs the
step in place on the masters and moments, writes row ``idx`` of ``out``
and adds one to ``idx``. A dispatch is three calls:

- :meth:`StepProgram.load`: the window's host rows into a pinned host
  buffer, then ONE host-to-device copy, and the batches into ``xs``/``ys``;
- :meth:`StepProgram.run`, once a step: on the card the replay of the
  body's CUDA graph; on the CPU the body itself;
- :meth:`StepProgram.read`: one device-to-host copy of ``out``, then a
  wait for the stream (only where a window logs).

The first run of a program is its warm-up: the eager body on its real
step, on the program's own stream. It builds the kernels' libraries, the
cuBLAS workspace and the rope tables, and it is what the first-step
out-of-memory ladder guards. The second run frees the eager step's
gradients, empties the allocator's cache and captures the body on the
same stream under ``serving.programs``' capture lock in
``capture_error_mode="thread_local"``, then replays it. Every later run
is a replay: the graph re-reads ``idx``, the keys and the scalars from
device memory, so one graph serves every step and every window length.
A capture records the launches of every thread (autograd launches the
backward's kernels from its own device thread), and each replay counts
them again (``ops.launches``). A capture or a replay that fails raises:
nothing falls back to eager launches on the card.

A graph holds the addresses of the state it was captured on. A drive
binds a program to its state (:meth:`StepProgram.bind`); binding another
state, or :meth:`StepProgram.release` at the end of a drive, drops the
graph and its memory pool, and the next run warms up again.

Under a mesh the body holds the step's collectives (the shadow's
all-gather, the gradients' reduce-scatter and all-reduce, the norm's and
the loss's all-reduce, and under a sequence axis the ring's P2P hops or
Ulysses' all-to-alls, forward and backward; ``parallel.sharding``); its
batches are the rank's rows and, under a sequence axis, its columns.
Under gloo (the CPU) the body runs eager. NCCL's kernels are
captured into the same graph: the warm-up's eager body has made every
communicator before the capture, and each collective's stream forks from
and joins the capturing stream. The collective wrappers count their
launches as the kernels do, so a replay adds them again. The sequence
axis's P2P hops and all-to-alls (``parallel.exchange.GroupExchange``,
which waits on each P2P transfer) are designed for the same capture but
untested there: a one-card world never builds them, and no run on two
cards has been made.

:func:`get_train_window` memoizes one :class:`StepProgram` of depth K per
program key: JAX's ``_program_key`` rule (the program-relevant config,
the mesh and K), with the port's ``_NON_PROGRAM_FIELDS`` (JAX's, plus
``device``). Two drives that differ only in observability knobs get the
``is``-identical window; another K, another model or another mesh gets
another. K=1 takes a ``StepProgram`` of depth 1 of its own and never the
window cache.
"""

from __future__ import annotations

import json
import time
import typing as tp
import weakref

import numpy as np
import torch

from midgpt_tpu_torch.config import ExperimentConfig, to_dict
from midgpt_tpu_torch.models.layers import site_row
from midgpt_tpu_torch.ops import launches
from midgpt_tpu_torch.parallel.mesh import Mesh, single_device_mesh
from midgpt_tpu_torch.serving.programs import capturing

# scalars a step reads: lr, Adam's bias corrections 1 - b1^n, 1 - b2^n
N_SCALARS = 3
# results a step writes: loss, grad norm, lr
N_OUTPUTS = 3


class StepProgram:
    """The train step over static buffers for windows of up to ``depth``
    steps (see the module's docstring)."""

    def __init__(self, cfg: ExperimentConfig, device: torch.device,
                 depth: int, mesh: tp.Optional[Mesh] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = torch.device(device)
        self.depth = depth
        self.cuda = self.device.type == "cuda"
        # a rank's rows of each microbatch, and its columns of them
        g = cfg.g_accum_iters
        b = cfg.microbatch_size // (1 if mesh is None else mesh.data_shards)
        t = cfg.model.block_size // (1 if mesh is None else mesh.seq_size)
        self.sites = (site_row(cfg.model.n_layer)["size"]
                      if cfg.model.dropout > 0.0 else 0)
        n_keys = depth * g * self.sites
        # int32 words: idx (an int64), the keys (int64), the scalars (f32)
        self._spans = (2, 2 + 2 * n_keys, 2 + 2 * n_keys + N_SCALARS * depth)
        self._dev = torch.zeros(self._spans[2], dtype=torch.int32,
                                device=self.device)
        self.idx = self._dev[:2].view(torch.int64)
        self.keys = self._dev[2:self._spans[1]].view(torch.int64).view(
            depth, g, self.sites)
        self.scalars = self._dev[self._spans[1]:].view(torch.float32).view(
            depth, N_SCALARS)
        self.xs = torch.zeros(depth, g, b, t, dtype=torch.int64,
                              device=self.device)
        self.ys = torch.zeros_like(self.xs)
        self.out = torch.zeros(depth, N_OUTPUTS, dtype=torch.float32,
                               device=self.device)
        self._out_host: tp.Optional[torch.Tensor] = None
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.graph: tp.Optional[torch.cuda.CUDAGraph] = None
        self.pool = None
        self.warm = False
        self.capture_ms: tp.Optional[float] = None
        # {wrapper: launches} of one replay
        self.replay_launches: tp.Dict[tp.Callable, int] = {}
        self._bound: tp.Optional[weakref.ref] = None
        # set by the body where its update begins (the ladder's test that
        # the masters are untouched)
        self.updating = False

    # -- binding ---------------------------------------------------------

    def bind(self, owner: tp.Any) -> None:
        """Bind to a drive's state (``owner``, the object whose tensors the
        body updates): another owner than the bound one drops the graph."""
        if self._bound is not None and self._bound() is not owner:
            self.release()
        self._bound = weakref.ref(owner)

    def release(self) -> None:
        """Drop the graph, its memory pool and the binding; the next run
        warms up and captures again."""
        self.graph = self.pool = None
        self.warm = False
        self._bound = None
        self.replay_launches = {}

    # -- a dispatch ------------------------------------------------------

    def load(self, scalars: np.ndarray, keys: tp.Optional[np.ndarray],
             xs: torch.Tensor, ys: torch.Tensor, start: int = 0) -> None:
        """A window of ``k = len(scalars)`` steps: ``scalars [k, 3]`` (lr,
        bias corrections), ``keys [k, G, sites]`` (None without dropout)
        and the step index ``start`` in one host-to-device copy, then the
        batches ``xs``/``ys [k, G, B, T]`` (on the device) into the static
        ones. A fresh pinned buffer each load: the caching host allocator
        reuses it only after its copy has run."""
        k = len(scalars)
        if not 0 < k <= self.depth or not 0 <= start < k:
            raise ValueError(f"a window of {k} steps from {start} does not "
                             f"fit depth {self.depth}")
        host = torch.zeros(self._spans[2], dtype=torch.int32,
                           pin_memory=self.cuda)
        words = host.numpy()
        words[:2].view(np.int64)[0] = start
        if self.sites:
            words[2:self._spans[1]].view(np.int64).reshape(
                self.keys.shape)[:k] = keys
        words[self._spans[1]:].view(np.float32).reshape(
            self.scalars.shape)[:k] = scalars
        self._dev.copy_(host, non_blocking=self.cuda)
        self.xs[:k].copy_(xs)
        self.ys[:k].copy_(ys)

    @property
    def settled(self) -> bool:
        """Past the runs the out-of-memory ladder guards: the warm-up, and
        on the card the capture."""
        return self.graph is not None if self.cuda else self.warm

    def run(self, body: tp.Callable[[], None],
            free: tp.Optional[tp.Callable[[], None]] = None) -> None:
        """One step of ``body``: on the card the warm-up (the eager body),
        then (after ``free``, which drops the warm-up's gradients and
        cached blocks) the capture and a replay, then replays; on the CPU
        the body itself."""
        self.updating = False
        if not self.cuda:
            body()
            self.warm = True
            return
        if not self.warm:
            self._on_stream(body)
            self.warm = True
            return
        if self.graph is None:
            if free is not None:
                free()
            self._capture(body)
        self.graph.replay()
        launches.add(self.replay_launches)

    def read(self, k: int) -> np.ndarray:
        """``out[:k]`` on the host, ``[k, 3]`` (loss, grad norm, lr): one
        copy, then a wait for the current stream."""
        if not self.cuda:
            return self.out[:k].numpy().copy()
        if self._out_host is None:
            self._out_host = torch.empty(self.out.shape, dtype=torch.float32,
                                         pin_memory=True)
        self._out_host[:k].copy_(self.out[:k], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out_host[:k].numpy().copy()

    def _on_stream(self, fn: tp.Callable[[], None]) -> None:
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)

    def _capture(self, body: tp.Callable[[], None]) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        with capturing():
            self.stream.wait_stream(cur)
            try:
                with launches.recording(all_threads=True) as rec:
                    with torch.cuda.graph(graph, pool=pool,
                                          stream=self.stream,
                                          capture_error_mode="thread_local"):
                        body()
            except BaseException:
                self.updating = False  # a capture runs nothing
                raise
            cur.wait_stream(self.stream)
        self.graph, self.pool, self.replay_launches = graph, pool, rec
        self.capture_ms = 1e3 * (time.perf_counter() - t0)


# -- the window-program cache ------------------------------------------------

#: One StepProgram of depth K per (program-relevant config, K).
_WINDOW_PROGRAMS: tp.Dict[tp.Tuple, StepProgram] = {}

#: ExperimentConfig fields that cannot change the program: paths, run
#: length, logging / eval / ckpt cadence, seeds (keys are inputs), the
#: observability knobs (the JAX package's list, less its wandb switch)
#: and the device, which keys the cache beside the config.
_NON_PROGRAM_FIELDS = (
    "rundir", "data_dir", "max_steps", "eval_interval", "eval_batches",
    "eval_fixed", "log_interval", "ckpt_interval", "ckpt_keep", "seed",
    "data_seed", "debug", "steps_per_dispatch", "train_telemetry",
    "device",
)


def program_key(cfg: ExperimentConfig, device: torch.device,
                k: int, mesh: tp.Optional[Mesh] = None) -> tp.Tuple:
    """JAX's ``_program_key``: the program-relevant fields of ``cfg``, the
    mesh (axis names, grid shape, this rank's place; default the one-rank
    mesh), the device and K."""
    d = {name: v for name, v in to_dict(cfg).items()
         if name not in _NON_PROGRAM_FIELDS}
    mesh = single_device_mesh() if mesh is None else mesh
    return (json.dumps(d, sort_keys=True), mesh.key(),
            str(torch.device(device)), int(k))


def get_train_window(cfg: ExperimentConfig, device: torch.device,
                     k: int, mesh: tp.Optional[Mesh] = None) -> StepProgram:
    """The memoized window program of K steps for ``cfg`` on ``device``
    under ``mesh``."""
    key = program_key(cfg, device, k, mesh)
    prog = _WINDOW_PROGRAMS.get(key)
    if prog is None:
        prog = _WINDOW_PROGRAMS[key] = StepProgram(cfg, device, k, mesh)
    return prog
