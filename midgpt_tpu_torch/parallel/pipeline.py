"""GPipe pipeline parallelism over the mesh's ``pipeline`` axis
(counterpart of ``midgpt_tpu.parallel.pipeline``).

The layers split into ``S`` stages of ``L / S`` consecutive layers
(:func:`stage_layers`); a step's rows split into ``M`` microbatches
(:func:`microbatches`). :func:`pipeline_run` streams them through the
stages over an exchange the caller gives, as JAX's ``pipeline_forward``
does inside its ``shard_map``:

- **forward**: stage 0 takes microbatch ``m``, each stage runs its
  layers without keeping their activations and hands the result, in the
  boundary dtype, to the next stage; a stage keeps only each
  microbatch's input (whole-stage rematerialization: JAX's
  ``jax.checkpoint`` around the stage body). The last stage only stores
  what it receives: its forward feeds the loss alone, which the backward
  computes when it recomputes the stage;
- **backward**, in microbatch order ``0 .. M-1`` on every stage (so a
  stage's parameter gradients accumulate in the single-card trainer's
  microbatch order): the stage forward is recomputed with autograd on,
  run backward from the gradient the next stage sent (the last stage from
  its loss), and the input's gradient goes to the previous stage.

JAX derives that backward by AD (``ppermute``'s transpose, the scan run
backwards); PyTorch has no transpose of a P2P op, so the port writes it
out. Nothing here reads a device value on the host: every hand-off is a
device copy, so a step's CUDA graph captures the schedule whole.

Two exchanges, as for the sequence axis (``parallel.exchange``):

- :class:`GroupPipe`, the trainer's: this rank of the ``pipeline``
  process group holds one stage; a hand-off is one counted P2P batch
  (``parallel.sharding.send_recv``) to or from a neighbour;
- :class:`LoopbackPipe`, for one card and the tests: one process holds
  all ``S`` stages, and a hand-off passes the very tensor on (nothing is
  copied), so one process runs the whole schedule stage after stage.

With ``S`` stages and ``M`` microbatches the GPipe bubble, the share of
a stage's ticks spent waiting, is ``(S - 1) / (M + S - 1)``
(:func:`bubble`).
"""

from __future__ import annotations

import collections
import typing as tp
import warnings

import torch

from midgpt_tpu_torch.parallel import sharding

StageFn = tp.Callable[[int, torch.Tensor, int], torch.Tensor]
"""``(stage, input, microbatch) -> output``: one stage's layers on one
microbatch. A stage before the last returns its output in the boundary
dtype, the shape the next stage receives; the last stage returns what
:func:`pipeline_run` banks (a training step: the microbatch's scalar
loss)."""


def stage_layers(n_layer: int, size: int, index: int) -> range:
    """The global indices of the layers stage ``index`` of ``size`` holds:
    ``[index L / size, (index + 1) L / size)``. ``ValueError`` naming
    both numbers where ``size`` does not divide ``n_layer`` (JAX
    asserts)."""
    if size < 1 or not 0 <= index < size:
        raise ValueError(f"stage {index} of {size}")
    if n_layer % size:
        raise ValueError(f"n_layer={n_layer} is not divisible by "
                         f"pipeline={size} stages")
    per = n_layer // size
    return range(index * per, (index + 1) * per)


def microbatches(rows: int, size: int, n_micro: int = 0) -> int:
    """Microbatches ``M`` of a stage's ``rows`` (a data rank's rows of
    one microstep). ``n_micro`` (``MeshConfig.pp_microbatches``) must
    divide them; 0 takes JAX's auto rule: ``min(2 S, rows)``, lowered
    until it divides them, with a warning when it falls below ``S``."""
    if n_micro:
        if n_micro < 1 or rows % n_micro:
            raise ValueError(f"pp_microbatches={n_micro} does not divide "
                             f"the {rows} rows of a microstep")
        return n_micro
    m = min(2 * size, rows)
    while rows % m:
        m -= 1
    if m < size:
        warnings.warn(
            f"pipeline auto-microbatching degraded to {m} microbatches for "
            f"{rows} rows over {size} stages (bubble "
            f"{bubble(size, m):.0%}); pick rows divisible by 2*pipeline or "
            f"set MeshConfig.pp_microbatches", stacklevel=2)
    return m


def bubble(size: int, n_micro: int) -> float:
    """GPipe's idle share of a stage: ``(S - 1) / (M + S - 1)``."""
    return (size - 1) / (n_micro + size - 1)


class PipeExchange:
    """The interface: ``size`` (S) and ``held`` (the stages this process
    runs, ascending); :meth:`send` hands a tensor from stage ``src`` to a
    neighbour ``dst``, :meth:`recv` takes the one ``src`` handed to
    ``dst``, in the order they were sent."""

    size: int = 1
    held: tp.Tuple[int, ...] = (0,)

    def send(self, x: torch.Tensor, src: int, dst: int) -> None:
        raise NotImplementedError

    def recv(self, dst: int, src: int, shape: tp.Sequence[int],
             dtype: torch.dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def __deepcopy__(self, memo):
        # a handle on the axis, shared by a model and its copies (the
        # trainer's compute-dtype shadow)
        return self


class GroupPipe(PipeExchange):
    """This rank of a ``pipeline`` process group: ``ranks`` are the
    group's global ranks by stage, ``index`` this rank's stage."""

    def __init__(self, group, index: int, size: int,
                 ranks: tp.Sequence[int]):
        if len(ranks) != size or not 0 <= index < size:
            raise ValueError(f"stage {index} of {size} ranks {list(ranks)}")
        self.group, self.size, self.ranks = group, size, tuple(ranks)
        self.held = (index,)

    @staticmethod
    def from_mesh(mesh) -> "GroupPipe":
        """The exchange of ``mesh``'s pipeline axis (a distributed mesh)."""
        return GroupPipe(mesh.pipeline_group, mesh.pp_index, mesh.pp_size,
                         mesh.pp_ranks)

    def send(self, x, src, dst):
        sharding.send_recv(None, x.contiguous(), self.ranks[dst], None,
                           self.group)

    def recv(self, dst, src, shape, dtype, device):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        sharding.send_recv(out, None, None, self.ranks[src], self.group)
        return out


class LoopbackPipe(PipeExchange):
    """All ``size`` stages in one process: a hand-off queues the tensor
    itself for its receiver."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self.held = tuple(range(size))
        self._boxes: tp.Dict[tp.Tuple[int, int], tp.Deque] = (
            collections.defaultdict(collections.deque))

    def send(self, x, src, dst):
        self._boxes[src, dst].append(x)

    def recv(self, dst, src, shape, dtype, device):
        x = self._boxes[src, dst].popleft()
        if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
            raise ValueError(f"stage {dst} expected {tuple(shape)} {dtype} "
                             f"from {src}, got {tuple(x.shape)} {x.dtype}")
        return x


def pipeline_run(ex: PipeExchange, n_micro: int, stage_fn: StageFn,
                 first_input: tp.Callable[[int], torch.Tensor],
                 shape: tp.Sequence[int], boundary_dtype: torch.dtype,
                 device, train: bool = True) -> tp.List[torch.Tensor]:
    """The GPipe schedule of the stages ``ex.held`` over ``n_micro``
    microbatches: stage 0's microbatch ``m`` is ``first_input(m)``, a
    hand-off is a ``shape`` tensor in ``boundary_dtype``. With ``train``
    the backward runs too (each microbatch's last-stage output seeds it:
    a scalar loss), and the parameters' ``.grad`` accumulate; without,
    everything runs without gradients. Returns the last stage's outputs,
    by microbatch (detached; empty where this process does not hold the
    last stage)."""
    last = ex.size - 1
    held = ex.held
    stored: tp.Dict[int, tp.List[tp.Optional[torch.Tensor]]] = {
        s: [] for s in held if s > 0}
    outs: tp.List[torch.Tensor] = []
    for m in range(n_micro):
        for s in held:
            if s == 0:
                inp = first_input(m)
            else:
                inp = ex.recv(s, s - 1, shape, boundary_dtype, device)
                if train:
                    stored[s].append(inp)
            if s == last:
                if not train:
                    with torch.no_grad():
                        outs.append(stage_fn(s, inp, m).detach())
                continue
            with torch.no_grad():
                out = stage_fn(s, inp, m)
            ex.send(out, s, s + 1)
    if not train:
        return outs
    for m in range(n_micro):
        for s in reversed(held):
            if s == 0:
                inp = first_input(m)
            else:
                inp = stored[s][m].detach().requires_grad_(True)
                stored[s][m] = None
            with torch.enable_grad():
                out = stage_fn(s, inp, m)
            if s == last:
                outs.append(out.detach())
                out.backward()
            else:
                out.backward(ex.recv(s, s + 1, shape, boundary_dtype,
                                     device))
            if s > 0:
                ex.send(inp.grad, s, s - 1)
            del out, inp
    return outs
