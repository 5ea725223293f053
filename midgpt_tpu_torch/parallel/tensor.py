"""How the ranks of the mesh's ``tensor`` axis combine their shards:
Megatron's two operators over an exchange the caller gives (JAX has no
counterpart: GSPMD inserts these collectives from the sharding rules).

- :func:`copy_to_tensor` (Megatron's ``f``): the identity in the
  forward, the gradient summed over the tensor ranks in the backward. It
  goes where a replicated activation enters a sharded computation (the
  input of a column-parallel projection, of the experts' dispatch, the
  router's gates entering the combine, the lm head's input).
- :func:`reduce_from_tensor` (Megatron's ``g``): the partial results
  summed over the tensor ranks in the forward, the identity in the
  backward. It goes after every row-parallel product (``wo``, ``w_down``,
  the experts' combine, the vocab-parallel embedding).

A module under the tensor axis holds the shards of the tensor indices in
``exchange.held`` (concatenated along each parameter's split dimension,
``parallel.sharding.tensor_shard``) and computes, shard by shard, the
partial results of the indices in ``exchange.active``. Two exchanges, as
for the sequence axis (``parallel.exchange``):

- :class:`GroupTensorExchange`, the trainer's: this rank of the
  ``tensor`` process group holds its own shard, and each operator's sum
  is an all-reduce over the group (``parallel.sharding.all_reduce``, a
  counted collective; captured in the step's CUDA graph on the card);
- :class:`LoopbackTensorExchange`, for one card and the tests: one
  process holds all ``size`` virtual ranks' shards, so ``g`` is the sum
  of the held partials and ``f`` the identity (autograd sums the
  gradient of a tensor every shard reads). ``active`` may name a subset:
  the others launch nothing, so one virtual rank's work can be run,
  counted and timed alone.

:meth:`TensorExchange.all_reduce` is the plain collective the
vocab-parallel loss takes its max and sums with (the loopback's is the
identity: its caller has already combined the held shards).
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.parallel import sharding


class TensorExchange:
    """The interface: ``size`` (the tensor axis), ``held`` (the tensor
    indices whose shards this process holds, in list order) and
    ``active`` (those whose partial results a call computes)."""

    size: int = 1
    held: tp.Tuple[int, ...] = (0,)
    active: tp.Tuple[int, ...] = (0,)
    grouped = False  # whether the sums cross processes

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Every rank's ``x`` summed (``op="max"``: the largest), out of
        place; no gradient."""
        return x

    def shards(self) -> tp.List[tp.Tuple[int, int]]:
        """``(j, r)`` for each active tensor index ``r`` and its position
        ``j`` among the held shards."""
        return [(j, r) for j, r in enumerate(self.held) if r in self.active]

    def __deepcopy__(self, memo):
        # a handle on the axis, shared by a model and its copies (the
        # trainer's compute-dtype shadow)
        return self


class GroupTensorExchange(TensorExchange):
    """This rank of a ``tensor`` process group, tensor index ``index`` of
    ``size``."""

    grouped = True

    def __init__(self, group, index: int, size: int):
        if not 0 <= index < size:
            raise ValueError(f"tensor index {index} of {size}")
        self.group, self.size = group, size
        self.held = self.active = (index,)

    @staticmethod
    def from_mesh(mesh) -> "TensorExchange":
        """The exchange of ``mesh``'s tensor axis (a distributed mesh)."""
        return GroupTensorExchange(mesh.tensor_group, mesh.tp_index,
                                   mesh.tp_size)

    def all_reduce(self, x, op="sum"):
        out = x.detach().clone()
        sharding.all_reduce(out, self.group, op)
        return out


class LoopbackTensorExchange(TensorExchange):
    """All ``size`` virtual tensor ranks in one process; ``active``
    (default all) the ones whose partial results a call computes."""

    def __init__(self, size: int,
                 active: tp.Optional[tp.Sequence[int]] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self.held = tuple(range(size))
        self.active = self.held if active is None else tuple(active)
        if not self.active or not set(self.active) <= set(self.held):
            raise ValueError(f"active {self.active} not a non-empty subset "
                             f"of 0..{size - 1}")


class _Copy(torch.autograd.Function):
    """``f``: the identity; the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.all_reduce(g.contiguous()), None


class _Reduce(torch.autograd.Function):
    """``g``: the all-reduce; the backward passes the gradient on."""

    @staticmethod
    def forward(ctx, x, ex):
        return ex.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor,
                   ex: tp.Optional[TensorExchange]) -> torch.Tensor:
    """Megatron's ``f`` on a replicated activation entering a sharded
    computation (the identity without a grouped exchange)."""
    if ex is None or not ex.grouped:
        return x
    return _Copy.apply(x, ex)


def reduce_from_tensor(parts: tp.Sequence[torch.Tensor],
                       ex: tp.Optional[TensorExchange]) -> torch.Tensor:
    """Megatron's ``g``: the active shards' partial results summed (in
    index order), then over the tensor ranks."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if ex is None or not ex.grouped:
        return total
    return _Reduce.apply(total, ex)


def held_shard(w: torch.Tensor, j: int, ex: tp.Optional[TensorExchange],
               dim: int) -> torch.Tensor:
    """The ``j``-th held shard of a weight holding ``len(ex.held)`` shards
    end to end along ``dim`` (the weight itself for one)."""
    n = 1 if ex is None else len(ex.held)
    return w if n == 1 else w.chunk(n, dim)[j]
