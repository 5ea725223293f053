"""How the ranks of the mesh's ``sequence`` axis trade chunks: the
exchange that ring attention's hops (``parallel.ring``) and Ulysses'
all-to-alls (``parallel.ulysses``) take from their caller.

The hop code is written over the chunks this process holds, one for
each sequence index in ``exchange.held`` (in that order), and computes
the outputs of the indices in ``exchange.active``. Two exchanges:

- :class:`GroupExchange`, the trainer's: this rank of the ``sequence``
  process group holds its own chunk. :meth:`~GroupExchange.permute` is
  one batch of P2P operations (``parallel.sharding.send_recv``) inside
  an autograd Function whose backward sends the gradient the other way,
  as JAX's ``lax.ppermute`` transposes (the zigzag relayouts take it; the
  ring's own hops run inside ``ring._Ring``, whose backward permutes its
  gradient accumulators itself); :meth:`~GroupExchange.all_to_all` is
  ``all_to_all_single`` (``parallel.sharding.all_to_all``), whose
  backward is the inverse all-to-all. Both are counted collectives.
- :class:`LoopbackExchange`, for one card and the tests: one process
  holds all ``S`` virtual ranks' chunks. A permutation hands virtual
  rank ``d`` the very tensor its source holds (nothing is copied), and
  an all-to-all splits and concatenates. Autograd then sums each
  chunk's gradient over the virtual ranks that read it, as the reverse
  ring does. ``active`` may name a subset of the virtual ranks: the
  others launch nothing and give zeros, so one virtual rank's work can
  be run, counted and timed alone.
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.parallel import sharding

Dest = tp.Callable[[int], int]


class Exchange:
    """The interface: ``size`` (S), ``held`` (the sequence indices whose
    chunks this process holds, in list order) and ``active`` (those whose
    outputs a call computes)."""

    size: int = 1
    held: tp.Tuple[int, ...] = (0,)
    active: tp.Tuple[int, ...] = (0,)

    @property
    def index(self) -> int:
        """The one sequence index this process holds."""
        if len(self.held) != 1:
            raise ValueError(f"this exchange holds {len(self.held)} "
                             f"sequence indices, not one")
        return self.held[0]

    def permute(self, xs: tp.Sequence[torch.Tensor],
                dest: Dest) -> tp.List[torch.Tensor]:
        """The held chunks after every index ``i`` sends its chunk to
        ``dest(i)`` (a bijection of ``range(size)``)."""
        raise NotImplementedError

    def all_to_all(self, xs: tp.Sequence[torch.Tensor], split_dim: int,
                   concat_dim: int) -> tp.List[torch.Tensor]:
        """Each index ``i``'s chunk split in ``size`` equal pieces along
        ``split_dim``; index ``d`` receives every index's ``d``-th piece,
        concatenated along ``concat_dim`` in index order (JAX's tiled
        ``lax.all_to_all``)."""
        raise NotImplementedError


def _source(dest: Dest, size: int, i: int) -> int:
    """The index whose chunk ``dest`` sends to ``i``."""
    for j in range(size):
        if dest(j) == i:
            return j
    raise ValueError(f"no index sends to {i}: not a permutation")


class GroupExchange(Exchange):
    """This rank of a ``sequence`` process group: ``ranks`` are the
    group's global ranks by sequence index, ``index`` this rank's."""

    def __init__(self, group, index: int, size: int,
                 ranks: tp.Sequence[int]):
        if len(ranks) != size or not 0 <= index < size:
            raise ValueError(f"index {index} of {size} ranks {list(ranks)}")
        self.group, self.size, self.ranks = group, size, tuple(ranks)
        self.held = self.active = (index,)

    @staticmethod
    def from_mesh(mesh) -> "GroupExchange":
        """The exchange of ``mesh``'s sequence axis (a distributed mesh)."""
        return GroupExchange(mesh.sequence_group, mesh.seq_index,
                             mesh.seq_size, mesh.seq_ranks)

    def _send_recv(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        sharding.send_recv(out, x, self.ranks[to], self.ranks[frm],
                           self.group)
        return out

    def _all_to_all(self, x: torch.Tensor, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
        inp = torch.stack(x.tensor_split(self.size, split_dim)).contiguous()
        out = torch.empty_like(inp)
        sharding.all_to_all(out, inp, self.group)
        return torch.cat(out.unbind(0), concat_dim)

    def permute(self, xs, dest):
        (x,) = xs
        i = self.index
        to, frm = dest(i), _source(dest, self.size, i)
        if to == i:
            return [x]
        return [_Permute.apply(x, self, to, frm)]

    def all_to_all(self, xs, split_dim, concat_dim):
        (x,) = xs
        if self.size == 1:
            return [x]
        return [_AllToAll.apply(x, self, split_dim, concat_dim)]


class _Permute(torch.autograd.Function):
    """One hop: the chunk to index ``to``, one from ``frm``; the backward
    sends the gradient to ``frm`` and receives one from ``to``."""

    @staticmethod
    def forward(ctx, x, ex, to, frm):
        ctx.ex, ctx.to, ctx.frm = ex, to, frm
        return ex._send_recv(x, to, frm)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex._send_recv(g, ctx.frm, ctx.to), None, None, None


class _AllToAll(torch.autograd.Function):
    """The all-to-all; its backward is the inverse one (split and concat
    dims swapped)."""

    @staticmethod
    def forward(ctx, x, ex, split_dim, concat_dim):
        ctx.ex, ctx.dims = ex, (split_dim, concat_dim)
        return ex._all_to_all(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.ex._all_to_all(g, concat_dim, split_dim), None, None, None


class LoopbackExchange(Exchange):
    """All ``size`` virtual ranks in one process; ``active`` (default all)
    the ones whose outputs a call computes."""

    def __init__(self, size: int,
                 active: tp.Optional[tp.Sequence[int]] = None):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self.held = tuple(range(size))
        self.active = self.held if active is None else tuple(active)
        if not set(self.active) <= set(self.held):
            raise ValueError(f"active {self.active} outside 0..{size - 1}")

    def permute(self, xs, dest):
        out: tp.List[tp.Any] = [None] * self.size
        for i, x in enumerate(xs):
            out[dest(i)] = x
        return out

    def all_to_all(self, xs, split_dim, concat_dim):
        if self.size == 1:
            return list(xs)
        pieces = [x.tensor_split(self.size, split_dim) for x in xs]
        return [torch.cat([p[d] for p in pieces], concat_dim)
                for d in range(self.size)]


def sequence_chunks(x: torch.Tensor, s: int,
                    dim: int = 2) -> tp.List[torch.Tensor]:
    """A whole-T tensor's ``s`` equal chunks along ``dim`` (views), one a
    virtual rank of a :class:`LoopbackExchange`."""
    t = x.shape[dim]
    if t % s:
        raise ValueError(f"T={t} not divisible by sequence axis {s}")
    return list(x.split(t // s, dim))
