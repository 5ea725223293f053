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

Serving (``ServingEngine(mesh=...)``, JAX's tensor-only serving mesh)
takes three more collectives, plain ones without gradients (a
loopback's caller combines its held shards itself):
:meth:`GroupTensorExchange.all_gather` (a vocabulary row, ``prefill_sp``'s
rows), :meth:`GroupTensorExchange.reduce_scatter` (``prefill_sp``'s rows
after a row-parallel product), and the greedy combiner :func:`greedy_argmax`
(each shard's ``(max, index)`` of its vocabulary columns, one pair a
rank crossing the group, never the row). A module's activations that a
collective splits by rows are a list, one entry a held index
(:func:`held_rows`, :func:`gather_rows`, :func:`scatter_rows`). The
serving state split by KV heads (a pool, its scale planes, recent rows,
a ring cache) is a tuple, one entry a held index, where the single-card
path keeps one tensor: :func:`as_shards` and :func:`shardwise` are the
one place that tells the two apart.
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

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` end to end along ``dim``, in rank order; no
        gradient."""
        x = x.detach().contiguous()
        out = x.new_empty((self.size,) + tuple(x.shape))
        sharding.all_gather(out.view(-1), x.view(-1), self.group)
        return torch.cat(out.unbind(0), dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``1 / size`` slice along ``dim`` of every rank's
        ``x`` summed; no gradient."""
        xt = x.detach().movedim(dim, 0).contiguous()
        if xt.shape[0] % self.size:
            raise ValueError(f"{xt.shape[0]} rows do not split over tensor="
                             f"{self.size}")
        out = xt.new_empty((xt.shape[0] // self.size,) + tuple(xt.shape[1:]))
        sharding.reduce_scatter(out, xt, self.group)
        return out.movedim(0, dim)


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


def held_rows(x: torch.Tensor, ex: TensorExchange, dim: int = 1
              ) -> tp.List[torch.Tensor]:
    """The held indices' ``1 / size`` slices of replicated ``x`` along
    ``dim`` (a sequence-parallel segment's rows: held index ``j`` keeps
    the ``held[j]``-th equal block), one a held index."""
    if x.shape[dim] % ex.size:
        raise ValueError(f"{x.shape[dim]} rows do not split over tensor="
                         f"{ex.size}")
    blocks = x.chunk(ex.size, dim)
    return [blocks[r] for r in ex.held]


def gather_rows(rows: tp.Sequence[torch.Tensor], ex: TensorExchange,
                dim: int = 1) -> torch.Tensor:
    """The whole of a row-split activation, replicated: the held blocks
    end to end, then every rank's (an all-gather over a grouped
    exchange)."""
    x = rows[0] if len(rows) == 1 else torch.cat(list(rows), dim)
    return ex.all_gather(x, dim) if ex.grouped else x


def scatter_rows(parts: tp.Sequence[torch.Tensor], ex: TensorExchange,
                 dim: int = 1) -> tp.List[torch.Tensor]:
    """The held row blocks of the sum of the shards' partial results: the
    held partials summed in index order (as :func:`reduce_from_tensor`),
    then reduce-scattered over a grouped exchange, so that each rank
    keeps its block of the all-reduce's result."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if ex.grouped:
        return [ex.reduce_scatter(total, dim)]
    return held_rows(total, ex, dim)


def greedy_argmax(logits: torch.Tensor,
                  ex: tp.Optional[TensorExchange]) -> torch.Tensor:
    """The argmax over the vocabulary (int64, the lowest index on ties, as
    ``torch.argmax`` of the whole row) of ``logits [..., V']`` holding
    ``ex.held``'s vocabulary shards end to end (the whole row without a
    tensor axis). Each shard gives its ``(max, first index)``; the pairs,
    one a rank over a grouped exchange (an all-gather of ``[2, ...]``
    f32: V < 2^24, so an index is exact), combine to the largest value
    and, among the shards that reach it, the lowest global index. A
    combiner that kept the first rank's maximum would differ exactly at
    a tie across a shard boundary."""
    if ex is None:
        return torch.argmax(logits, dim=-1)
    vl = logits.shape[-1] // len(ex.held)
    vals, idxs = [], []
    for j, r in enumerate(ex.held):
        part = logits[..., j * vl:(j + 1) * vl]
        i = torch.argmax(part, dim=-1, keepdim=True)
        vals.append(part.gather(-1, i)[..., 0].float())
        idxs.append((i[..., 0] + r * vl).float())
    pairs = torch.stack([torch.stack(vals), torch.stack(idxs)], 1)
    if ex.grouped:  # [n, 2, ...] -> every rank's pairs
        pairs = ex.all_gather(pairs, 0)
    vals, idxs = pairs[:, 0], pairs[:, 1]
    best = vals.max(0).values
    cand = torch.where(vals == best, idxs, torch.full_like(idxs, 2.0 ** 24))
    return cand.min(0).values.long()


def gather_vocab(logits: torch.Tensor,
                 ex: tp.Optional[TensorExchange]) -> torch.Tensor:
    """The whole vocabulary row of ``logits`` holding ``ex.held``'s shards
    (an all-gather over a grouped exchange; a loopback holding every
    index has the row already)."""
    if ex is None or not ex.grouped:
        return logits
    return ex.all_gather(logits, -1)


def held_columns(row: torch.Tensor,
                 ex: tp.Optional[TensorExchange]) -> torch.Tensor:
    """The ``ex.held`` shards' columns of a whole vocabulary row (the
    inverse of :func:`gather_vocab`)."""
    if ex is None or len(ex.held) == ex.size:
        return row
    blocks = row.chunk(ex.size, -1)
    return torch.cat([blocks[r] for r in ex.held], -1)


def as_shards(x) -> tuple:
    """The per-shard entries of serving state: a tuple over the held
    tensor shards as it is, a tensor (no tensor axis) as the one shard."""
    return x if isinstance(x, tuple) else (x,)


def shardwise(fn: tp.Callable, *xs):
    """``fn`` on each shard's entries of ``xs`` (:func:`as_shards`), the
    results in ``xs[0]``'s form: a tuple over the shards, or the one
    result without a tensor axis."""
    out = tuple(fn(*a) for a in zip(*map(as_shards, xs)))
    return out if isinstance(xs[0], tuple) else out[0]
