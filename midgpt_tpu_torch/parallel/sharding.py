"""The shard layout of the trainer's state and its collectives
(counterpart of ``midgpt_tpu.parallel.sharding``).

JAX shards each parameter along named dims by a rule table and lets
``with_sharding_constraint`` place the collectives. The port keeps the
PyTorch idiom instead: the tensors of one dtype are laid end to end in
one flat buffer (each starting on a multiple of ``ALIGN`` elements, the
gaps and the tail zero), padded to a multiple of the ``fsdp`` size, and
rank ``i`` of an fsdp group holds the ``i``-th equal slice
(:class:`FlatShards`). The math is the same: the masters and both Adam
moments live only as this rank's ``1 / fsdp`` slice (ZeRO-3, what JAX's
``constrain_params`` on the new params and moments gives), and every
elementwise op of the update runs on the slice. The layout is internal:
checkpoints and tests see full tensors by name (:meth:`FlatShards.full`).

The collectives, each a wrapper that counts its launches as a kernel
wrapper does (``ops.launches``; a captured step records them and every
replay counts them again):

- :func:`all_gather`: the compute-dtype shadow, gathered from the shards
  (``all_gather_into_tensor`` over ``fsdp``);
- :func:`reduce_scatter`: the flat gradient, summed over ``fsdp`` and
  scattered to the shards (``reduce_scatter_tensor``);
- :func:`all_reduce`: the gradient shard over ``replica x sequence``,
  the norm's sum of squares over ``fsdp`` (``fsdp x tensor`` under a
  tensor axis), losses over the world, and under a tensor axis
  Megatron's sums (``parallel.tensor``), the QK-norms' partial gradients
  and the vocab-parallel loss's max and sums;
- :func:`send_recv`: one ring hop of sequence parallelism (a chunk to
  one rank of the ``sequence`` group, another from one), or one
  pipeline hand-off (an activation to the next stage, a gradient to the
  previous one, ``parallel.pipeline``), P2P;
- :func:`all_to_all`: Ulysses' head / sequence trade over ``sequence``.

:func:`batch_rows` is the counterpart of ``make_global_array``: the rows
of the global batch a rank holds; :func:`seq_cols` the columns of each
row it holds under a ``sequence`` axis.

The tensor axis: :func:`tensor_dim` is the port's copy of the ``tensor``
column of JAX's ``GPT_PARAM_RULES`` (``midgpt_tpu/models/gpt.py``),
by parameter name; :func:`tensor_shard` cuts a full tensor into the
shards of the tensor indices a process holds, :func:`tensor_unshard`
puts a full tensor back together from every index's shard. Every split
is into ``tensor`` contiguous equal pieces along that dimension but the
packed ``wqkv``'s: JAX cuts its packed output columns contiguously too,
which does not fall on head boundaries (it then regathers q, k and v
head-contiguously per shard), so the port gives index ``r`` the columns
``[q heads of r | k heads of r | v heads of r]`` instead, and the fused
attention runs on them as it is with ``H / tensor`` and ``Hkv /
tensor`` heads. The two functions convert between that layout and
JAX's full one, so checkpoints and the JAX bridge see full tensors.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.ops import launches
from midgpt_tpu_torch.parallel.mesh import Mesh

# every tensor starts on a multiple of this many elements of the flat
# buffer (512 bytes of f32, 256 of bf16): a view there is aligned as a
# tensor of its own is, so kernels that pick their path by alignment (the
# reductions, cuBLAS) take the same one, and a one-rank mesh step equals
# the single-card step bit for bit
ALIGN = 128


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class FlatShards:
    """The layout of tensors of ``shapes`` in one flat buffer split into
    ``n_shards`` equal slices, and slice ``index``'s view of them."""

    def __init__(self, shapes: tp.Sequence[tp.Sequence[int]], n_shards: int,
                 index: int):
        if not 0 <= index < n_shards:
            raise ValueError(f"shard {index} of {n_shards}")
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [int(torch.Size(s).numel()) for s in self.shapes]
        self.offsets = []
        off = 0
        for n in self.numels:
            self.offsets.append(off)
            off = _ceil_to(off + n, ALIGN)
        self.n_shards, self.index = n_shards, index
        self.padded = _ceil_to(max(off, 1), ALIGN * n_shards)
        self.shard_len = self.padded // n_shards
        self.lo = index * self.shard_len
        self.hi = self.lo + self.shard_len
        # (tensor, start, stop) of each piece of a tensor in this slice:
        # flat positions [start, stop) of that tensor
        self.pieces: tp.List[tp.Tuple[int, int, int]] = []
        for i, (o, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(o, self.lo), min(o + n, self.hi)
            if a < b:
                self.pieces.append((i, a - o, b - o))

    def full_views(self, flat: torch.Tensor) -> tp.List[torch.Tensor]:
        """Every tensor, shaped, as a view of the full flat buffer."""
        return [flat[o:o + n].view(s) for o, n, s in
                zip(self.offsets, self.numels, self.shapes)]

    def piece_views(self, shard: torch.Tensor) -> tp.List[torch.Tensor]:
        """This slice's pieces as views of ``shard`` (its flat slice): a
        whole tensor keeps its shape, a cut one is flat."""
        out = []
        for i, a, b in self.pieces:
            v = shard[self.offsets[i] + a - self.lo:
                      self.offsets[i] + b - self.lo]
            out.append(v.view(self.shapes[i]) if b - a == self.numels[i]
                       else v)
        return out

    def piece_of(self, tensors: tp.Sequence[torch.Tensor]
                 ) -> tp.List[torch.Tensor]:
        """The same pieces cut from full tensors (flat views)."""
        return [tensors[i].reshape(-1)[a:b] for i, a, b in self.pieces]

    @torch.no_grad()
    def fill(self, shard: torch.Tensor,
             tensors: tp.Sequence[torch.Tensor]) -> torch.Tensor:
        """``shard`` (this rank's flat slice) <- its pieces of full
        ``tensors``; the gaps keep what they hold."""
        for dst, src in zip(self.piece_views(shard), self.piece_of(tensors)):
            dst.view(-1).copy_(src)
        return shard

    def shard_from(self, tensors: tp.Sequence[torch.Tensor],
                   dtype: torch.dtype, device) -> torch.Tensor:
        """A new flat slice holding this rank's pieces of full
        ``tensors`` (zeros in the gaps)."""
        return self.fill(torch.zeros(self.shard_len, dtype=dtype,
                                     device=device), tensors)


# -- the collectives ----------------------------------------------------------


def all_gather(full: torch.Tensor, shard: torch.Tensor, group) -> None:
    """``full`` (``n * len(shard)``) <- every rank's ``shard`` of the
    group, in rank order."""
    dist.all_gather_into_tensor(full, shard, group=group)
    launches.count(all_gather)


def reduce_scatter(shard: torch.Tensor, full: torch.Tensor, group) -> None:
    """``shard`` <- this rank's slice of the sum of every rank's
    ``full`` over the group."""
    dist.reduce_scatter_tensor(shard, full, op=dist.ReduceOp.SUM,
                               group=group)
    launches.count(reduce_scatter)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> None:
    """``x`` <- the sum (``op="max"``: the largest) of every rank's ``x``
    over the group (None: the world)."""
    dist.all_reduce(x, op=_OPS[op], group=group)
    launches.count(all_reduce)


def send_recv(out: tp.Optional[torch.Tensor], x: tp.Optional[torch.Tensor],
              to: tp.Optional[int], frm: tp.Optional[int], group) -> None:
    """``x`` to global rank ``to`` and ``out`` <- what global rank ``frm``
    sends, one batch of P2P operations in ``group``; either half may be
    left out (``x`` None: receive only; ``out`` None: send only)."""
    ops = []
    if x is not None:
        ops.append(dist.P2POp(dist.isend, x, to, group))
    if out is not None:
        ops.append(dist.P2POp(dist.irecv, out, frm, group))
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    launches.count(send_recv)


def all_to_all(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out[j]`` <- rank ``j``'s ``x[i]`` over the group, ``i`` this
    rank's index (``all_to_all_single`` over dim 0)."""
    dist.all_to_all_single(out, x, group=group)
    launches.count(all_to_all)


all_gather.launches = 0
reduce_scatter.launches = 0
all_reduce.launches = 0
send_recv.launches = 0
all_to_all.launches = 0

COLLECTIVES = (all_gather, reduce_scatter, all_reduce, send_recv, all_to_all)


def collective_launches() -> tp.Dict[str, int]:
    """Each collective wrapper's ``launches``, by name."""
    return {fn.__name__: fn.launches for fn in COLLECTIVES}


# -- the global batch ---------------------------------------------------------


def local_batch_size(batch_size: int, g_accum_iters: int,
                     mesh: Mesh) -> int:
    """Rows a rank takes a microbatch: ``batch_size // (G * shards)``
    (JAX's assertion: the global batch splits evenly)."""
    n = mesh.data_shards
    assert batch_size % (g_accum_iters * n) == 0, (
        f"batch_size {batch_size} does not split into {g_accum_iters} "
        f"microbatches over {n} data shards")
    return batch_size // (g_accum_iters * n)


def seq_cols(t: int, mesh: Mesh) -> slice:
    """The columns of each row of ``t`` tokens this rank holds (JAX's
    batch spec shards T over ``sequence``: sequence index ``i`` holds the
    ``i``-th equal block)."""
    s = mesh.seq_size
    if t % s:
        raise ValueError(f"T={t} not divisible by sequence axis {s}")
    per = t // s
    return slice(mesh.seq_index * per, (mesh.seq_index + 1) * per)


def batch_rows(global_rows: int, mesh: Mesh) -> slice:
    """The rows of a global microbatch of ``global_rows`` this rank holds
    (``make_global_array``'s placement under JAX's batch spec: data
    shard ``i`` holds the ``i``-th equal block)."""
    n = mesh.data_shards
    assert global_rows % n == 0, (global_rows, n)
    per = global_rows // n
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


# -- the tensor axis: which dimension of each parameter splits ----------------

# (name suffix, dimension counted from the end): right-aligned, so one
# rule covers a block's [D, X] weight and JAX's stacked [L, D, X] leaf
_TENSOR_RULES = (
    ("wte.weight", -2),  # [V, D]: vocabulary rows
    ("attn.wqkv.weight", -1),  # [D, (H + 2 Hkv) C]: heads, packed
    ("attn.wo.weight", -2),  # [H C, D]: heads (row-parallel)
    ("mlp.w_up.weight", -1),  # [D, F]: columns
    ("mlp.w_gate.weight", -1),
    ("mlp.w_down.weight", -2),  # [F, D]: rows (row-parallel)
    ("mlp.expert_up", -3),  # [E, D, F]: experts
    ("mlp.expert_down", -3),  # [E, F, D]
    ("lm_head.weight", -1),  # [D, V]: vocabulary columns
    # an int8 projection's per-column scales (quant.QuantLinear) go with
    # a column-parallel weight's columns (JAX's ``.../scale`` rules)
    ("attn.wqkv.scale", -1),
    ("mlp.w_up.scale", -1),
    ("mlp.w_gate.scale", -1),
    ("lm_head.scale", -1),
)
# replicated on every tensor rank; the QK-norms see only a rank's heads,
# so their gradients are partial sums (TENSOR_PARTIAL)
_REPLICATED = ("attn.q_norm.weight", "attn.k_norm.weight",
               "mlp.router.weight",
               # a row-parallel int8 weight's scales stay whole: each
               # output column sums every rank's rows
               "attn.wo.scale", "mlp.w_down.scale")
TENSOR_PARTIAL = ("attn.q_norm.weight", "attn.k_norm.weight")


def _leaf(name: str) -> str:
    """A parameter name with JAX's ``/`` separators and the block index
    dropped: ``blocks.3.attn.wo.weight`` and ``blocks/attn/wo/weight``
    both give ``blocks.attn.wo.weight``."""
    parts = name.replace("/", ".").split(".")
    return ".".join(p for p in parts if not p.isdigit())


def tensor_dim(name: str) -> tp.Optional[int]:
    """The dimension (negative, from the end) of parameter ``name`` that
    splits over ``tensor``; None for a replicated one. Raises for a name
    no rule covers."""
    leaf = _leaf(name)
    for suffix, dim in _TENSOR_RULES:
        if leaf.endswith(suffix):
            return dim
    if leaf.endswith(_REPLICATED):
        return None
    raise KeyError(f"no tensor rule for parameter {name!r}")


def tensor_partial(name: str) -> bool:
    """Whether ``name``'s gradient on a tensor rank is a partial sum, to be
    summed over ``tensor`` (the QK-norms, which see only a rank's
    heads)."""
    return _leaf(name).endswith(TENSOR_PARTIAL)


# packed [q | k | v] columns: a rank's shard is its heads of each
_PACKED = ("attn.wqkv.weight", "attn.wqkv.scale")


def _qkv_widths(cfg: ModelConfig, size: int) -> tp.Tuple[int, int]:
    """Columns of one tensor index's q, and of its k (and v), in packed
    ``wqkv``."""
    c = cfg.head_dim
    return cfg.n_head // size * c, cfg.kv_heads // size * c


def tensor_shard(name: str, full: torch.Tensor, held: tp.Sequence[int],
                 size: int, cfg: ModelConfig) -> torch.Tensor:
    """The shards of tensor indices ``held`` (in that order, concatenated
    along the split dimension) of parameter ``name``'s full tensor, over
    ``size`` indices; a replicated parameter whole. One index's shard is a
    view where it can be (a packed ``wqkv`` shard is a new tensor)."""
    dim = tensor_dim(name)
    if dim is None or size == 1:
        return full
    if full.shape[dim] % size:
        raise ValueError(f"{name}: dimension {dim} of {tuple(full.shape)} "
                         f"does not split over tensor={size}")
    if _leaf(name).endswith(_PACKED):
        qw, kw = _qkv_widths(cfg, size)
        h, hkv = cfg.n_head * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        pieces = []
        for r in held:
            pieces += [full[..., r * qw:(r + 1) * qw],
                       full[..., h + r * kw:h + (r + 1) * kw],
                       full[..., h + hkv + r * kw:h + hkv + (r + 1) * kw]]
        return torch.cat(pieces, -1)
    chunks = full.chunk(size, dim)
    if len(held) == 1:
        return chunks[held[0]]
    return torch.cat([chunks[r] for r in held], dim)


def tensor_unshard(name: str, shards: tp.Sequence[torch.Tensor],
                   cfg: ModelConfig) -> torch.Tensor:
    """Parameter ``name``'s full tensor (JAX's layout) from every tensor
    index's shard, in index order; a replicated parameter is index 0's."""
    dim = tensor_dim(name)
    size = len(shards)
    if dim is None or size == 1:
        return shards[0]
    if _leaf(name).endswith(_PACKED):
        qw, kw = _qkv_widths(cfg, size)
        parts = [s.split([qw, kw, kw], -1) for s in shards]
        return torch.cat([p[i] for i in range(3) for p in parts], -1)
    return torch.cat(list(shards), dim)
