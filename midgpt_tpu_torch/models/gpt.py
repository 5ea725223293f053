"""Decoder-only transformer (counterpart of ``midgpt_tpu.models.gpt``):
the training forward and the serving paths.

The block structure and arithmetic follow the JAX package: weightless
RMSNorm pre-norms, a packed QKV projection of width ``(H + 2 Hkv) C``
(GQA falls out of the same code), per-head QK-LayerNorm applied before
interleaved RoPE, GELU (tanh approximation, as ``jax.nn.gelu``) or
SwiGLU MLPs or a Switch mixture of GELU experts (:class:`MoEMLP`), a
final RMSNorm with eps 1e-5, and an untied head that shares the
embedding's init. An MoE layer's capacity depends on the T of its call,
so every path calls the MLP at the JAX package's shapes: decode
``[S, 1, D]``, verify ``[S, T, D]``, a prefill chunk ``[1, bucket, D]``
(pad rows route and count in T, after the real ones), training
``[B, T, D]``.

Two attention choreographies, deliberately different and never mixed:

- decode (:meth:`Attention.decode_paged_at`, and the speculative verify
  :meth:`Attention.verify_paged_at`, through ``ops.paged_attn``; the
  fixed-batch sampler's ring steps :meth:`Attention.decode_at` and
  :meth:`Attention.decode_recent_at`): f32 upcast multiply-sums, mask
  added, then a DIVISION by sqrt(C), f32 probabilities through the value
  sums, one cast to the compute dtype at the end. Verify must mirror
  decode: acceptance compares its argmaxes with what the decode window
  would have drawn;
- prefill (:meth:`Attention.prefill_paged_at`, a chunk over the slot's
  resident pages and itself; the sampler's :func:`prefill`, through
  :meth:`GPT.hidden` with ``return_kv``): compute-dtype operands with f32
  accumulation, mask added, then a MULTIPLICATION by ``1/sqrt(C)``,
  probabilities cast to the value dtype before PV.

The fixed-batch sampler's ring cache (:class:`KVCache`, ``[L, B, Hkv, C,
W]``, time minor) is written in place: :func:`prefill` fills its first
``P`` slots, :func:`decode_step` writes slot ``pos % W`` (the oracle),
and the chunked path writes recent rows ``[L, B, Hkv, R, C]``
(:func:`decode_step_recent`) that :func:`merge_recent` folds in. The
ring steps project through :meth:`Attention._qkv` at ``T = 1`` (the JAX
package's ``_decode_qkv``).

The training forward (:meth:`GPT.hidden`, :meth:`GPT.forward`) routes
each layer's attention as the JAX package does (:meth:`Attention.
_use_fused`): the fused QK-LN + RoPE + attention of ``ops.fused_attn``
(hand-written CUDA kernels on the card) when no attention dropout is
drawn, else ``ops.attention``'s dispatch: the flash kernels of
``ops.flash`` on the card, the naive oracle on the CPU; ``"ring"`` and
``"ulysses"`` take ``parallel.ring`` / ``parallel.ulysses`` over the
exchange of the mesh's sequence axis (:meth:`GPT.set_batch_offset`),
every hop through the flash kernels; without one each is one flash call.
Under a sequence axis above 1 a
forward sees its rank's column slice of every row: ``"auto"`` takes
ring, and flash, naive and fused raise (:func:`sequence_impl`). Dropout sits
where the JAX model has it: the embeddings, the attention probabilities
(the kernels' counter-hash mask), the attention output after ``wo`` and
the MLP output. It is drawn only with ``deterministic=False`` and a key;
every mask is a counter hash of a per-(layer, site) key derived from it
(``layers.dropout_site_keys``: the attention mask the flash kernels' hash
of its seed, the others ``ops.dropout``'s), read from a row of site keys
on the device, so ``remat="full"``, which
checkpoints each block, and ``remat="dots"``, which checkpoints each
block but keeps its projections (:func:`dots_contexts`), redraw the same
masks.

Layers run unrolled (a Python loop over ``GPT.blocks``); the pool is
read-only inside a decode window, and K/V rows land in pages through
``serving.paged`` at window and prefill boundaries. The serving paths
run without gradients.

Int8 serving (``midgpt_tpu_torch.quant``): the projections may be
``QuantLinear`` s (the model calls them, never reads their weights), and
an int8 pool comes with its scale planes ``pool_sk``/``pool_sv``
``[L, NP, Hkv]``. Every K/V row is then rounded through its page's grid
(``serving.paged.kv_row_scales``) before anything reads it: this step's
decode row before the recent buffer sees it, the verify rows and the
prompt rows before their self-attention, so in-dispatch reads and later
pool reads of a position see one value.

Serving under a tensor axis (``self.tensor`` set by
:meth:`GPT.shard_tensor_`, the engine's ``mesh=``): every serving path
runs each held shard's ``H / tp`` and ``Hkv / tp`` heads
(:meth:`Attention._shardwise`) over that shard's pool, scale planes,
recent rows or ring cache, passed as tuples over the held shards, and
returns its K/V the same way; the head is vocabulary-parallel
(:meth:`GPT.project` gives the held shards' logit columns).
"""

from __future__ import annotations

import functools
import math
import typing as tp
import weakref

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.layers import (
    Embedding,
    LayerNorm,
    Linear,
    RMSNorm,
    apply_rotary,
    dropout,
    key_row,
    rope_tables,
    site_row,
)
from midgpt_tpu_torch.ops.attention import attention
from midgpt_tpu_torch.ops.fused_attn import (
    fused_attention_qkv,
    rope_full_tables,
    supported,
)
from midgpt_tpu_torch.ops.paged_attn import (
    gathered_pool_view,
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from midgpt_tpu_torch.parallel.exchange import Exchange
from midgpt_tpu_torch.parallel.pipeline import (
    PipeExchange,
    pipeline_run,
    stage_layers,
)
from midgpt_tpu_torch.parallel.ring import ring_attention
from midgpt_tpu_torch.parallel.sharding import tensor_dim, tensor_shard
from midgpt_tpu_torch.parallel.tensor import (
    TensorExchange,
    as_shards,
    copy_to_tensor,
    gather_rows,
    held_rows,
    held_shard,
    reduce_from_tensor,
    scatter_rows,
    shardwise,
)
from midgpt_tpu_torch.parallel.ulysses import ulysses_attention
from midgpt_tpu_torch.quant import (
    QuantLinear,
    round_kv_rows_to_grid,
    shard_quant_linear,
)
from midgpt_tpu_torch.utils.platform import device_scalar, resolve_device

# remat="dots": the products a block keeps, the JAX package's
# dots_with_no_batch_dims_saveable. A projection of [B, T, D] rows reaches
# aten as one mm; bmm (attention's naive scores, the MoE experts) has a
# batch dimension and is recomputed, as is every op between the products
# and every hand-written kernel (a ctypes launch is no aten op).
_KEPT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _KEPT_PRODUCTS:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def dots_contexts():
    """The selective-checkpoint contexts of ``remat="dots"``: a fresh pair
    for each checkpointed call."""
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(
        _dots_policy)


def _round_rows(k, v, base, bt, pool_sk, pool_sv, layer, ps):
    """``k``/``v`` ``[S, Hkv, T, C]`` (positions ``base + j``) rounded
    through their pages' int8 grids, in their own dtype."""
    from midgpt_tpu_torch.serving.paged import kv_row_scales

    sk, sv = kv_row_scales(k, v, base, bt, pool_sk[layer], pool_sv[layer], ps)
    return round_kv_rows_to_grid(k, sk), round_kv_rows_to_grid(v, sv)


def _gathered_pool_scales(pool_s, bt, layer):
    """The int8 pool's scales per slot and table entry, ``[S, Pmax, Hkv]``
    (pads clipped, as the gather clips them), for the kernels."""
    if pool_s is None:
        return None
    return pool_s[layer][bt.long().clamp(0, pool_s.shape[1] - 1)]


def held_proj(lin: tp.Union[Linear, QuantLinear], j: int,
              ex: TensorExchange, dim: int) -> tp.Callable:
    """The product ``x -> x @ W`` of held tensor shard ``j`` of projection
    ``lin`` (split along ``dim``: -1 column-parallel, -2 row-parallel; an
    int8 ``QuantLinear``'s through its kernel at the shard's shape)."""
    if isinstance(lin, QuantLinear):
        return lin.held(j, len(ex.held), dim)
    return functools.partial(torch.matmul,
                             other=held_shard(lin.weight, j, ex, dim))


def _at(x, j: int):
    """Shard ``j``'s entry of serving state (``parallel.tensor.
    as_shards``: a per-shard tuple, or a tensor as shard 0), or None."""
    return None if x is None else as_shards(x)[j]


def stack_layers(xs: tp.Sequence):
    """Per-layer K or V stacked ``[L, ...]``, shard by shard (each
    layer's a tuple over the held shards under a tensor axis)."""
    return shardwise(lambda *layers: torch.stack(layers), *xs)


def _ring_decode_attention(
    q: torch.Tensor,  # [B, H, 1, C]
    ck: torch.Tensor,  # [B, Hkv, C, W] one layer's ring cache
    cv: torch.Tensor,
    mask: torch.Tensor,  # [W] additive f32
    rk: tp.Optional[torch.Tensor] = None,  # [B, Hkv, R, C] recent rows
    rv: tp.Optional[torch.Tensor] = None,
    mask_rec: tp.Optional[torch.Tensor] = None,  # [R] additive f32
) -> torch.Tensor:
    """One query row per sequence over the ring cache (and the recent
    rows, one joint softmax), in the JAX ``decode_at`` choreography: q and
    the cache raised to f32, the mask added, then a DIVISION by sqrt(C),
    f32 probabilities through the value sums. Returns ``[B, H, 1, C]``
    f32 heads in q's order (the caller casts to the activation dtype)."""
    b, h, _, c = q.shape
    hkv = ck.shape[1]
    f32 = torch.float32
    qg = q.reshape(b, hkv, h // hkv, 1, c).to(f32)
    s = qg @ ck[:, :, None].to(f32) + mask  # [B, Hkv, G, 1, W]
    w = s.shape[-1]
    if rk is not None:
        s_rec = qg @ rk[:, :, None].to(f32).transpose(-1, -2)
        s = torch.cat([s, s_rec + mask_rec], dim=-1)
    probs = torch.softmax(s / math.sqrt(c), dim=-1)
    out = probs[..., :w] @ cv[:, :, None].to(f32).transpose(-1, -2)
    if rk is not None:
        out = out + probs[..., w:] @ rv[:, :, None].to(f32)
    return out.reshape(b, h, 1, c)


def seq_shard(sequence: tp.Optional[Exchange]) -> tp.Tuple[int, int]:
    """``(index, size)`` of a rank's column slice of every row: ``(0, 1)``
    without a sequence axis."""
    return (0, 1) if sequence is None else (sequence.index, sequence.size)


def check_moe_sequence(cfg: ModelConfig, s: int) -> None:
    """A Switch MoE's capacity is per global row, so its routing needs a
    prefix over the sequence shards, not ported: an MoE model under ``s >
    1`` sequence ranks raises ``NotImplementedError``."""
    if s > 1 and cfg.mlp == "moe":
        raise NotImplementedError(
            "mlp='moe' with sequence > 1 is not ported: an MoE layer's "
            "capacity is per global row, so its routing needs a prefix over "
            "the sequence shards (ROADMAP Q9: MoE x sequence)")


def sequence_impl(impl: str, s: int) -> str:
    """The attention of a forward whose rows are split over ``s``
    sequence ranks: ``"auto"`` takes ring; ring and Ulysses are kept;
    flash, naive and fused raise (each would need the whole T, which the
    port never gathers). At ``s = 1`` ring and Ulysses are one flash call
    and the rest are unchanged."""
    if s == 1:
        return "flash" if impl in ("ring", "ulysses") else impl
    if impl in ("ring", "ulysses"):
        return impl
    if impl == "auto":
        return "ring"
    raise ValueError(
        f"attn_impl={impl!r} cannot run with T split over sequence={s}: "
        f"use attn_impl='ring' or 'ulysses' (or 'auto', which takes ring)")


class Attention(nn.Module):
    """Causal self-attention with QK-norm + RoPE."""

    # global index of the first batch row, and the sequence axis's
    # exchange (GPT.set_batch_offset)
    batch_offset = 0
    sequence: tp.Optional[Exchange] = None
    # "zigzag" | "standard" (GPT sets its config's)
    ring_schedule = "zigzag"
    # the tensor axis's exchange (GPT.shard_tensor_); None: no tensor axis
    tensor: tp.Optional[TensorExchange] = None

    def __init__(self, wqkv: Linear, wo: Linear,
                 q_norm: tp.Optional[LayerNorm],
                 k_norm: tp.Optional[LayerNorm], n_head: int,
                 n_kv_head: int, dropout_rate: float = 0.0):
        super().__init__()
        self.wqkv, self.wo = wqkv, wo
        self.q_norm, self.k_norm = q_norm, k_norm
        self.n_head, self.n_kv_head = n_head, n_kv_head
        self.dropout_rate = dropout_rate

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "Attention":
        c, hkv = cfg.head_dim, cfg.kv_heads
        return Attention(
            wqkv=Linear.init(cfg.n_embd, (cfg.n_head + 2 * hkv) * c, generator),
            wo=Linear.init(cfg.n_head * c, cfg.n_embd, generator),
            q_norm=LayerNorm(c, eps=1e-6) if cfg.qk_norm else None,
            k_norm=LayerNorm(c, eps=1e-6) if cfg.qk_norm else None,
            n_head=cfg.n_head,
            n_kv_head=hkv,
            dropout_rate=cfg.dropout,
        )

    def _qkv(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
             proj: tp.Optional[tp.Callable] = None,
             h: tp.Optional[int] = None, hkv: tp.Optional[int] = None):
        """Project ``x [B, T, D]`` to q ``[B, H, T, C]`` and k/v
        ``[B, Hkv, T, C]``: QK-norm first, then RoPE at ``sin``/``cos``
        (broadcastable to ``[B, 1, T, C//2]``). ``proj``, ``h``, ``hkv``:
        one tensor shard's packed product (:func:`held_proj`) and head
        counts (default the whole projection's)."""
        b, t, d = x.shape
        c = d // self.n_head
        h = self.n_head if h is None else h
        hkv = self.n_kv_head if hkv is None else hkv
        qkv = (self.wqkv if proj is None else proj)(x)
        q = qkv[..., : h * c].reshape(b, t, h, c)
        k = qkv[..., h * c : (h + hkv) * c].reshape(b, t, hkv, c)
        v = qkv[..., (h + hkv) * c :].reshape(b, t, hkv, c)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        return apply_rotary(q, sin, cos), apply_rotary(k, sin, cos), v

    @property
    def head_dim(self) -> int:
        ex = self.tensor
        if ex is None:
            return self.wo.weight.shape[0] // self.n_head
        # wo holds the rows of len(held) of size shards
        return (self.wo.weight.shape[0] * ex.size
                // (len(ex.held) * self.n_head))

    def forward(self, x: torch.Tensor, rope: RopeTables,
                impl: str = "naive",
                key: tp.Optional[torch.Tensor] = None,
                return_kv: bool = False):
        """Causal self-attention over whole sequences ``x [B, T, D]``
        with the rope tables of ``T`` positions; with ``key`` (the
        probabilities' and the output's site keys, int64 ``[2]`` on the
        device), dropout on the probabilities and the output. With
        ``return_kv``, ``(out, (k, v))``: the post-QK-norm, post-RoPE K
        and the raw V, ``[B, Hkv, T, C]``, which the ring cache stores
        (the prefill).

        Under a tensor axis (``self.tensor``) the projection is
        column-parallel and ``wo`` row-parallel: each held shard runs
        its ``H / tp`` and ``Hkv / tp`` heads (its attention dropout
        keyed by their global head indices) and the shards' ``wo``
        products are summed (``parallel.tensor``); with ``return_kv``
        k and v are tuples of the held shards' ``[B, Hkv / tp, T, C]``."""
        adrop_key, pdrop_key = (None, None) if key is None else key.unbind()
        seq = seq_shard(self.sequence)
        impl = sequence_impl(impl, seq[1])
        if impl == "fused" and (return_kv or self.q_norm is None):
            # the kernel yields no per-head K/V and needs QK-norm; same
            # math either way
            impl = "auto"
        drops = key is not None and self.dropout_rate > 0.0
        ex = self.tensor
        if ex is None:
            out = self._heads(x, rope, impl, drops, adrop_key, return_kv)
            if return_kv:
                out, (k, v) = out
        else:
            if impl == "ulysses" and ex.size > 1:
                raise ValueError("attn_impl='ulysses' cannot run under a "
                                 "tensor axis (JAX asserts tensor == 1)")
            x = copy_to_tensor(x, ex)
            h, hkv = self.n_head // ex.size, self.n_kv_head // ex.size
            parts = [self._heads(
                x, rope, impl, drops, adrop_key, return_kv,
                held_proj(self.wqkv, j, ex, -1),
                held_proj(self.wo, j, ex, -2), h, hkv, r * h)
                for j, r in ex.shards()]
            if return_kv:
                parts, kvs = zip(*parts)
                k = tuple(kv[0] for kv in kvs)
                v = tuple(kv[1] for kv in kvs)
            out = reduce_from_tensor(parts, ex)
        out = dropout(out, self.dropout_rate, pdrop_key, self.batch_offset,
                      seq)
        return (out, (k, v)) if return_kv else out

    def _heads(self, x, rope, impl: str, drops: bool, seed,
               return_kv: bool, w_qkv=None, w_o=None, h=None, hkv=None,
               head0: int = 0):
        """The attention of heads ``head0 .. head0 + h`` (default every
        head, through the modules) through ``wo`` (a shard's products
        ``w_qkv``/``w_o``, :func:`held_proj`, under a tensor axis: its
        partial output)."""
        b, t, _ = x.shape
        h = self.n_head if h is None else h
        hkv = self.n_kv_head if hkv is None else hkv
        if not return_kv and self._use_fused(impl, t, x.device, drops, h,
                                             hkv):
            return self._fused_call(x, rope, w_qkv, w_o, h, hkv)
        q, k, v = self._qkv(x, rope.sin, rope.cos, w_qkv, h, hkv)
        if impl in ("ring", "ulysses"):
            out = self._sequence_call(q, k, v, impl, drops, seed, head0)
        else:
            out = attention(
                q, k, v, impl=impl, dropout_rate=self.dropout_rate,
                seed=seed, batch_offset=self.batch_offset,
                head_offset=head0, n_head_total=self.n_head)
        out = out.transpose(1, 2).reshape(b, t, -1)
        out = (self.wo if w_o is None else w_o)(out)
        return (out, (k, v)) if return_kv else out

    def _sequence_call(self, q, k, v, impl: str, drops: bool,
                       seed: tp.Optional[torch.Tensor],
                       head0: int = 0) -> torch.Tensor:
        """Ring or Ulysses attention over this rank's column slice (the
        JAX model's dispatch): zigzag falls back to standard when T does
        not divide 2S or attention dropout is drawn. ``head0``: the global
        index of q's first head (a tensor shard's)."""
        ex = self.sequence
        rate = self.dropout_rate if drops else 0.0
        if impl == "ulysses":
            return ulysses_attention(q, k, v, ex, dropout_rate=rate,
                                     dropout_seed=seed, b_off=self.batch_offset)
        schedule = self.ring_schedule
        if schedule == "zigzag" and (q.shape[2] % 2 or drops):
            schedule = "standard"
        return ring_attention(q, k, v, ex, schedule=schedule,
                              dropout_rate=rate, dropout_seed=seed,
                              bh_off=self.batch_offset * self.n_head + head0,
                              n_head_total=self.n_head)

    def _use_fused(self, impl: str, t: int, device: torch.device,
                   drops: bool = False, h: tp.Optional[int] = None,
                   hkv: tp.Optional[int] = None) -> bool:
        """Route to the fused kernels (``ops.fused_attn``). ``"fused"``
        forces them (the plain versions on the CPU); ``"auto"`` takes them
        for CUDA tensors, as the JAX package takes them on the TPU, when
        the shape suits them and no attention dropout is drawn
        (``drops``); otherwise ``ops.attention`` dispatches (the flash
        kernels on the card). ``h``/``hkv``: a tensor shard's head counts
        (JAX's ``tp_ok``: each shard must keep a supported head shape)."""
        if impl not in ("fused", "auto") or seq_shard(self.sequence)[1] > 1:
            # a sequence-sharded T is ring territory (JAX: sp > 1)
            return False
        h = self.n_head if h is None else h
        hkv = self.n_kv_head if hkv is None else hkv
        shape_ok = (
            self.q_norm is not None
            and supported(h, hkv, self.head_dim)
            and t >= 128 and t % 128 == 0
            and not drops
        )
        if impl == "fused":
            if not shape_ok:
                raise ValueError(
                    "attn_impl='fused' requires qk-norm, T % 128 == 0, "
                    "T >= 128, no attention dropout and a supported head "
                    "shape (C % 128 == 0, or C == 64 with MHA), per tensor "
                    "shard under a tensor axis")
            return True
        return device.type == "cuda" and shape_ok

    def _fused_call(self, x: torch.Tensor, rope: RopeTables,
                    w_qkv=None, w_o=None, h=None, hkv=None) -> torch.Tensor:
        qkv = (self.wqkv if w_qkv is None else w_qkv)(x)
        out = fused_attention_qkv(
            qkv, self.q_norm.weight, self.k_norm.weight,
            rope.sin_full, rope.cos_full,
            self.n_head if h is None else h,
            self.n_kv_head if hkv is None else hkv, self.q_norm.eps)
        return (self.wo if w_o is None else w_o)(out)

    def _shardwise(self, x: torch.Tensor, fn: tp.Callable,
                   reduce: tp.Optional[tp.Callable] = None) -> tp.Tuple:
        """A serving path's heads under the tensor axis: ``fn(j, wqkv,
        wo, h, hkv)`` returns ``(out, *rest)`` for the whole attention
        (``j`` 0, the modules, every head) or for held shard ``j``
        (its products, :func:`held_proj`, and ``H / tp``, ``Hkv / tp``
        heads); the shards' partial outputs are summed
        (:func:`~midgpt_tpu_torch.parallel.tensor.reduce_from_tensor`, or
        ``reduce(parts)``) and each of ``rest`` becomes a tuple over the
        shards. Each shard's pool, scale planes and rows are its entries
        of the per-shard tuples the caller passes (:func:`_at`)."""
        ex = self.tensor
        if ex is None:
            return fn(0, self.wqkv, self.wo, self.n_head, self.n_kv_head)
        h, hkv = self.n_head // ex.size, self.n_kv_head // ex.size
        res = [fn(j, held_proj(self.wqkv, j, ex, -1),
                  held_proj(self.wo, j, ex, -2), h, hkv)
               for j, _ in ex.shards()]
        parts = [r[0] for r in res]
        out = reduce_from_tensor(parts, ex) if reduce is None else reduce(
            parts)
        return (out,) + tuple(tuple(r[i] for r in res)
                              for i in range(1, len(res[0])))

    def decode_at(
        self,
        x: torch.Tensor,  # [B, 1, D] one new token per sequence
        cache_k: torch.Tensor,  # [L, B, Hkv, C, W] ring cache, time-minor
        cache_v: torch.Tensor,
        layer: int,
        slot: int,  # ring slot to write (pos % W)
        mask: torch.Tensor,  # [W] additive f32 over the ring slots
        sin_row: torch.Tensor,  # [1, C//2] rope row at the absolute position
        cos_row: torch.Tensor,
    ) -> torch.Tensor:
        """Single-token attention over the fixed-batch sampler's ring
        cache: this token's K/V row lands in ``slot`` (in place), then
        the token attends over every slot ``mask`` leaves open, in the
        decode choreography (:func:`_ring_decode_attention`). Keys are
        roped at absolute positions, so evicting the oldest slot is the
        reference's sliding window. Under a tensor axis the caches are
        tuples of the held shards' (:meth:`_shardwise`)."""
        b = x.shape[0]

        def heads(j, wqkv, wo, h, hkv):
            ck, cv = _at(cache_k, j), _at(cache_v, j)
            q, k, v = self._qkv(x, sin_row, cos_row, wqkv, h, hkv)
            ck[layer, :, :, :, slot] = k[:, :, 0].to(ck.dtype)
            cv[layer, :, :, :, slot] = v[:, :, 0].to(cv.dtype)
            out = _ring_decode_attention(q, ck[layer], cv[layer], mask)
            return (wo(out.to(x.dtype).reshape(b, 1, -1)),)

        return self._shardwise(x, heads)[0]

    def decode_recent_at(
        self,
        x: torch.Tensor,  # [B, 1, D]
        cache_k: torch.Tensor,  # [L, B, Hkv, C, W] read-only here
        cache_v: torch.Tensor,
        rk: torch.Tensor,  # [L, B, Hkv, R, C] recent rows, written in place
        rv: torch.Tensor,
        layer: int,
        r: torch.Tensor,  # [1] int32 step index within the chunk (row)
        mask_big: torch.Tensor,  # [W] additive f32 over the merged slots
        mask_rec: torch.Tensor,  # [R] additive f32 over the recent rows
        sin_row: torch.Tensor,
        cos_row: torch.Tensor,
    ) -> torch.Tensor:
        """Two-part single-token attention: the merged ring cache, read
        only, plus the chunk's recent rows, this token's written into row
        ``r`` first (a device index), under one joint softmax (exact).
        ``merge_recent`` folds the rows into the ring at the chunk's
        end."""
        b = x.shape[0]

        def heads(j, wqkv, wo, h, hkv):
            ck, cv, rkj, rvj = (_at(a, j) for a in (cache_k, cache_v, rk, rv))
            q, k, v = self._qkv(x, sin_row, cos_row, wqkv, h, hkv)
            rkj[layer].index_copy_(2, r.long(), k.to(rkj.dtype))
            rvj[layer].index_copy_(2, r.long(), v.to(rvj.dtype))
            out = _ring_decode_attention(q, ck[layer], cv[layer], mask_big,
                                         rkj[layer], rvj[layer], mask_rec)
            return (wo(out.to(x.dtype).reshape(b, 1, -1)),)

        return self._shardwise(x, heads)[0]

    def decode_paged_at(
        self,
        x: torch.Tensor,  # [S, 1, D] one new token per decode slot
        pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
        pool_v: torch.Tensor,
        bt: torch.Tensor,  # [S, Pmax] int32 block tables
        rk: torch.Tensor,  # [L, S, Hkv, R, C] recent rows, written in place
        rv: torch.Tensor,
        layer: int,
        r: int,  # step index within the decode window
        sin_rows: torch.Tensor,  # [S, 1, 1, C//2] per-slot rope rows
        cos_rows: torch.Tensor,
        pooled_len: torch.Tensor,  # [S] int32
        paged_kernel: str = "kernel",
        pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8)
        pool_sv: tp.Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Single-token attention over the paged pool plus the window's
        recent rows. This step's K/V row lands in recent row ``r``
        before the attention reads it; over an int8 pool it is first
        rounded through its page's grid, the page's scale looked up over
        the recent rows with this row written in (base ``pooled_len``).
        ``paged_kernel="kernel"`` goes through
        ``ops.paged_attn.paged_decode_attention`` (the CUDA kernel on the
        card, its plain version on the CPU); ``"reference"`` calls the
        plain version directly, on any device, for comparisons.

        Under a tensor axis each held shard runs its ``Hkv / tp`` KV heads
        (GQA groups unchanged) over its own pool, scale planes and recent
        rows, the entries of the per-shard tuples passed here, and the
        shards' ``wo`` products are summed (:meth:`_shardwise`)."""
        s = x.shape[0]
        c = x.shape[-1] // self.n_head
        if paged_kernel == "kernel":
            attn = paged_decode_attention
        elif paged_kernel == "reference":
            attn = paged_decode_attention_reference
        else:
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")

        def heads(j, wqkv, wo, h, hkv):
            pk, pv, rkj, rvj, skj, svj = (_at(a, j) for a in (
                pool_k, pool_v, rk, rv, pool_sk, pool_sv))
            q, k, v = self._qkv(x, sin_rows, cos_rows, wqkv, h, hkv)
            if skj is not None:
                # the recent rows in compute dtype with this row written
                # in: an earlier in-window birth row is read back already
                # rounded (derivation is rounding-stable)
                tmp_k = rkj[layer].to(k.dtype, copy=True)
                tmp_v = rvj[layer].to(v.dtype, copy=True)
                tmp_k[:, :, r] = k[:, :, 0]
                tmp_v[:, :, r] = v[:, :, 0]
                tmp_k, tmp_v = _round_rows(tmp_k, tmp_v, pooled_len, bt, skj,
                                           svj, layer, pk.shape[-1])
                k, v = tmp_k[:, :, r : r + 1], tmp_v[:, :, r : r + 1]
            rkj[layer, :, :, r] = k[:, :, 0].to(rkj.dtype)
            rvj[layer, :, :, r] = v[:, :, 0].to(rvj.dtype)
            qs = q.reshape(s, hkv, h // hkv, c)
            out = attn(qs, pk, pv, bt, pooled_len, rkj[layer], rvj[layer], r,
                       layer, _gathered_pool_scales(skj, bt, layer),
                       _gathered_pool_scales(svj, bt, layer))  # [S, Hkv, G, C]
            return (wo(out.reshape(s, 1, h * c)),)

        return self._shardwise(x, heads)[0]

    def verify_paged_at(
        self,
        x: torch.Tensor,  # [S, T, D] the dispatch's candidate rows
        pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
        pool_v: torch.Tensor,
        bt: torch.Tensor,  # [S, Pmax] int32 block tables
        layer: int,
        start: torch.Tensor,  # [S] int32 resident tokens per slot
        sin_rows: torch.Tensor,  # [S, 1, T, C//2] per-slot rope rows
        cos_rows: torch.Tensor,
        paged_kernel: str = "kernel",
        pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8)
        pool_sv: tp.Optional[torch.Tensor] = None,
    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Multi-row attention for speculative verification: every
        candidate row of a slot attends to the slot's resident pages and,
        causally, to the rows themselves, in the decode choreography.
        Over an int8 pool the rows' K/V are first rounded through their
        pages' grids (base ``start``). Then they are cast to the pool's
        row dtype before scoring, as the decode window reads its own rows
        back from its recent buffer. Returns ``(out, k, v)``, k/v
        ``[S, Hkv, T, C]`` in the compute dtype for the page write (under a
        tensor axis tuples over the held shards, as
        :meth:`decode_paged_at` runs them). ``paged_kernel`` as in
        :meth:`decode_paged_at`."""
        s, t, d = x.shape
        c = d // self.n_head
        if paged_kernel == "kernel":
            attn = paged_verify_attention
        elif paged_kernel == "reference":
            attn = paged_verify_attention_reference
        else:
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")

        def heads(j, wqkv, wo, h, hkv):
            pk, pv, skj, svj = (_at(a, j) for a in (pool_k, pool_v, pool_sk,
                                                     pool_sv))
            q, k, v = self._qkv(x, sin_rows, cos_rows, wqkv, h, hkv)
            row_dtype = pk.dtype
            if skj is not None:
                k, v = _round_rows(k, v, start, bt, skj, svj, layer,
                                   pk.shape[-1])
                row_dtype = torch.bfloat16  # the int8 pool's row dtype
            qg = q.reshape(s, hkv, h // hkv, t, c).contiguous()
            kc = k.to(row_dtype).contiguous()
            vc = v.to(row_dtype).contiguous()
            out = attn(qg, kc, vc, pk, pv, bt, start, layer,
                       _gathered_pool_scales(skj, bt, layer),
                       _gathered_pool_scales(svj, bt, layer))
            out = out.reshape(s, h, t, c).transpose(1, 2).reshape(s, t,
                                                                  h * c)
            return wo(out), k, v

        return self._shardwise(x, heads)

    def prefill_paged_at(
        self,
        x: torch.Tensor,  # [1, T, D] a prefill chunk's hidden states
        pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
        pool_v: torch.Tensor,
        bt: torch.Tensor,  # [1, Pmax] int32 the slot's block table
        layer: int,
        start: torch.Tensor,  # [1] int32 absolute position of chunk row 0
        mask_pool: tp.Optional[torch.Tensor],  # [Pmax PS] f32
        mask_self: torch.Tensor,  # [T, T] additive causal f32
        sin_rows: torch.Tensor,  # [T, C//2] rope rows at start .. start+T-1
        cos_rows: torch.Tensor,
        pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8)
        pool_sv: tp.Optional[torch.Tensor] = None,
        reduce: tp.Optional[tp.Callable] = None,
    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Multi-query attention of a prefill chunk: its rows attend, in one
        joint softmax, to the slot's resident pages (positions < ``start``:
        a prefix-cache hit, earlier chunks of the prompt) and causally to
        themselves. Returns ``(out, k, v)``, k/v ``[1, Hkv, T, C]`` for the
        page write. Over an int8 pool the chunk's K/V rows are first
        rounded through their pages' grids (base ``start``), so a later
        chunk reads from the pool the values this one used.

        The prefill choreography (module docstring): compute-dtype
        operands with f32 accumulation, the mask added before the scale,
        probabilities cast to the value dtype before PV. With
        ``mask_pool`` (a chunk that resumes, ``start > 0``) the whole table
        is read through the block table, JAX's form (pads and sentinels
        clipped into the pool, an int8 pool dequantized at the view,
        exactly); the columns at or past ``start`` are masked and
        contribute exactly zero, so one shape serves every ``start``, a
        device value. Without it (``start == 0``) the pool part is left
        out and the chunk attends to itself alone.

        Under a tensor axis each held shard runs its heads over its pool
        shard (:meth:`verify_paged_at`); ``reduce`` (``prefill_sp``) takes
        the shards' partial outputs in place of the all-reduce."""
        b, t, d = x.shape
        c = d // self.n_head
        f32 = torch.float32
        # made on the device: a host tensor cannot enter a CUDA graph
        scale = 1.0 / torch.sqrt(torch.full((), c, dtype=f32,
                                            device=x.device))

        def heads(j, wqkv, wo, h, hkv):
            pk, pv, skj, svj = (_at(a, j) for a in (pool_k, pool_v, pool_sk,
                                                     pool_sv))
            q, k, v = self._qkv(x, sin_rows, cos_rows, wqkv, h, hkv)
            if skj is not None:
                k, v = _round_rows(k, v, start, bt, skj, svj, layer,
                                   pk.shape[-1])
            qg = q.reshape(b, hkv, h // hkv, t, c)
            # compute-dtype operands, f32 accumulation: the exact products
            # of the upcast operands summed in f32
            qf = qg.to(f32)
            s_self = qf @ k[:, :, None].to(f32).transpose(-1, -2)
            if mask_pool is None:
                probs = torch.softmax((s_self + mask_self) * scale,
                                      dim=-1).to(v.dtype)
                o = probs @ v[:, :, None]  # [1, Hkv, G, T, C]
            else:
                # every page of the table; the columns >= start are masked
                idx = bt.long().clamp(0, pk.shape[1] - 1)
                ck = gathered_pool_view(pk, _gathered_pool_scales(
                    skj, bt, layer), idx, layer)  # [1, Hkv, C, W]
                cv = gathered_pool_view(pv, _gathered_pool_scales(
                    svj, bt, layer), idx, layer)
                s_pool = qf @ ck[:, :, None].to(qg.dtype).to(f32)
                w = s_pool.shape[-1]
                probs = torch.softmax(torch.cat(
                    [s_pool + mask_pool, s_self + mask_self], dim=-1) * scale,
                    dim=-1).to(v.dtype)
                o_pool = probs[..., :w] @ cv[:, :, None].to(
                    v.dtype).transpose(-1, -2)
                o = o_pool + probs[..., w:] @ v[:, :, None]
            out = o.reshape(b, h, t, c).transpose(1, 2).reshape(b, t, h * c)
            return wo(out.to(x.dtype)), k, v

        return self._shardwise(x, heads, reduce)


def mlp_hidden_dim(cfg: ModelConfig) -> int:
    """MLP hidden width; fractional ratios round up to a multiple of 256."""
    if cfg.mlp_hidden is not None:
        return cfg.mlp_hidden
    f = cfg.mlp_ratio * cfg.n_embd
    if f == int(f):
        return int(f)
    return 256 * -(-int(f) // 256)


class MLP(nn.Module):
    """GELU (tanh approximation) or SwiGLU MLP; under a tensor axis
    (``self.tensor``) ``w_up`` and ``w_gate`` column-parallel and
    ``w_down`` row-parallel, ``F / tp`` hidden columns a shard."""

    batch_offset = 0  # GPT.set_batch_offset
    seq = (0, 1)  # (index, size) of its rows' column slice
    tensor: tp.Optional[TensorExchange] = None  # GPT.shard_tensor_

    def __init__(self, w_up: Linear, w_down: Linear,
                 w_gate: tp.Optional[Linear], dropout_rate: float = 0.0):
        super().__init__()
        self.w_up, self.w_down, self.w_gate = w_up, w_down, w_gate
        self.dropout_rate = dropout_rate

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "MLP":
        f = mlp_hidden_dim(cfg)
        if cfg.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"unknown mlp kind {cfg.mlp!r}")
        w_up = Linear.init(cfg.n_embd, f, generator)
        w_down = Linear.init(f, cfg.n_embd, generator)
        w_gate = (
            Linear.init(cfg.n_embd, f, generator)
            if cfg.mlp == "swiglu" else None
        )
        return MLP(w_up, w_down, w_gate, cfg.dropout)

    def forward(self, x: torch.Tensor,
                key: tp.Optional[torch.Tensor] = None,
                reduce: tp.Optional[tp.Callable] = None) -> torch.Tensor:
        """The MLP of ``x``, dropout from ``key``. ``reduce`` (a serving
        prefill's ``prefill_sp``, no dropout) takes the tensor shards'
        partial outputs in place of the all-reduce and its result is
        returned as it is."""
        ex = self.tensor
        if ex is None:
            y = self._hidden_out(x, self.w_up, self.w_gate, self.w_down)
        else:
            x = copy_to_tensor(x, ex)

            def proj(lin, j, dim):  # one shard's x @ W
                return None if lin is None else held_proj(lin, j, ex, dim)

            parts = [self._hidden_out(
                x, proj(self.w_up, j, -1), proj(self.w_gate, j, -1),
                proj(self.w_down, j, -2)) for j, _ in ex.shards()]
            if reduce is not None:
                return reduce(parts)
            y = reduce_from_tensor(parts, ex)
        return dropout(y, self.dropout_rate, key, self.batch_offset,
                       self.seq)

    @staticmethod
    def _hidden_out(x, up_proj, gate_proj, down_proj) -> torch.Tensor:
        """``down(act(up(x)))``, each projection a callable (the modules,
        or one tensor shard's product)."""
        up = up_proj(x)
        if gate_proj is not None:
            hidden = F.silu(gate_proj(x)) * up
        else:
            hidden = F.gelu(up, approximate="tanh")
        return down_proj(hidden)


class MoEMLP(nn.Module):
    """Switch-style mixture of GELU experts (top-1, or GShard-style top-2
    with renormalized gates): the JAX package's ``MoEMLP``, function for
    function.

    ``batch_offset``: see ``GPT.set_batch_offset``.

    - Capacity is per batch row: ``C = ceil(cf * top_k * T / E)``, at
      least 1 and at most T. It depends on the call's T, so every caller
      must give the layer the JAX package's shapes.
    - The router runs in f32; K max extractions pick the choices (the
      first index on ties); gates are renormalized only at K > 1.
    - The aux loss is Switch eq. 4 over first choices.
    - Capacity slots fill in token order with first and second choices
      interleaved (one cumsum over the assignment matrix); claims past an
      expert's capacity contribute zero.

    Where JAX contracts one-hot ``[B, T, E, C]`` tensors, this layer moves
    rows by index: each kept claim's slot in an ``[E, B, C]`` buffer comes
    from the same cumsum, ``index_copy`` writes the tokens there (dropped
    claims into one spare row that is never read), two ``bmm`` s over E
    run the experts, and the combine gathers each claim's row back and
    sums the K choices in a fixed order. Every one-hot contraction has one
    non-zero term per output, so it is the same function, without the
    one-hots or their products, without a host sync and without atomics
    in the forward. The stages are methods (``route``, ``slots``,
    ``dispatch``, ``experts``, ``combine``) so that a profile can tell
    them apart.

    Under a tensor axis (``self.tensor``, expert parallelism: JAX shards
    the experts over ``tensor``) the routing stays replicated (every
    rank computes the same router, top-k, capacity and slots); each held
    shard dispatches only the claims of its ``E / tp`` experts, runs
    them, and combines zero rows for the claims whose expert lives
    elsewhere; the shards' outputs are summed before the dropout. The
    tokens and the gates take ``copy_to_tensor`` where they enter the
    sharded work, so the router's gradient is whole on every rank."""

    batch_offset = 0
    seq = (0, 1)
    tensor: tp.Optional[TensorExchange] = None

    def __init__(self, router: Linear, expert_up: torch.Tensor,
                 expert_down: torch.Tensor, capacity_factor: float = 1.25,
                 top_k: int = 1, dropout_rate: float = 0.0):
        super().__init__()
        self.router = router  # [D, E]
        self.expert_up = nn.Parameter(expert_up)  # [E, D, F]
        self.expert_down = nn.Parameter(expert_down)  # [E, F, D]
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.dropout_rate = dropout_rate

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "MoEMLP":
        """Every expert drawn as ``Linear.init`` draws a weight, so the
        experts start like the dense MLP they replace."""
        e, d, f = cfg.moe_experts, cfg.n_embd, mlp_hidden_dim(cfg)
        if not 1 <= cfg.moe_top_k <= e:
            raise ValueError(f"moe_top_k {cfg.moe_top_k} not in 1..{e}")
        router = Linear.init(d, e, generator)
        stacks = []
        for fan_in, fan_out in ((d, f), (f, d)):
            w = torch.empty(e, fan_in, fan_out, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            stacks.append(w * (1 / math.sqrt(fan_in)))
        return MoEMLP(router, *stacks, cfg.moe_capacity, cfg.moe_top_k,
                      cfg.dropout)

    @property
    def n_experts(self) -> int:
        """Every expert of the layer (``E``), held here or not."""
        ex = self.tensor
        e = self.expert_up.shape[0]
        return e if ex is None else e * ex.size // len(ex.held)

    def capacity(self, t: int) -> int:
        # the JAX package's float expression, verbatim: math.ceil of the
        # quotient rounds otherwise at exact multiples
        cap = int(-(-self.capacity_factor * self.top_k * t // self.n_experts))
        return max(1, min(cap, t))

    def route(self, x: torch.Tensor, need_aux: bool = True):
        """``(probs [B, T, E] f32, choices [B, T, K], gates [B, T, K] f32,
        aux)``; aux is None without ``need_aux`` (the serving paths drop
        it, as XLA drops the JAX program's unused aux). The router weight
        is cast to f32 (JAX promotes a bf16 weight against the f32
        activations; PyTorch raises)."""
        k = self.top_k
        probs = torch.softmax(x.float() @ self.router.weight.float(), dim=-1)
        remaining, vals, idxs = probs, [], []
        for i in range(k):
            v, ix = remaining.max(-1)  # the first index on ties
            vals.append(v)
            idxs.append(ix)
            if i + 1 < k:
                remaining = remaining.scatter(-1, ix[..., None], 0.0)
        if k == 1:
            choices, gates = idxs[0][..., None], vals[0][..., None]
        else:
            choices, gates = torch.stack(idxs, -1), torch.stack(vals, -1)
            gates = gates / gates.sum(-1, keepdim=True)
        aux = None
        if need_aux:
            first = torch.zeros_like(probs).scatter_(-1, choices[..., :1], 1.0)
            aux = self.n_experts * torch.mean(
                torch.sum(first.mean(1) * probs.mean(1), -1))
        return probs, choices, gates, aux

    def slots(self, choices: torch.Tensor, cap: int):
        """Each claim's row in the ``[E, B, C]`` buffer (flattened; the
        spare row ``E B C`` for a claim past capacity) and whether it is
        kept (None: every claim is). A claim's place in its expert's queue
        is the cumsum over tokens of the assignment matrix, first and
        second choices interleaved in token order; the cumsum runs along
        the innermost dimension of an ``[B, E, T]`` layout."""
        b, t, _ = choices.shape
        e = self.n_experts
        # row b's slots start at b C; a 1-based place p lands at + p - 1
        row0 = torch.arange(-1, b * cap - 1, cap, device=choices.device)
        base = choices * (b * cap) + row0[:, None, None]
        if t == 1:
            # one token's K claims go to K distinct experts: each is first
            # in its expert's queue (C = 1), so every claim is kept
            return base + 1, None
        by_expert = choices.transpose(1, 2)  # [B, K, T]
        assign = torch.zeros(b, e, t, dtype=torch.int32,
                             device=choices.device).scatter_(1, by_expert, 1)
        pos = assign.cumsum(-1, dtype=torch.int32).gather(
            1, by_expert).transpose(1, 2)  # [B, T, K], 1-based
        keep = pos <= cap
        return torch.where(keep, base + pos, e * b * cap), keep

    def dispatch(self, x: torch.Tensor, slot: torch.Tensor, cap: int,
                 e: tp.Optional[int] = None):
        """``[E, B C, D]``: every kept claim's token in its slot, zeros in
        the slots no claim filled (``e``: the buffer's experts, default
        every one; a tensor shard's claims of other experts go to the
        spare row)."""
        b, t, d = x.shape
        k = self.top_k
        e = self.n_experts if e is None else e
        src = x[:, :, None, :].expand(b, t, k, d).reshape(b * t * k, d)
        buf = x.new_zeros(e * b * cap + 1, d)
        buf.index_copy_(0, slot.reshape(-1), src)
        return buf[:-1].view(e, b * cap, d)

    def experts(self, xe: torch.Tensor, w_up=None,
                w_down=None) -> torch.Tensor:
        """GELU experts over ``[E, N, D]`` rows: two ``bmm`` s over E
        (``w_up``/``w_down``: a tensor shard's experts, default all)."""
        w_up = self.expert_up if w_up is None else w_up
        w_down = self.expert_down if w_down is None else w_down
        up = torch.bmm(xe, w_up.to(xe.dtype))
        return torch.bmm(F.gelu(up, approximate="tanh"),
                         w_down.to(xe.dtype))

    def shard_slots(self, choices: torch.Tensor, slot: torch.Tensor,
                    keep: tp.Optional[torch.Tensor], cap: int, r: int,
                    el: int):
        """Tensor index ``r``'s view of the claims (its ``el`` experts
        ``r el .. (r + 1) el``): each claim's row in its ``[el, B, C]``
        buffer (the spare row ``el B C`` for a claim of another expert or
        past capacity) and whether the shard keeps it."""
        b = choices.shape[0]
        mine = (choices >= r * el) & (choices < (r + 1) * el)
        if keep is not None:
            mine = mine & keep
        return torch.where(mine, slot - r * el * b * cap, el * b * cap), mine

    def combine(self, ye: torch.Tensor, slot: torch.Tensor,
                keep: tp.Optional[torch.Tensor],
                gates: torch.Tensor) -> torch.Tensor:
        """``[B, T, D]``: each claim's expert row times its gate (rounded
        to the activation dtype first, as JAX does), zero for a dropped
        claim, the K choices summed in order (in f32 at K > 1, as a
        contraction accumulates)."""
        b, t, k = slot.shape
        d = ye.shape[-1]
        if keep is not None:
            slot = torch.where(keep, slot, 0)
            gates = torch.where(keep, gates, 0.0)
        rows = ye.reshape(-1, d).index_select(0, slot.reshape(-1))
        rows = rows.view(b, t, k, d)
        coef = gates.to(ye.dtype)[..., None]
        if k == 1:
            return rows[:, :, 0] * coef[:, :, 0]
        return (rows.float() * coef.float()).sum(2).to(ye.dtype)

    def forward(self, x: torch.Tensor, key: tp.Optional[torch.Tensor] = None,
                return_dropped: bool = False, need_aux: bool = True):
        """``(y, aux)`` for ``x [B, T, D]``, with ``return_dropped`` also
        the fraction of routing claims past capacity (an f32 scalar). Dropout
        on the output from ``key``. Without ``need_aux`` aux is None."""
        cap = self.capacity(x.shape[1])
        _, choices, gates, aux = self.route(x, need_aux)
        slot, keep = self.slots(choices, cap)
        ex = self.tensor
        if ex is None:
            ye = self.experts(self.dispatch(x, slot, cap))
            y = self.combine(ye, slot, keep, gates)
        else:
            xs, gs = copy_to_tensor(x, ex), copy_to_tensor(gates, ex)
            el = self.n_experts // ex.size
            parts = []
            for j, r in ex.shards():
                ls, mine = self.shard_slots(choices, slot, keep, cap, r, el)
                ye = self.experts(self.dispatch(xs, ls, cap, el),
                                  held_shard(self.expert_up, j, ex, 0),
                                  held_shard(self.expert_down, j, ex, 0))
                parts.append(self.combine(ye, ls, mine, gs))
            y = reduce_from_tensor(parts, ex)
        y = dropout(y, self.dropout_rate, key, self.batch_offset, self.seq)
        if not return_dropped:
            return y, aux
        dropped = (x.new_zeros((), dtype=torch.float32) if keep is None
                   else 1.0 - keep.sum().float() / keep.numel())
        return y, aux, dropped


def make_mlp(cfg: ModelConfig, generator: torch.Generator):
    """Dense (gelu, swiglu) or MoE MLP by ``cfg.mlp``."""
    if cfg.mlp == "moe":
        return MoEMLP.init(cfg, generator)
    return MLP.init(cfg, generator)


def mlp_call(mlp, x: torch.Tensor, key: tp.Optional[torch.Tensor] = None,
             with_stats: bool = False, need_aux: bool = True):
    """``(y, aux)`` for either MLP kind, ``(y, aux, dropped)`` with
    ``with_stats``. A dense MLP's aux and dropped are the Python float 0.0:
    the dense path pays a type test and nothing on the card. Without
    ``need_aux`` an MoE layer skips its aux (None)."""
    if isinstance(mlp, MoEMLP):
        return mlp(x, key, return_dropped=with_stats, need_aux=need_aux)
    y = mlp(x, key)
    return (y, 0.0, 0.0) if with_stats else (y, 0.0)


class Block(nn.Module):
    """Pre-norm residual block."""

    def __init__(self, attn: Attention, mlp: tp.Union[MLP, MoEMLP], d: int,
                 norm_impl: str = "auto"):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1 = RMSNorm(d, use_weight=False, impl=norm_impl)
        self.ln2 = RMSNorm(d, use_weight=False, impl=norm_impl)

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "Block":
        return Block(Attention.init(cfg, generator), make_mlp(cfg, generator),
                     cfg.n_embd, cfg.norm_impl)

    def forward(self, x: torch.Tensor, rope: RopeTables,
                impl: str = "naive",
                key: tp.Optional[torch.Tensor] = None,
                return_aux: bool = False, return_kv: bool = False):
        """The block's output, and with ``return_aux`` its MLP's aux loss
        beside it (``(x, aux)``); with ``return_kv`` that and the
        attention's ``(k, v)`` (``(out, (k, v))``). ``key``: the layer's
        slice of the forward's site keys (``layers.site_row``)."""
        attn_key, mlp_key = (None, None) if key is None else (key[:2], key[2])
        a = self.attn(self.ln1(x), rope, impl, attn_key, return_kv)
        if return_kv:
            a, kv = a
        x = x + a
        y, aux = mlp_call(self.mlp, self.ln2(x), mlp_key,
                          need_aux=return_aux)
        out = (x + y, aux) if return_aux else x + y
        return (out, kv) if return_kv else out

    def decode_at(self, x, cache_k, cache_v, layer, slot, mask, sin_row,
                  cos_row):
        x = x + self.attn.decode_at(self.ln1(x), cache_k, cache_v, layer,
                                    slot, mask, sin_row, cos_row)
        return x + mlp_call(self.mlp, self.ln2(x), need_aux=False)[0]

    def decode_recent_at(self, x, cache_k, cache_v, rk, rv, layer, r,
                         mask_big, mask_rec, sin_row, cos_row):
        x = x + self.attn.decode_recent_at(
            self.ln1(x), cache_k, cache_v, rk, rv, layer, r, mask_big,
            mask_rec, sin_row, cos_row)
        return x + mlp_call(self.mlp, self.ln2(x), need_aux=False)[0]

    def decode_paged_at(self, x, pool_k, pool_v, bt, rk, rv, layer, r,
                        sin_rows, cos_rows, pooled_len, paged_kernel="kernel",
                        pool_sk=None, pool_sv=None):
        x = x + self.attn.decode_paged_at(
            self.ln1(x), pool_k, pool_v, bt, rk, rv, layer, r, sin_rows,
            cos_rows, pooled_len, paged_kernel=paged_kernel, pool_sk=pool_sk,
            pool_sv=pool_sv,
        )
        return x + mlp_call(self.mlp, self.ln2(x), need_aux=False)[0]

    def verify_paged_at(self, x, pool_k, pool_v, bt, layer, start, sin_rows,
                        cos_rows, paged_kernel="kernel", pool_sk=None,
                        pool_sv=None):
        attn_out, k, v = self.attn.verify_paged_at(
            self.ln1(x), pool_k, pool_v, bt, layer, start, sin_rows,
            cos_rows, paged_kernel=paged_kernel, pool_sk=pool_sk,
            pool_sv=pool_sv,
        )
        x = x + attn_out
        return x + mlp_call(self.mlp, self.ln2(x), need_aux=False)[0], k, v

    def prefill_paged_at(self, x, pool_k, pool_v, bt, layer, start,
                         mask_pool, mask_self, sin_rows, cos_rows,
                         pool_sk=None, pool_sv=None, sp=None):
        """A prefill chunk through the block. ``sp`` (the tensor axis's
        exchange, ``prefill_sp``): ``x`` is the held shards' row blocks
        (a list), on which the norms and the residual adds run; the
        attention and the MLP see the rows gathered, and their shards'
        partial outputs are reduce-scattered back to row blocks (JAX's
        ``sp=True``)."""
        if sp is None:
            attn_out, k, v = self.attn.prefill_paged_at(
                self.ln1(x), pool_k, pool_v, bt, layer, start, mask_pool,
                mask_self, sin_rows, cos_rows, pool_sk, pool_sv,
            )
            x = x + attn_out
            return (x + mlp_call(self.mlp, self.ln2(x), need_aux=False)[0],
                    k, v)
        if not isinstance(self.mlp, MLP):
            raise NotImplementedError(
                "prefill_sp with mlp='moe' is not ported (ROADMAP: MoE "
                "under serving tensor parallelism)")

        def scatter(parts):
            return scatter_rows(parts, sp)

        attn_rows, k, v = self.attn.prefill_paged_at(
            gather_rows([self.ln1(r) for r in x], sp), pool_k, pool_v, bt,
            layer, start, mask_pool, mask_self, sin_rows, cos_rows, pool_sk,
            pool_sv, reduce=scatter)
        x = [r + a for r, a in zip(x, attn_rows)]
        mlp_rows = self.mlp(gather_rows([self.ln2(r) for r in x], sp),
                            reduce=scatter)
        return [r + m for r, m in zip(x, mlp_rows)], k, v


def check_tensor(cfg: ModelConfig, size: int) -> None:
    """What a ``tensor`` axis of ``size`` needs of the model: V, H, Hkv,
    and F (an MoE's E: its experts split, not their columns) divisible by
    it (ValueError naming the field)."""
    if size == 1:
        return
    fields = {"vocab_size": cfg.vocab_size, "n_head": cfg.n_head,
              "n_kv_head": cfg.kv_heads}
    if cfg.mlp == "moe":
        fields["moe_experts"] = cfg.moe_experts
    else:
        fields["mlp_hidden"] = mlp_hidden_dim(cfg)
    for name, n in fields.items():
        if n % size:
            raise ValueError(f"{name}={n} is not divisible by the tensor "
                             f"axis {size}")


@torch.no_grad()
def shard_tensor(module: nn.Module, tensor: TensorExchange,
                 cfg: ModelConfig, prefix: str = "") -> nn.Module:
    """``module`` (a model, a block or one layer of it, its parameters
    named ``prefix + name`` in the model) on a tensor axis: every full
    parameter cut to ``tensor.held``'s shards, in a storage of its own
    (the full tensor is freed), and every layer computing through
    ``tensor``."""
    for name, p in module.named_parameters():
        if tensor_dim(prefix + name) is None or tensor.size == 1:
            continue
        new = tensor_shard(prefix + name, p.data, tensor.held, tensor.size,
                           cfg)
        if new.untyped_storage().data_ptr() == \
                p.data.untyped_storage().data_ptr():
            new = new.clone()
        p.data = new
    # an int8 serving model's projections (buffers): the codes of each
    # held shard stacked along rows, contiguous for the kernel
    for name, m in module.named_modules():
        if isinstance(m, QuantLinear):
            shard_quant_linear(m, prefix + name, tensor.held, tensor.size,
                               cfg)
    return set_tensor(module, tensor)


def set_tensor(module: nn.Module, tensor: TensorExchange) -> nn.Module:
    """Every layer of ``module`` (already holding ``tensor.held``'s
    shards) computing through ``tensor``: another exchange of the same
    held shards, such as a loopback one with other ``active`` indices."""
    for m in module.modules():
        if isinstance(m, (GPT, Embedding, Attention, MLP, MoEMLP)):
            m.tensor = tensor
    return module


def check_serving_tensor(cfg: ModelConfig, mesh) -> None:
    """What a serving mesh (``parallel.mesh.ServingMesh``) needs of the
    model, with the JAX engine's messages (``ValueError``, where JAX
    asserts): no ``sequence`` or ``pipeline`` axis, and a ``tensor`` that
    divides the heads and the KV heads (the pool splits by whole KV
    heads), the vocabulary and the MLP width. An MoE model under a
    tensor axis above 1 is not ported (``NotImplementedError``)."""
    if mesh.sequence != 1:
        raise ValueError("serving meshes cannot shard 'sequence' (decode is "
                         "one token deep); use a tensor-only mesh")
    if mesh.pipeline != 1:
        raise ValueError("serving meshes cannot shard 'pipeline'; use a "
                         "tensor-only mesh")
    tp_sz = mesh.tp
    if cfg.n_head % tp_sz or cfg.kv_heads % tp_sz:
        raise ValueError(f"tensor={tp_sz} must divide heads ({cfg.n_head}/"
                         f"{cfg.kv_heads}): the pool shards whole KV heads")
    if cfg.vocab_size % tp_sz:
        raise ValueError(f"tensor={tp_sz} must divide vocab_size "
                         f"{cfg.vocab_size}")
    if mlp_hidden_dim(cfg) % tp_sz:
        raise ValueError(f"tensor={tp_sz} must divide the MLP hidden width "
                         f"{mlp_hidden_dim(cfg)}")
    if cfg.mlp == "moe" and tp_sz > 1:
        raise NotImplementedError(
            "an MoE model served under tensor > 1 is not ported (ROADMAP: "
            "MoE under serving tensor parallelism)")


# a full model's tensor-parallel copies by exchange, kept while it lives
_TENSOR_COPIES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@torch.no_grad()
def tensor_copy(model: "GPT", tensor: TensorExchange) -> "GPT":
    """A copy of the (full) ``model`` holding ``tensor.held``'s shards and
    computing through ``tensor`` (:meth:`GPT.shard_tensor_`); an int8
    model's codes are cut from its own, so they are a slice of the
    unsharded codes bit for bit. ``model`` is left as it is. The copy is
    cut once an exchange (its size, held and active ranks and process
    group) and kept while ``model`` lives: the engines, the replicas and
    the sampler of one mesh share it. A cut holds the weights as they were
    when it was made; weights changed in place later reach no cut. A model already cut for an exchange
    of ``tensor``'s size and held ranks is returned as it is; one cut
    otherwise raises."""
    import copy

    if model.tensor is not None:
        if (model.tensor.size, model.tensor.held) != (tensor.size,
                                                      tensor.held):
            raise ValueError(
                f"the model holds tensor shards {model.tensor.held} of "
                f"{model.tensor.size}, the mesh {tensor.held} of "
                f"{tensor.size}")
        return model
    cut = _TENSOR_COPIES.setdefault(model, {})
    key = (tensor.size, tensor.held, tensor.active,
           getattr(tensor, "group", None))
    if key not in cut:
        cut[key] = copy.deepcopy(model).shard_tensor_(tensor)
    return cut[key]


def check_pipeline(cfg: ModelConfig, size: int, seq: int = 1) -> None:
    """What a ``pipeline`` axis of ``size`` stages needs of the model
    (ValueError naming the field, before any heavy work): ``n_layer``
    divisible by it, a dense MLP (JAX asserts: the MoE aux loss rides the
    layer scan the pipeline replaces) and an attention that runs on whole
    rows (JAX asserts: no ring or Ulysses inside the stages, so no
    ``sequence`` axis either)."""
    if size == 1:
        return
    stage_layers(cfg.n_layer, size, 0)
    if cfg.mlp == "moe":
        raise ValueError(f"mlp='moe' cannot run under pipeline={size} (JAX "
                         f"asserts a dense MLP under pipeline parallelism)")
    if cfg.attn_impl in ("ring", "ulysses") or seq > 1:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} with sequence={seq} cannot run "
            f"under pipeline={size}: the stages see whole rows (JAX asserts "
            f"no ring or Ulysses inside the pipeline)")


class StageBlocks(nn.ModuleList):
    """A pipeline stage's blocks under their global indices (parameter
    names ``blocks.{i}.…`` with ``i`` from ``first``), iterated and
    indexed by position as a ``ModuleList``."""

    def __init__(self, blocks: tp.Sequence[nn.Module], first: int):
        nn.Module.__init__(self)
        for i, b in enumerate(blocks):
            self.add_module(str(first + i), b)

    def __getitem__(self, idx):
        held = list(self._modules.values())
        if isinstance(idx, slice):
            return nn.ModuleList(held[idx])
        return held[idx]


class GPT(nn.Module):
    """The full model; ``blocks`` is a list of per-layer modules. A
    pipeline stage's model (:meth:`keep_stage_`, ``GPT.init``'s
    ``stage``) holds its blocks only, under their global indices, and the
    ends where they are used: ``wte`` on the first stage, ``lm_head`` on
    the last (a tied embedding on both)."""

    batch_offset = 0  # set_batch_offset
    sequence: tp.Optional[Exchange] = None
    tensor: tp.Optional[TensorExchange] = None  # shard_tensor_
    # the pipeline axis: a stage model's (index, size), and the exchange
    # its pipelined steps run over (train.bind_mesh)
    stage: tp.Optional[tp.Tuple[int, int]] = None
    pipeline: tp.Optional[PipeExchange] = None

    def __init__(self, cfg: ModelConfig, wte: tp.Optional[Embedding],
                 blocks: tp.Sequence[Block], lm_head: tp.Optional[Linear],
                 first_layer: int = 0):
        super().__init__()
        self.config = cfg
        self.wte = wte
        self.blocks = (nn.ModuleList(blocks) if first_layer == 0
                       else StageBlocks(blocks, first_layer))
        self.first_layer = first_layer
        for blk in self.blocks:
            blk.attn.ring_schedule = cfg.ring_schedule
        self.ln_f = RMSNorm(cfg.n_embd, use_weight=False, eps=1e-5,
                            impl=cfg.norm_impl)
        self.lm_head = lm_head

    @staticmethod
    def init(
        cfg: ModelConfig,
        generator: tp.Optional[torch.Generator] = None,
        device: tp.Union[None, str, torch.device] = None,
        dtype: torch.dtype = torch.float32,
        tensor: tp.Optional[TensorExchange] = None,
        stage: tp.Optional[tp.Tuple[int, int]] = None,
    ) -> "GPT":
        """Random init with the JAX package's distributions: truncated
        normal linears scaled ``1/sqrt(fan_in)``, an ``N(0, 1/D)``
        embedding, and an untied head initialized to the embedding's
        transpose. Drawn on the CPU from ``generator`` (so a seed gives
        the same weights on every device), then moved to ``device``
        (the card unless the caller asks for the CPU) in ``dtype``.

        ``tensor``: keep only its held tensor shards (the model of a
        tensor rank, :meth:`shard_tensor_`): every block is cut as soon as
        it is drawn, so the full model never exists at once; the shards
        equal those cut from the full init of the same seed.

        ``stage``: ``(index, size)``, keep only that pipeline stage's
        blocks and ends (:meth:`keep_stage_`): the others are drawn, to
        keep the generator's sequence, and dropped at once."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if tensor is not None:
            check_tensor(cfg, tensor.size)
        layers = range(cfg.n_layer)
        if stage is not None:
            check_pipeline(cfg, stage[1])
            layers = stage_layers(cfg.n_layer, stage[1], stage[0])
        blocks = []
        for i in range(cfg.n_layer):
            block = Block.init(cfg, generator)
            if i not in layers:
                continue
            blocks.append(block)
            if tensor is not None:
                shard_tensor(blocks[-1], tensor, cfg, f"blocks.{i}.")
        wte = Embedding.init(
            cfg.vocab_size, cfg.n_embd, 1 / math.sqrt(cfg.n_embd), generator
        )
        lm_head = (
            None if cfg.tie_embeddings
            else Linear(wte.weight.detach().t().contiguous())
        )
        model = GPT(cfg, wte, blocks, lm_head, layers[0])
        if stage is not None:
            model._keep_ends(*stage)
        if tensor is not None:
            for name in ("wte", "lm_head"):
                if getattr(model, name) is not None:
                    shard_tensor(getattr(model, name), tensor, cfg,
                                 name + ".")
            model.tensor = tensor
        return model.to(device=device, dtype=dtype)

    def keep_stage_(self, index: int, size: int) -> "GPT":
        """Keep only pipeline stage ``index`` of ``size``'s parameters (a
        full model's): blocks ``stage_layers(L, size, index)`` under their
        global names, ``wte`` on the first stage (and the last, tied),
        ``lm_head`` on the last. ``ValueError`` where the config cannot
        be pipelined (:func:`check_pipeline`)."""
        cfg = self.config
        if self.stage is not None or self.first_layer or len(
                self.blocks) != cfg.n_layer:
            raise ValueError("keep_stage_ needs a full model")
        if size == 1:
            return self
        check_pipeline(cfg, size)
        layers = stage_layers(cfg.n_layer, size, index)
        self.blocks = StageBlocks([self.blocks[i] for i in layers],
                                  layers[0])
        self.first_layer = layers[0]
        self._keep_ends(index, size)
        return self

    def _keep_ends(self, index: int, size: int) -> None:
        """Stage ``index`` of ``size``: drop the ends it does not use."""
        last = index == size - 1
        if not (index == 0 or (last and self.config.tie_embeddings)):
            self.wte = None
        if not last:
            self.lm_head = None
        self.stage = (index, size)

    def shard_tensor_(self, tensor: TensorExchange) -> "GPT":
        """Keep only ``tensor.held``'s shards of every (full) parameter
        (``parallel.sharding.tensor_shard``) and compute through
        ``tensor``: the embedding, the attention, the MLPs and the head
        become tensor-parallel. ``tensor.size`` must divide V, H, Hkv, F
        and E (ValueError naming the field)."""
        check_tensor(self.config, tensor.size)
        return shard_tensor(self, tensor, self.config)

    def set_batch_offset(self, rows: int,
                         sequence: tp.Optional[Exchange] = None) -> None:
        """Draw dropout as rows ``rows ..`` of a larger batch: every
        dropout site (embedding, attention probabilities and output, MLP
        output) keys its masks on the global row, so a data-parallel
        rank holding rows ``[rows, rows + B)`` of a global batch drops
        exactly what one model over the whole batch drops there.

        ``sequence``: the exchange of the mesh's sequence axis. Then a
        forward's ``[B, T_l]`` tokens are column slice ``sequence.index``
        of ``sequence.size`` of each row (the sequence offset is ``index
        T_l``, the global T is ``size T_l``): RoPE takes global
        positions, the block size check reads the global T, attention
        runs ring or Ulysses over the exchange and every dropout site
        draws the whole row's masks at its columns. A Switch MoE's
        capacity is per global row, so an MoE model refuses a sequence
        axis above 1 (ROADMAP Q9: MoE x sequence)."""
        seq = seq_shard(sequence)
        check_moe_sequence(self.config, seq[1])
        for m in self.modules():
            if isinstance(m, (GPT, Attention, MLP, MoEMLP)):
                m.batch_offset = int(rows)
            if isinstance(m, (MLP, MoEMLP)):
                m.seq = seq
            if isinstance(m, (GPT, Attention)):
                m.sequence = sequence

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def set_rows(self, rows: int) -> None:
        """Draw dropout as rows ``rows ..`` of the global batch (the row
        offset of :meth:`set_batch_offset` alone: a pipelined step sets
        each microbatch's)."""
        for m in self.modules():
            if isinstance(m, (GPT, Attention, MLP, MoEMLP)):
                m.batch_offset = int(rows)

    def stage_forward(self, index: int, size: int, inp: torch.Tensor,
                      rope: "RopeTables", impl: str,
                      row: tp.Optional[torch.Tensor],
                      boundary_dtype: torch.dtype) -> torch.Tensor:
        """Pipeline stage ``index`` of ``size`` on one microbatch (JAX's
        ``stage_fn`` in ``gpt_pipeline_hidden``): stage 0 embeds ``inp``
        (token ids ``[b, T]``), a later stage casts its ``[b, T, D]``
        input from the boundary dtype to the model's; then the stage's
        blocks (every attention routes as on one card); the last stage
        returns ``ln_f``'s output in the model's dtype, the others theirs
        in ``boundary_dtype``. ``row``: the forward's site keys (dropout),
        or None."""
        cfg = self.config
        layout = site_row(cfg.n_layer)
        if index == 0:
            drop_key = None if row is None else row[layout["embed"]]
            h = dropout(self.wte(inp), cfg.dropout, drop_key,
                        self.batch_offset)
        else:
            h = inp.to(self.dtype)
        for i in stage_layers(cfg.n_layer, size, index):
            bkey = None if row is None else row[layout["layers"][i]]
            h = self.blocks[i - self.first_layer](h, rope, impl, bkey)
        if index == size - 1:
            return self.ln_f(h)
        return h.to(boundary_dtype)

    def head_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """``[D, V]`` lm-head weight in ``dtype`` (under a tensor axis the
        held shards' ``[D, V / tp]`` columns, end to end; with tied
        embeddings the embedding's shard); full-precision heads only (a
        quantized head's scale belongs in the product: use
        :meth:`project`)."""
        if isinstance(self.lm_head, QuantLinear):
            raise ValueError("quantized head: use GPT.project, which keeps "
                             "the int8 weight and its scale epilogue")
        if self.lm_head is None:
            return self.wte.weight.t().to(dtype)
        return self.lm_head.weight.to(dtype)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states ``[..., D]`` -> vocab logits ``[..., V]``: the one
        head entry point (``(h @ w_int8) * scale`` for a quantized head).

        Under a tensor axis the head is column-parallel and the logits
        stay vocabulary-sharded, as JAX's ``shard_act(..., "vocab")``:
        ``[..., V / tp]`` columns a held shard, one product each, end to
        end (the whole row on a loopback holding every shard). Greedy
        tokens come from them through ``parallel.tensor.greedy_argmax``,
        sampled ones after ``gather_vocab``."""
        ex = self.tensor
        if ex is None:
            if isinstance(self.lm_head, QuantLinear):
                return self.lm_head(h)
            return h @ self.head_weight(h.dtype)
        if isinstance(self.lm_head, QuantLinear):
            parts = [held_proj(self.lm_head, j, ex, -1)(h)
                     for j, _ in ex.shards()]
        else:
            w = self.head_weight(h.dtype)
            parts = [h @ held_shard(w, j, ex, -1) for j, _ in ex.shards()]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

    def hidden(self, tokens: torch.Tensor,
               attn_impl: tp.Optional[str] = None,
               key: tp.Union[None, int, torch.Tensor] = None,
               deterministic: bool = True, return_aux: bool = False,
               return_kv: bool = False):
        """``[B, T, D]`` final (``ln_f``-normalized) hidden states of
        ``tokens [B, T]``, in the model's dtype. With ``deterministic``
        False and ``cfg.dropout > 0``, dropout is drawn from ``key``
        (none without one): an int, split as the JAX model splits its
        PRNG key (``layers.dropout_site_keys``: one key for the
        embeddings, one per block, and within a block one per site), or
        that row of site keys already on the device (int64, a training
        step's row of its key table). With ``return_aux``, ``(h, aux)``:
        the MoE load-balance loss SUMMED over the layers (f32; 0 for
        dense MLPs), as the JAX model's layer scan carries it (Switch
        applies its weight per layer and sums). With ``return_kv``, ``(h, (ks, vs))``
        (``((h, (ks, vs)), aux)`` with both, as in JAX): every layer's
        post-RoPE K and raw V stacked ``[L, B, Hkv, T, C]`` (the
        prefill; under a tensor axis tuples of the held shards' ``Hkv /
        tp`` heads)."""
        cfg = self.config
        impl = attn_impl if attn_impl is not None else cfg.attn_impl
        t = tokens.shape[1]
        i_seq, s_seq = seq_shard(self.sequence)
        if t * s_seq > cfg.block_size:
            raise ValueError(f"sequence {t * s_seq} > block_size "
                             f"{cfg.block_size}")
        if cfg.remat not in ("none", "dots", "full", "auto"):
            # "auto" reaching the model means no trainer resolved it: with
            # or without gradients it behaves as "none", as in the JAX
            # package
            raise ValueError(f"remat={cfg.remat!r} is not one of none | "
                             f"dots | full | auto")
        rope = (_rope_tables_full(cfg.head_dim, t, cfg.rope_base,
                                  tokens.device) if s_seq == 1 else
                _rope_tables_rows(cfg.head_dim, t * s_seq, i_seq * t, t,
                                  cfg.rope_base, tokens.device))
        drop_key, block_keys = None, [None] * cfg.n_layer
        if key is not None and not deterministic:
            row = key_row(key, cfg.n_layer, tokens.device)
            layout = site_row(cfg.n_layer)
            drop_key = row[layout["embed"]]
            block_keys = [row[sl] for sl in layout["layers"]]
        h = dropout(self.wte(tokens), cfg.dropout, drop_key,
                    self.batch_offset, (i_seq, s_seq))
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        aux = (torch.zeros((), dtype=torch.float32, device=tokens.device)
               if return_aux else None)
        ks, vs = [], []
        for block, bkey in zip(self.blocks, block_keys):
            if remat in ("full", "dots"):
                # the block's masks and routing are functions of its
                # inputs and bkey: the recompute draws the same ones
                # no RNG state to keep (the masks are keyed), and reading
                # the card's RNG state is refused while a graph captures
                out = torch.utils.checkpoint.checkpoint(
                    block, h, rope, impl, bkey, return_aux, return_kv,
                    use_reentrant=False, preserve_rng_state=False,
                    **({"context_fn": dots_contexts} if remat == "dots"
                       else {}))
            else:
                out = block(h, rope, impl, bkey, return_aux, return_kv)
            if return_kv:
                out, (k, v) = out
                ks.append(k)
                vs.append(v)
            if return_aux:
                h, layer_aux = out
                aux = aux + layer_aux
            else:
                h = out
        h = self.ln_f(h)
        if return_kv:
            h = (h, (stack_layers(ks), stack_layers(vs)))
        return (h, aux) if return_aux else h

    @torch.no_grad()
    def moe_stats(self, tokens: torch.Tensor,
                  attn_impl: tp.Optional[str] = None
                  ) -> tp.Dict[str, torch.Tensor]:
        """Router telemetry from one deterministic forward of ``tokens
        [B, T]``: the load-balance ``aux`` summed over the layers (the
        training convention) and ``dropped_frac``, the fraction of routing
        claims past capacity, averaged over the layers. Device scalars."""
        cfg = self.config
        if cfg.mlp != "moe":
            raise ValueError("moe_stats needs an MoE model (mlp='moe')")
        impl = attn_impl if attn_impl is not None else cfg.attn_impl
        rope = _rope_tables_full(cfg.head_dim, tokens.shape[1], cfg.rope_base,
                                 tokens.device)
        h = self.wte(tokens)
        auxs, drops = [], []
        for block in self.blocks:
            h = h + block.attn(block.ln1(h), rope, impl)
            y, aux, dropped = mlp_call(block.mlp, block.ln2(h),
                                       with_stats=True)
            h = h + y
            auxs.append(aux)
            drops.append(dropped)
        return {"aux": torch.stack(auxs).sum(),
                "dropped_frac": torch.stack(drops).mean()}

    def forward(self, tokens: torch.Tensor,
                attn_impl: tp.Optional[str] = None,
                key: tp.Optional[int] = None,
                deterministic: bool = True) -> torch.Tensor:
        """``[B, T, V]`` logits in the model's dtype."""
        return self.project(self.hidden(tokens, attn_impl, key,
                                        deterministic))


def pipeline_loss(model: GPT, tokens: torch.Tensor, targets: torch.Tensor,
                  head_loss: tp.Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor],
                  n_micro: int,
                  key: tp.Union[None, int, torch.Tensor] = None,
                  boundary_dtype: torch.dtype = torch.float32,
                  train: bool = True,
                  acc: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """One microstep of ``tokens -> targets [b, T]`` through the pipeline
    of ``model.pipeline`` (the counterpart of JAX's
    ``gpt_pipeline_hidden`` and the loss after it): ``n_micro``
    microbatches of ``b / n_micro`` consecutive rows, each stage's
    blocks on the stages ``model.pipeline.held`` (``model`` holds them:
    the whole model on a loopback, its stage on a rank), activations
    crossing stages in ``boundary_dtype``, and on the last stage
    ``head_loss(ln_f output, targets)`` a microbatch. With ``train`` the
    backward runs (``parallel.pipeline.pipeline_run``: the parameters'
    ``.grad`` accumulate each microbatch's loss's gradient, in
    microbatch order). Dropout (``key``: an int or a row of site keys)
    draws each microbatch's rows of the microstep's masks
    (:meth:`GPT.set_rows`). Returns ``acc`` (default 0) plus every
    microbatch's loss, added in order: on the last stage the microstep's
    losses, elsewhere ``acc`` unchanged."""
    cfg = model.config
    ex = model.pipeline
    b, t = tokens.shape
    if t > cfg.block_size:
        raise ValueError(f"sequence {t} > block_size {cfg.block_size}")
    if b % n_micro:
        raise ValueError(f"{n_micro} microbatches do not split {b} rows")
    bm = b // n_micro
    device = tokens.device
    rope = _rope_tables_full(cfg.head_dim, t, cfg.rope_base, device)
    row = None if key is None else key_row(key, cfg.n_layer, device)
    base = model.batch_offset

    def stage_fn(s: int, inp: torch.Tensor, m: int) -> torch.Tensor:
        model.set_rows(base + m * bm)
        out = model.stage_forward(s, ex.size, inp, rope, cfg.attn_impl, row,
                                  boundary_dtype)
        if s == ex.size - 1:
            return head_loss(out, targets[m * bm:(m + 1) * bm])
        return out

    try:
        losses = pipeline_run(ex, n_micro, stage_fn,
                              lambda m: tokens[m * bm:(m + 1) * bm],
                              (bm, t, cfg.n_embd), boundary_dtype, device,
                              train)
    finally:
        model.set_rows(base)
    if acc is None:
        acc = torch.zeros((), dtype=torch.float32, device=device)
    for loss in losses:
        acc = acc + loss
    return acc


def count_params(model: GPT) -> int:
    """Non-embedding parameter count: every parameter, less the untied
    head (the JAX package's convention)."""
    total = sum(p.numel() for p in model.parameters())
    if model.lm_head is not None:
        total -= model.lm_head.weight.numel()
    return total


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, length: int, base: float,
                device: torch.device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """f32 rope tables ``[length, C//2]`` on ``device``."""
    sin, cos = rope_tables(head_dim, length, base)
    return (torch.from_numpy(sin).float().to(device),
            torch.from_numpy(cos).float().to(device))


class RopeTables(tp.NamedTuple):
    """Rope tables of ``T`` positions: ``[T, C//2]`` f32 for the naive
    path, and their duplicated-interleaved ``[T, C]`` f32 forms for the
    fused kernels."""

    sin: torch.Tensor
    cos: torch.Tensor
    sin_full: torch.Tensor
    cos_full: torch.Tensor


@functools.lru_cache(maxsize=8)
def _rope_tables_full(head_dim: int, length: int, base: float,
                      device: torch.device) -> RopeTables:
    """Both forms, built once per (shape, device) rather than per layer."""
    sin, cos = _rope_table(head_dim, length, base, device)
    return RopeTables(sin, cos, *rope_full_tables(sin, cos))


@functools.lru_cache(maxsize=8)
def _rope_tables_rows(head_dim: int, length: int, lo: int, n: int,
                      base: float, device: torch.device) -> RopeTables:
    """Rows ``[lo, lo + n)`` of the ``length``-position tables: a sequence
    rank's columns at their global positions (kept, so a captured graph
    reads them where they were)."""
    full = _rope_tables_full(head_dim, length, base, device)
    return RopeTables(*(x[lo:lo + n] for x in full))


def full_forward_impl(cfg: ModelConfig) -> str:
    """The attention impl of the fixed-batch sampler's full forwards (the
    prefill and the exact sliding window's re-forward). As in the JAX
    package the kernel configurations (``flash``, ``fused``) and the
    sequence-parallel ones (``ring``, ``ulysses``: a model trained over a
    sequence axis samples on one card) go to ``"auto"``: on the card the
    fused kernels where :meth:`Attention._use_fused` takes them (never
    with ``return_kv``), else the flash kernels, which take any causal
    length (``attention`` pads it to their tile)."""
    return ("auto" if cfg.attn_impl in ("flash", "fused", "ring", "ulysses")
            else cfg.attn_impl)


class KVCache(tp.NamedTuple):
    """The fixed-batch sampler's ring cache: per-layer post-RoPE K and raw
    V, ``[L, B, Hkv, C, W]``, time minor (the JAX package's layout); under
    a tensor axis a tuple of the held shards' ``[L, B, Hkv / tp, C, W]``
    each. The sampling functions write it in place."""

    k: tp.Union[torch.Tensor, tp.Tuple[torch.Tensor, ...]]
    v: tp.Union[torch.Tensor, tp.Tuple[torch.Tensor, ...]]

    @staticmethod
    def init(cfg: ModelConfig, batch: int, max_len: int,
             dtype: torch.dtype = torch.bfloat16,
             device: tp.Union[None, str, torch.device] = None,
             tensor: tp.Optional[TensorExchange] = None) -> "KVCache":
        """Zeros of ``max_len`` slots on ``device`` (the card unless the
        caller asks for the CPU), split by whole KV heads over
        ``tensor``'s held shards where one is given."""
        device = resolve_device(device)
        if tensor is None:
            shape = (cfg.n_layer, batch, cfg.kv_heads, cfg.head_dim, max_len)
            return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                           torch.zeros(shape, dtype=dtype, device=device))
        shape = (cfg.n_layer, batch, cfg.kv_heads // tensor.size,
                 cfg.head_dim, max_len)
        n = len(tensor.held)
        return KVCache(*(tuple(torch.zeros(shape, dtype=dtype, device=device)
                               for _ in range(n)) for _ in range(2)))

    @property
    def length(self) -> int:
        """The ring's slots ``W``."""
        return as_shards(self.k)[0].shape[-1]


def _rope_row(cfg: ModelConfig, pos: tp.Union[int, torch.Tensor],
              rope_len: int, device: torch.device, dtype: torch.dtype):
    """``[1, C//2]`` sin and cos rows at ``pos`` (an int, or a ``[1]``
    device tensor; read by ``index_select``) of ``rope_len``-row tables,
    in ``dtype``."""
    sin_t, cos_t = _rope_table(cfg.head_dim, rope_len, cfg.rope_base, device)
    at = device_scalar(pos, device).long()
    return (sin_t.index_select(0, at).to(dtype),
            cos_t.index_select(0, at).to(dtype))


@torch.no_grad()
def decode_step(
    model: GPT,
    tokens: torch.Tensor,  # [B] int the newest token per sequence
    pos: int,  # absolute position of this token (tokens so far)
    cache: KVCache,
    rope_len: tp.Optional[int] = None,
) -> tp.Tuple[torch.Tensor, KVCache]:
    """One incremental step over the ring cache of ``W`` slots: logits
    ``[B, V]`` for the next token, and the cache with this token's K/V
    written at slot ``pos % W``. Slot ``s`` holds absolute position
    ``pos - ((pos - s) mod W)`` and is valid iff that is >= 0; past ``W``
    tokens the newest evicts the oldest (the reference's sliding window).
    ``rope_len`` sizes the rope tables (default ``W``)."""
    cfg = model.config
    w = cache.length
    dev = tokens.device
    idx = torch.arange(w, device=dev)
    abs_pos = pos - torch.remainder(pos - idx, w)
    mask = torch.where(abs_pos >= 0, 0.0, -math.inf).to(torch.float32)
    h = model.wte(tokens[:, None])  # [B, 1, D]
    sin_h, cos_h = _rope_row(cfg, pos, rope_len or w, dev, h.dtype)
    for i, block in enumerate(model.blocks):
        h = block.decode_at(h, cache.k, cache.v, i, pos % w, mask, sin_h,
                            cos_h)
    return model.project(model.ln_f(h))[:, 0, :], cache


@torch.no_grad()
def decode_step_recent(
    model: GPT,
    tokens: torch.Tensor,  # [B] int
    pos: tp.Union[int, torch.Tensor],  # absolute position (chunk_base + r)
    cache: KVCache,  # merged ring cache, read-only here
    rk: torch.Tensor,  # [L, B, Hkv, R, C] recent rows, written in place
    rv: torch.Tensor,
    r: tp.Union[int, torch.Tensor],  # step index within the chunk
    chunk_base: tp.Union[int, torch.Tensor],  # position of its 1st token
    window: int,  # the sliding window, min(total, block_size)
    rope_len: int,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the chunked sampler: attends over the merged ring
    (positions ``< chunk_base``) and the recent rows ``chunk_base ..
    pos``, both masked to the sliding window, and appends this token's
    K/V to recent row ``r``. Merged slot ``s`` holds the latest position
    ``< chunk_base`` congruent to ``s``: valid iff it is >= 0 and
    ``> pos - window``; recent row ``j`` is valid iff ``j <= r`` and
    ``j > r - window`` (a chunk longer than the window evicts its own
    oldest rows). ``pos``, ``r`` and ``chunk_base`` are made ``[1]``
    device scalars at entry (the sampler's step program passes them so):
    every mask, the RoPE row and the row written are device
    computations. Returns ``(logits [B, V], rk, rv)``."""
    cfg = model.config
    w, rr = cache.length, as_shards(rk)[0].shape[3]
    dev = tokens.device
    pos, chunk_base = device_scalar(pos, dev), device_scalar(chunk_base, dev)
    r = device_scalar(r, dev)
    idx = torch.arange(w, device=dev)
    abs_pos = (chunk_base - 1) - torch.remainder(chunk_base - 1 - idx, w)
    valid_big = (abs_pos >= 0) & (abs_pos > pos - window)
    mask_big = torch.where(valid_big, 0.0, -math.inf).to(torch.float32)
    ridx = torch.arange(rr, device=dev)
    mask_rec = torch.where((ridx <= r) & (ridx > r - window), 0.0,
                           -math.inf).to(torch.float32)
    h = model.wte(tokens[:, None])
    sin_h, cos_h = _rope_row(cfg, pos, rope_len, dev, h.dtype)
    for i, block in enumerate(model.blocks):
        h = block.decode_recent_at(h, cache.k, cache.v, rk, rv, i, r,
                                   mask_big, mask_rec, sin_h, cos_h)
    return model.project(model.ln_f(h))[:, 0, :], rk, rv


def merge_recent(cache: KVCache, rk: torch.Tensor, rv: torch.Tensor,
                 slot0: tp.Union[int, torch.Tensor], length: int) -> KVCache:
    """Fold the first ``length`` recent rows into the ring at slots
    ``slot0 .. slot0 + length - 1`` (in place, by ``index_copy_``;
    ``slot0`` is made a ``[1]`` device scalar at entry; the sampler
    aligns chunk bases so the range never wraps; under a tensor axis each
    held shard's rows into its ring)."""

    def merge(dst, src):
        at = device_scalar(slot0, dst.device).long() + torch.arange(
            length, device=dst.device)
        dst.index_copy_(4, at, src[:, :, :, :length].transpose(-1, -2).to(
            dst.dtype))

    shardwise(merge, cache.k, rk)
    shardwise(merge, cache.v, rv)
    return cache


@torch.no_grad()
def prefill(model: GPT, tokens: torch.Tensor,
            cache: KVCache) -> tp.Tuple[torch.Tensor, KVCache]:
    """Fill the ring's first ``P`` slots with a whole prompt ``[B, P]`` in
    one forward (:meth:`GPT.hidden` with ``return_kv``; the impl from
    :func:`full_forward_impl`). Returns the logits after the last prompt
    token ``[B, V]`` and the cache."""
    p = tokens.shape[1]
    if p > cache.length:
        raise ValueError(f"prompt {p} exceeds cache length {cache.length}")
    h, (ks, vs) = model.hidden(
        tokens, attn_impl=full_forward_impl(model.config), return_kv=True)

    def fill(dst, src):
        dst[..., :p] = src.transpose(-1, -2).to(dst.dtype)

    shardwise(fill, cache.k, ks)
    shardwise(fill, cache.v, vs)
    return model.project(h[:, -1, :]), cache


@torch.no_grad()
def prefill_stepwise(model: GPT, tokens: torch.Tensor,
                     cache: KVCache) -> tp.Tuple[torch.Tensor, KVCache]:
    """Token-by-token prefill through :func:`decode_step`: the oracle the
    batched prefill is tested against."""
    logits = None
    for pos in range(tokens.shape[1]):
        logits, cache = decode_step(model, tokens[:, pos], pos, cache)
    return logits, cache


@torch.no_grad()
def decode_step_paged(
    model: GPT,
    tokens: torch.Tensor,  # [S] int the newest token per decode slot
    pos: torch.Tensor,  # [S] per-slot absolute position of this token
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32
    rk: torch.Tensor,  # [L, S, Hkv, R, C] recent rows, written in place
    rv: torch.Tensor,
    r: int,  # step index within the decode window
    pooled_len: torch.Tensor,  # [S] int32 tokens already in the pool
    rope_len: int,
    paged_kernel: str = "kernel",
    pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8 pool)
    pool_sv: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every slot: each attends over its own pages
    (positions ``< pooled_len``) plus the recent rows ``0..r``, and
    appends its K/V to recent row ``r`` (over an int8 pool, rounded to
    its page's grid). Returns ``(logits [S, V]`` in the compute
    dtype``, rk, rv)``."""
    cfg = model.config
    sin_t, cos_t = _rope_table(cfg.head_dim, rope_len, cfg.rope_base,
                               tokens.device)
    pos_c = pos.long().clamp(0, rope_len - 1)
    h = model.wte(tokens[:, None])  # [S, 1, D]
    sin_rows = sin_t[pos_c][:, None, None, :].to(h.dtype)  # [S, 1, 1, C/2]
    cos_rows = cos_t[pos_c][:, None, None, :].to(h.dtype)
    for i, block in enumerate(model.blocks):
        h = block.decode_paged_at(
            h, pool_k, pool_v, bt, rk, rv, i, r, sin_rows, cos_rows,
            pooled_len, paged_kernel=paged_kernel, pool_sk=pool_sk,
            pool_sv=pool_sv,
        )
    h = model.ln_f(h)
    return model.project(h)[:, 0, :], rk, rv


@torch.no_grad()
def verify_tokens_paged(
    model: GPT,
    tokens: torch.Tensor,  # [S, T] int candidate rows per decode slot
    start: torch.Tensor,  # [S] int32 position of row 0 (resident tokens)
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32
    rope_len: int,
    paged_kernel: str = "kernel",
    pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8 pool)
    pool_sv: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The speculative verify forward: every slot's ``T`` candidate rows
    (the true next token and the drafts) in one pass over the resident
    pages. Row ``j`` sits at position ``start + j`` (rope rows clamped to
    the table) and sees positions ``< start`` plus rows ``0..j``.
    Returns ``(logits [S, T, V]`` in the compute dtype, ``ks, vs)``: the
    rows' post-rope K / raw V ``[L, S, Hkv, T, C]`` for the masked page
    write, which lands only accepted rows (the rollback)."""
    cfg = model.config
    t = tokens.shape[1]
    sin_t, cos_t = _rope_table(cfg.head_dim, rope_len, cfg.rope_base,
                               tokens.device)
    ii = torch.arange(t, device=tokens.device)
    pos = (start.long()[:, None] + ii[None, :]).clamp(0, rope_len - 1)
    h = model.wte(tokens)  # [S, T, D]
    sin_rows = sin_t[pos][:, None].to(h.dtype)  # [S, 1, T, C//2]
    cos_rows = cos_t[pos][:, None].to(h.dtype)
    ks, vs = [], []
    for i, block in enumerate(model.blocks):
        h, k, v = block.verify_paged_at(
            h, pool_k, pool_v, bt, i, start, sin_rows, cos_rows,
            paged_kernel=paged_kernel, pool_sk=pool_sk, pool_sv=pool_sv,
        )
        ks.append(k)
        vs.append(v)
    h = model.ln_f(h)
    return model.project(h), stack_layers(ks), stack_layers(vs)


@torch.no_grad()
def prefill_chunk_paged(
    model: GPT,
    tokens: torch.Tensor,  # [1, T] int one prefill chunk (right-padded)
    start: torch.Tensor,  # [1] int32 position of chunk token 0
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS] read-only here
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [1, Pmax] int32 the slot's block table
    rope_len: int,
    pool_sk: tp.Optional[torch.Tensor] = None,  # [L, NP, Hkv] (int8 pool)
    pool_sv: tp.Optional[torch.Tensor] = None,
    *,
    resumed: bool,  # the shape class: start > 0
    sp: bool = False,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill one chunk of a prompt, positions ``start .. start+T-1``,
    against the slot's block table: each row attends to everything
    resident in the slot's pages (positions ``< start``: a prefix-cache
    hit, earlier chunks of the same prompt) and causally to the chunk, in
    one joint softmax per layer. A cache hit so computes only its suffix,
    and a long prompt resumes chunk by chunk, each token seeing what a
    one-pass prefill of the whole prompt shows it. Returns ``(h, ks,
    vs)``: final hidden states ``[1, T, D]`` and the per-layer post-rope K
    / raw V ``[L, 1, Hkv, T, C]`` for the page write (over an int8 pool,
    rounded to their pages' grids). Pad rows past the chunk's real length
    sit at later positions, so real rows never see them.

    ``start`` is an int32 ``[1]`` device tensor (a prefill program's
    input, read by no host code) and ``resumed`` (``start > 0``) its shape
    class. A resumed chunk reads the whole table with the columns ``>=
    start`` masked (JAX's form); a chunk at 0 reads no page.

    Under a tensor axis the pool arguments are tuples of the held shards'
    and so are ``ks``/``vs``. ``sp`` (the engine's ``prefill_sp``, JAX's
    ``sp=True``): the chunk's rows split over the tensor ranks through
    every segment the axis otherwise replicates (the embedding's output,
    the norms, the residual adds, ``ln_f``), gathered before each
    column-parallel product and reduce-scattered after each row-parallel
    one (``Block.prefill_paged_at``); the attention and the products are
    the ``sp=False`` arithmetic, and ``h`` comes back whole. ``T`` must
    divide over the axis."""
    cfg = model.config
    b, t = tokens.shape
    if b != 1:
        raise ValueError(f"prefill is per slot, got batch {b}")
    ex = model.tensor if sp else None
    if sp and ex is None:
        raise ValueError("prefill_chunk_paged(sp=True) needs a tensor axis")
    dev = tokens.device
    start = start.reshape(1)
    sin_t, cos_t = _rope_table(cfg.head_dim, rope_len, cfg.rope_base, dev)
    ii = torch.arange(t, device=dev)
    mask_self = torch.where(
        ii[None, :] <= ii[:, None], 0.0, -math.inf
    ).to(torch.float32)  # [T, T]
    mask_pool = None  # at start 0 no pool column is visible
    if resumed:  # every column of the table, visible below start
        cols = torch.arange(bt.shape[1] * as_shards(pool_k)[0].shape[-1],
                            device=dev)
        mask_pool = torch.where(cols < start, 0.0, -math.inf).to(
            torch.float32)
    pos = (start.long() + ii).clamp(0, rope_len - 1)  # the pad tail clips
    h = model.wte(tokens)  # [1, T, D]
    sin_rows = sin_t.index_select(0, pos).to(h.dtype)
    cos_rows = cos_t.index_select(0, pos).to(h.dtype)
    if ex is not None:
        h = held_rows(h, ex)  # the embedding's all-reduce, then row blocks
    ks, vs = [], []
    for i, block in enumerate(model.blocks):
        h, k, v = block.prefill_paged_at(
            h, pool_k, pool_v, bt, i, start, mask_pool, mask_self, sin_rows,
            cos_rows, pool_sk, pool_sv, sp=ex)
        ks.append(k)
        vs.append(v)
    h = (model.ln_f(h) if ex is None
         else gather_rows([model.ln_f(r) for r in h], ex))
    return h, stack_layers(ks), stack_layers(vs)
