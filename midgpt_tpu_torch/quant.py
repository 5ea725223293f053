"""Int8 serving: per-output-channel int8 weights and the int8 KV grid
(counterpart of ``midgpt_tpu.quant``).

Weights. A :class:`QuantLinear` holds ``weight`` (int8, stored
``[in, out]`` like :class:`~midgpt_tpu_torch.models.layers.Linear`) and
``scale`` (f32, one per OUTPUT channel). Its forward is ``(x @ w_int8) *
scale``: the dequantization lands on the activation-shaped result. With
``mode="po2"`` (the default) every scale is a power of two, so ``q *
scale`` is exact in f32 and bf16 and the epilogue form is bitwise ``x @
dequantize(q, scale)``: the quantized engine is greedy token-identical to
the engine running :func:`dequantize_model` of the same model. Every
dense matmul of the serving path quantizes (``wqkv``, ``wo``, ``w_up``,
``w_gate``, ``w_down`` and the head, materialized from the embedding when
tied); the embedding gather and the norms stay full precision.

The product is ``ops.int8_matmul``: on the card a hand-written kernel
that reads the int8 codes and applies the scale in its epilogue, as XLA
fuses the convert into the dot; eager ``w_int8.to(x.dtype)`` would write a
full-precision copy of the weight first. A cached dequantized copy would
keep a full-precision model resident and is not kept.

KV grid. An int8 KV pool holds one f32 power-of-two scale per (page, KV
head), fixed at PAGE BIRTH from the page's first row, and every in-dispatch
reader sees rows rounded through that grid. A grid value survives
quantize -> dequantize bitwise, so an int8 pool behaves like a bf16 pool
whose values lie on the grid. Scale derivation is rounding-stable: a row
already rounded to its own grid re-derives the same scale, which is what
lets every write path re-derive scales from the rows it receives. The
powers of two are assembled from IEEE bit fields (``view(torch.int32)``,
shifts, masks), never from ``exp2``/``log2``, which are approximate at
the exact power-of-two boundaries the stability argument rests on.
"""

from __future__ import annotations

import functools
import typing as tp

import torch
from torch import nn

from midgpt_tpu_torch.models.layers import Linear
from midgpt_tpu_torch.ops.int8_matmul import int8_matmul

QUANT_MODES = ("po2", "absmax", "identity")

KV_QMAX = 127.0
# the birth row's codes stay <= 63: one power of two of headroom for the
# later rows that share the page's scale, and the margin that keeps scale
# derivation rounding-stable (a rounded birth row's absmax lands strictly
# inside the same po2-ceil bucket)
KV_BIRTH_QMAX = 63.0
# the smallest normal f32 power of two: subnormal scales would make grid
# products depend on a backend's flush-to-zero behaviour
KV_SCALE_MIN = 2.0**-126


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with subnormal values set to zero. The JAX package's backends
    (XLA on the CPU, the TPU) treat subnormal operands as zero; PyTorch
    keeps them. An absmax goes through this before it picks a branch, so
    that a subnormal channel or row takes the all-zero branch (scale 1,
    codes 0) on every device, as it does there."""
    return torch.where(x.abs() >= KV_SCALE_MIN, x, torch.zeros_like(x))


class QuantLinear(nn.Module):
    """Bias-free linear over an int8 weight ``[in, out]`` with one f32
    scale per output channel; ``(x @ w_int8) * scale``. Weight and scale
    are buffers (serving only, never trained). A dtype cast of the model
    leaves both as they are: the codes are integers and the scales stay
    f32, as the JAX pytree keeps them."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        if weight.dtype != torch.int8 or weight.dim() != 2:
            raise ValueError(f"weight must be int8 [in, out], got "
                             f"{weight.dtype} {tuple(weight.shape)}")
        if scale.shape != weight.shape[-1:]:
            raise ValueError(f"scale {tuple(scale.shape)} must be [out] = "
                             f"[{weight.shape[-1]}]")
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale.to(torch.float32))

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        self.scale = scale.to(self.weight.device)  # moved, never cast
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.weight, self.scale)

    def held(self, j: int, n: int, dim: int) -> tp.Callable:
        """Held tensor shard ``j`` of ``n``'s product (the module itself
        for one): the codes of the ``n`` held shards lie stacked along
        rows (:func:`shard_quant_linear`), so shard ``j``'s are one
        contiguous block, which the kernel needs. A column-parallel
        shard (``dim=-1``) takes its columns' scales; a row-parallel one
        (``dim=-2``) the whole scale, in its epilogue: with po2 scales
        ``sum_j (x_j @ q_j) * s`` is ``(sum_j x_j @ q_j) * s`` bit for
        bit (a product by a power of two is exact and commutes with the
        rounding of the sum), JAX's order, at one launch a rank."""
        if n == 1:
            return self
        codes = self.weight.chunk(n, 0)[j]
        scale = self.scale.chunk(n, -1)[j] if dim == -1 else self.scale
        return functools.partial(int8_matmul, codes=codes, scale=scale)


@torch.no_grad()
def shard_quant_linear(lin: QuantLinear, name: str, held: tp.Sequence[int],
                       size: int, cfg) -> None:
    """Keep only tensor indices ``held``'s shards of ``lin`` (named
    ``name + ".weight"`` / ``".scale"`` in the model), in place: the
    codes cut as ``parallel.sharding.tensor_shard`` cuts a weight (a
    packed ``wqkv``'s per rank heads) and the shards stacked along rows
    (:meth:`QuantLinear.held`), the scales of a column-parallel weight cut
    with its columns, a row-parallel weight's kept whole. The codes are
    the unsharded model's, bit for bit: quantize first, then cut."""
    from midgpt_tpu_torch.parallel.sharding import tensor_dim, tensor_shard

    wname, sname = name + ".weight", name + ".scale"
    if tensor_dim(wname) is None or size == 1:
        return
    pieces = [tensor_shard(wname, lin.weight, (r,), size, cfg)
              for r in held]
    lin.weight = torch.cat(pieces, 0) if len(pieces) > 1 else \
        pieces[0].clone(memory_format=torch.contiguous_format)
    if tensor_dim(sname) is not None:
        lin.scale = tensor_shard(sname, lin.scale, held, size, cfg).clone(
            memory_format=torch.contiguous_format)


def _pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 ``2**e`` from an integer exponent, assembled from IEEE
    bit fields: normal range [-126, 127] sets the exponent field, [-149,
    -127] the matching subnormal mantissa bit; past either end the f32
    value is inf / 0."""
    e = e.to(torch.int32)
    normal = (e.clamp(-126, 128) + 127) << 23  # 128 -> biased 255: inf
    sub = torch.ones_like(e) << (e + 149).clamp(0, 23)
    bits = torch.where(e >= -126, normal,
                       torch.where(e >= -149, sub, torch.zeros_like(e)))
    return bits.view(torch.float32)


def po2_ceil_exact(y: torch.Tensor) -> torch.Tensor:
    """Smallest power of two ``>= y`` (y > 0), bitwise on every backend.
    ``y = mant * 2^k`` with the integer ``mant`` in [1, 2^24) read from
    the bit fields (normals get the implicit bit, subnormals are already
    that form); ``mant``'s own exponent field then gives frexp's ``e``,
    and its mantissa field is zero exactly when ``mant`` is a power of
    two (frexp's ``m == 0.5``)."""
    bits = y.to(torch.float32).view(torch.int32)  # y > 0: sign bit 0
    expf = bits >> 23
    mant = bits & 0x7FFFFF
    mant_full = torch.where(expf > 0, mant | (1 << 23), mant)
    k = torch.where(expf > 0, expf - 150, torch.full_like(expf, -149))
    mbits = mant_full.to(torch.float32).view(torch.int32)  # exact: < 2^24
    e_mant = torch.where(mant_full == 0, torch.zeros_like(expf),
                         (mbits >> 23) - 126)  # frexp(0) = (0, 0)
    exact_po2 = (mant_full != 0) & ((mbits & 0x7FFFFF) == 0)
    e = e_mant + k
    return torch.where(exact_po2, _pow2_f32(e - 1), _pow2_f32(e))


def quantize_per_channel(
    w: torch.Tensor, *, mode: str = "po2"
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w [..., in, out]`` to int8 with one scale per output
    channel (reduced over ``in``). Returns ``(q int8, scale f32)``; all-zero
    channels take scale 1. ``po2`` rounds the absmax/127 scale up to a
    power of two, ``absmax`` keeps it fractional, ``identity`` pins 1."""
    if mode not in QUANT_MODES:
        raise ValueError(f"mode {mode!r} not in {QUANT_MODES}")
    w32 = w.to(torch.float32)
    if w32.dim() < 2:
        raise ValueError(f"need [..., in, out], got {tuple(w32.shape)}")
    if mode == "identity":
        scale = torch.ones(w32.shape[:-2] + w32.shape[-1:],
                           dtype=torch.float32, device=w32.device)
    else:
        absmax = _flush_subnormal(w32.abs().amax(dim=-2))  # [..., out]
        one = torch.ones_like(absmax)
        scale = torch.where(absmax > 0.0, absmax / 127.0, one)
        if mode == "po2":
            scale = torch.where(absmax > 0.0, po2_ceil_exact(scale), one)
    q = torch.round(w32 / scale[..., None, :]).clamp(-127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q int8 [..., in, out]`` x ``scale [..., out]`` -> f32 weights
    (exact for po2 and identity scales)."""
    return q.to(torch.float32) * scale[..., None, :]


def kv_scale_from_absmax(absmax: torch.Tensor) -> torch.Tensor:
    """Per-(page, KV head) po2 scale from a birth row's absmax over C:
    the smallest po2 ``>= absmax / 63``, floored at ``KV_SCALE_MIN``;
    1.0 for a row whose absmax rounds to code 0 even on the floored grid
    (a zero or subnormal absmax, see :func:`_flush_subnormal`), so that
    re-deriving from its rounded (all zero) row returns the same scale.
    The po2 ceiling is the exponent-field round-up ``(bits + 0x7FFFFF) &
    0x7F800000``: :func:`po2_ceil_exact` for a normal input, and at most
    ``KV_SCALE_MIN`` for a subnormal one, where the floor puts
    ``po2_ceil_exact``'s answer too; a handful of ops on the decode
    step's host path. f32 in, f32 out."""
    am = absmax.to(torch.float32)
    bits = (am / KV_BIRTH_QMAX).view(torch.int32)
    sc = ((bits + 0x7FFFFF) & 0x7F800000).view(torch.float32)
    sc = torch.clamp_min(sc, KV_SCALE_MIN)
    return torch.where(am >= KV_SCALE_MIN, sc, 1.0)


def quantize_kv_rows(rows: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """``rows [..., C]`` x ``scales [...]`` -> int8 codes; exact when the
    rows are already on the grid."""
    q = torch.round(rows.to(torch.float32) / scales[..., None])
    return q.clamp(-KV_QMAX, KV_QMAX).to(torch.int8)


def round_kv_rows_to_grid(rows: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Round K/V rows through their page's int8 grid, in the rows' dtype:
    ``round(row / s) * s`` with ``|code| <= 127`` and a po2 ``s`` is exact
    in bf16 and f32, so the result is bitwise what a later pool read
    dequantizes to."""
    q = torch.round(rows.to(torch.float32) / scales[..., None])
    q = q.clamp(-KV_QMAX, KV_QMAX)
    return (q * scales[..., None]).to(rows.dtype)


def quantize_linear(lin: Linear, *, mode: str = "po2") -> QuantLinear:
    return QuantLinear(*quantize_per_channel(lin.weight.detach(), mode=mode))


def dequantize_linear(qlin: QuantLinear) -> Linear:
    return Linear(dequantize(qlin.weight, qlin.scale))


def is_quantized(model) -> bool:
    return isinstance(model.lm_head, QuantLinear)


def _rebuilt(model, convert):
    """A new GPT whose projections are ``convert``'s results; the
    embedding, the norms and the config are shared with ``model``."""
    from midgpt_tpu_torch.models.gpt import GPT, MLP, Attention, Block

    blocks = []
    for blk in model.blocks:
        a, m = blk.attn, blk.mlp
        attn = Attention(convert(a.wqkv), convert(a.wo), a.q_norm, a.k_norm,
                         a.n_head, a.n_kv_head, a.dropout_rate)
        mlp = MLP(convert(m.w_up), convert(m.w_down),
                  convert(m.w_gate) if m.w_gate is not None else None,
                  m.dropout_rate)
        blocks.append(Block(attn, mlp, model.config.n_embd,
                            model.config.norm_impl))
    head = model.lm_head
    if head is None:  # tied: the head matmul still streams int8
        head = Linear(model.wte.weight.detach().t())
    return GPT(model.config, model.wte, blocks, convert(head))


@torch.no_grad()
def quantize_model(model, *, mode: str = "po2"):
    """The int8 serving form of ``model`` (a new GPT; ``model`` is left as
    it is): every dense matmul weight becomes a :class:`QuantLinear`, and
    the head is always materialized quantized (from ``wte.weight.T`` when
    tied)."""
    if is_quantized(model):
        raise ValueError("model is already quantized")
    if model.config.mlp == "moe":
        raise ValueError("int8 serving quantization covers the dense "
                         "configs; MoE expert stacks are not Linear layers")
    return _rebuilt(model, lambda lin: quantize_linear(lin, mode=mode))


@torch.no_grad()
def dequantize_model(qmodel):
    """The full-precision model the quantized one encodes: every
    QuantLinear becomes a plain Linear holding ``dequantize(w, scale)``.
    With po2 scales, serving this model is greedy token-identical to
    serving ``qmodel``."""
    if not is_quantized(qmodel):
        raise ValueError("model is not quantized")
    # in the model's dtype, which PyTorch's matmul needs (JAX promotes);
    # exact for po2 scales in bf16 too
    return _rebuilt(qmodel, lambda q: Linear(
        dequantize(q.weight, q.scale).to(qmodel.dtype)))
