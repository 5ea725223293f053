"""Decoder-only transformer (counterpart of ``midgpt_tpu.models.gpt``):
the training forward and the serving paths.

The block structure and arithmetic follow the JAX package: weightless
RMSNorm pre-norms, a packed QKV projection of width ``(H + 2 Hkv) C``
(GQA falls out of the same code), per-head QK-LayerNorm applied before
interleaved RoPE, GELU (tanh approximation, as ``jax.nn.gelu``) or
SwiGLU MLPs, a final RMSNorm with eps 1e-5, and an untied head that
shares the embedding's init.

Two attention choreographies, deliberately different and never mixed:

- decode (:meth:`Attention.decode_paged_at`, and the speculative verify
  :meth:`Attention.verify_paged_at`, through ``ops.paged_attn``): f32
  upcast multiply-sums, mask added, then a DIVISION by sqrt(C), f32
  probabilities through the value sums, one cast to the compute dtype at
  the end. Verify must mirror decode: acceptance compares its argmaxes
  with what the decode window would have drawn;
- prefill (:meth:`Attention.prefill_paged_at`): compute-dtype operands
  with f32 accumulation, mask added, then a MULTIPLICATION by
  ``1/sqrt(C)``, probabilities cast to the value dtype before PV.

The training forward (:meth:`GPT.hidden`, :meth:`GPT.forward`) routes
each layer's attention as the JAX package does (:meth:`Attention.
_use_fused`): the fused QK-LN + RoPE + attention of ``ops.fused_attn``
(hand-written CUDA kernels on the card) when no attention dropout is
drawn, else ``ops.attention``'s dispatch: the flash kernels of
``ops.flash`` on the card, the naive oracle on the CPU. Dropout sits
where the JAX model has it: the embeddings, the attention probabilities
(the kernels' counter-hash mask), the attention output after ``wo`` and
the MLP output. It is drawn only with ``deterministic=False`` and a key;
every mask is a function of a per-(layer, site) key derived from it (the
attention mask the kernels' counter hash of its seed, the others drawn
from a generator seeded with theirs), so ``remat="full"``, which
checkpoints each block, redraws the same masks.

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
"""

from __future__ import annotations

import functools
import math
import typing as tp

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
    int32_seed,
    rope_tables,
    split,
)
from midgpt_tpu_torch.ops.attention import attention
from midgpt_tpu_torch.ops.fused_attn import (
    fused_attention_qkv,
    rope_full_tables,
    supported,
)
from midgpt_tpu_torch.ops.paged_attn import (
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_verify_attention,
    paged_verify_attention_reference,
)
from midgpt_tpu_torch.quant import QuantLinear, round_kv_rows_to_grid
from midgpt_tpu_torch.utils.platform import resolve_device


def _split2(key: tp.Optional[int]):
    return (None, None) if key is None else tuple(split(key, 2))


def _round_rows(k, v, base, bt, pool_sk, pool_sv, layer, ps):
    """``k``/``v`` ``[S, Hkv, T, C]`` (positions ``base + j``) rounded
    through their pages' int8 grids, in their own dtype."""
    from midgpt_tpu_torch.serving.paged import kv_row_scales

    sk, sv = kv_row_scales(k, v, base, bt, pool_sk[layer], pool_sv[layer], ps)
    return round_kv_rows_to_grid(k, sk), round_kv_rows_to_grid(v, sv)


class KVGrid(tp.NamedTuple):
    """What a prompt's prefill needs of an int8 pool to round its rows:
    the slot's block table ``[Pmax]``, the scale planes ``[L, NP, Hkv]``
    and the page size."""

    bt: torch.Tensor
    scale_k: torch.Tensor
    scale_v: torch.Tensor
    page_size: int


def _gathered_pool_scales(pool_s, bt, layer):
    """The int8 pool's scales per slot and table entry, ``[S, Pmax, Hkv]``
    (pads clipped, as the gather clips them), for the kernels."""
    if pool_s is None:
        return None
    return pool_s[layer][bt.long().clamp(0, pool_s.shape[1] - 1)]


class Attention(nn.Module):
    """Causal self-attention with QK-norm + RoPE."""

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

    def _qkv(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
        """Project ``x [B, T, D]`` to q ``[B, H, T, C]`` and k/v
        ``[B, Hkv, T, C]``: QK-norm first, then RoPE at ``sin``/``cos``
        (broadcastable to ``[B, 1, T, C//2]``)."""
        b, t, d = x.shape
        h, hkv = self.n_head, self.n_kv_head
        c = d // h
        qkv = self.wqkv(x)
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
        return self.wo.weight.shape[0] // self.n_head

    def forward(self, x: torch.Tensor, rope: RopeTables,
                impl: str = "naive",
                key: tp.Optional[int] = None) -> torch.Tensor:
        """Causal self-attention over whole sequences ``x [B, T, D]``
        with the rope tables of ``T`` positions; with a ``key``, dropout
        on the probabilities and the output."""
        b, t, _ = x.shape
        adrop_key, pdrop_key = _split2(key)
        if impl == "fused" and self.q_norm is None:
            impl = "auto"  # the kernel needs QK-norm; same math either way
        drops = key is not None and self.dropout_rate > 0.0
        if self._use_fused(impl, t, x.device, drops):
            out = self._fused_call(x, rope)
        else:
            q, k, v = self._qkv(x, rope.sin, rope.cos)
            out = attention(
                q, k, v, impl=impl, dropout_rate=self.dropout_rate,
                seed=None if adrop_key is None else int32_seed(adrop_key))
            out = self.wo(out.transpose(1, 2).reshape(b, t, -1))
        return dropout(out, self.dropout_rate, pdrop_key)

    def _use_fused(self, impl: str, t: int, device: torch.device,
                   drops: bool = False) -> bool:
        """Route to the fused kernels (``ops.fused_attn``). ``"fused"``
        forces them (the plain versions on the CPU); ``"auto"`` takes them
        for CUDA tensors, as the JAX package takes them on the TPU, when
        the shape suits them and no attention dropout is drawn
        (``drops``); otherwise ``ops.attention`` dispatches (the flash
        kernels on the card)."""
        if impl not in ("fused", "auto"):
            return False
        shape_ok = (
            self.q_norm is not None
            and supported(self.n_head, self.n_kv_head, self.head_dim)
            and t >= 128 and t % 128 == 0
            and not drops
        )
        if impl == "fused":
            if not shape_ok:
                raise ValueError(
                    "attn_impl='fused' requires qk-norm, T % 128 == 0, "
                    "T >= 128, no attention dropout and a supported head "
                    "shape (C % 128 == 0, or C == 64 with MHA)")
            return True
        return device.type == "cuda" and shape_ok

    def _fused_call(self, x: torch.Tensor, rope: RopeTables) -> torch.Tensor:
        out = fused_attention_qkv(
            self.wqkv(x), self.q_norm.weight, self.k_norm.weight,
            rope.sin_full, rope.cos_full, self.n_head, self.n_kv_head,
            self.q_norm.eps)
        return self.wo(out)

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
        plain version directly, on any device, for comparisons."""
        s = x.shape[0]
        h, hkv = self.n_head, self.n_kv_head
        c = x.shape[-1] // h
        q, k, v = self._qkv(x, sin_rows, cos_rows)  # [S, H|Hkv, 1, C]
        if pool_sk is not None:
            # the recent rows in compute dtype with this row written in:
            # an earlier in-window birth row is read back already rounded
            # (derivation is rounding-stable)
            tmp_k = rk[layer].to(k.dtype, copy=True)
            tmp_v = rv[layer].to(v.dtype, copy=True)
            tmp_k[:, :, r] = k[:, :, 0]
            tmp_v[:, :, r] = v[:, :, 0]
            tmp_k, tmp_v = _round_rows(tmp_k, tmp_v, pooled_len, bt, pool_sk,
                                       pool_sv, layer, pool_k.shape[-1])
            k, v = tmp_k[:, :, r : r + 1], tmp_v[:, :, r : r + 1]
        rk[layer, :, :, r] = k[:, :, 0].to(rk.dtype)
        rv[layer, :, :, r] = v[:, :, 0].to(rv.dtype)
        qs = q.reshape(s, hkv, h // hkv, c)
        if paged_kernel == "kernel":
            attn = paged_decode_attention
        elif paged_kernel == "reference":
            attn = paged_decode_attention_reference
        else:
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")
        out = attn(qs, pool_k, pool_v, bt, pooled_len, rk[layer], rv[layer],
                   r, layer, _gathered_pool_scales(pool_sk, bt, layer),
                   _gathered_pool_scales(pool_sv, bt, layer))  # [S, Hkv, G, C]
        return self.wo(out.reshape(s, 1, h * c))

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
        ``[S, Hkv, T, C]`` in the compute dtype for the page write.
        ``paged_kernel`` as in :meth:`decode_paged_at`."""
        s, t, d = x.shape
        h, hkv = self.n_head, self.n_kv_head
        c = d // h
        q, k, v = self._qkv(x, sin_rows, cos_rows)  # [S, H|Hkv, T, C]
        row_dtype = pool_k.dtype
        if pool_sk is not None:
            k, v = _round_rows(k, v, start, bt, pool_sk, pool_sv, layer,
                               pool_k.shape[-1])
            row_dtype = torch.bfloat16  # the int8 pool's row dtype
        qg = q.reshape(s, hkv, h // hkv, t, c).contiguous()
        kc = k.to(row_dtype).contiguous()
        vc = v.to(row_dtype).contiguous()
        if paged_kernel == "kernel":
            attn = paged_verify_attention
        elif paged_kernel == "reference":
            attn = paged_verify_attention_reference
        else:
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")
        out = attn(qg, kc, vc, pool_k, pool_v, bt, start, layer,
                   _gathered_pool_scales(pool_sk, bt, layer),
                   _gathered_pool_scales(pool_sv, bt, layer))
        out = out.reshape(s, h, t, c).transpose(1, 2).reshape(s, t, h * c)
        return self.wo(out), k, v

    def prefill_paged_at(
        self,
        x: torch.Tensor,  # [1, T, D] the prompt's hidden states, from position 0
        mask_self: torch.Tensor,  # [T, T] additive causal f32
        sin_rows: torch.Tensor,  # [T, C//2] rope rows at positions 0..T-1
        cos_rows: torch.Tensor,
        kv_grid: tp.Optional[KVGrid] = None,
        layer: int = 0,
    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Causal multi-query attention of a fresh prompt over itself.
        Returns ``(out, k, v)``, k/v ``[1, Hkv, T, C]`` for the page
        write. The JAX version also reads the slot's resident pages for
        chunks at ``start > 0``; at ``start == 0`` every pool column is
        masked and contributes exactly zero, so monolithic prefill (the
        only prefill of this engine) leaves the pool part out. With an
        int8 pool's ``kv_grid`` the prompt's K/V rows are rounded through
        their pages' grids (base 0) before the self-attention reads
        them."""
        b, t, d = x.shape
        h, hkv = self.n_head, self.n_kv_head
        c = d // h
        q, k, v = self._qkv(x, sin_rows, cos_rows)
        if kv_grid is not None:
            base = torch.zeros(1, dtype=torch.int32, device=x.device)
            k, v = _round_rows(k, v, base, kv_grid.bt[None], kv_grid.scale_k,
                               kv_grid.scale_v, layer, kv_grid.page_size)
        f32 = torch.float32
        qg = q.reshape(b, hkv, h // hkv, t, c)
        # compute-dtype operands, f32 accumulation: the exact products of
        # the upcast operands summed in f32
        s_self = qg.to(f32) @ k[:, :, None].to(f32).transpose(-1, -2)
        scale = 1.0 / torch.sqrt(torch.tensor(c, dtype=f32))
        probs = torch.softmax((s_self + mask_self) * scale.to(x.device),
                              dim=-1).to(v.dtype)
        o = probs @ v[:, :, None]  # [1, Hkv, G, T, C]
        out = o.reshape(b, h, t, c).transpose(1, 2).reshape(b, t, h * c)
        return self.wo(out.to(x.dtype)), k, v


def mlp_hidden_dim(cfg: ModelConfig) -> int:
    """MLP hidden width; fractional ratios round up to a multiple of 256."""
    if cfg.mlp_hidden is not None:
        return cfg.mlp_hidden
    f = cfg.mlp_ratio * cfg.n_embd
    if f == int(f):
        return int(f)
    return 256 * -(-int(f) // 256)


class MLP(nn.Module):
    """GELU (tanh approximation) or SwiGLU MLP."""

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
                key: tp.Optional[int] = None) -> torch.Tensor:
        up = self.w_up(x)
        if self.w_gate is not None:
            hidden = F.silu(self.w_gate(x)) * up
        else:
            hidden = F.gelu(up, approximate="tanh")
        return dropout(self.w_down(hidden), self.dropout_rate, key)


class Block(nn.Module):
    """Pre-norm residual block."""

    def __init__(self, attn: Attention, mlp: MLP, d: int,
                 norm_impl: str = "auto"):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1 = RMSNorm(d, use_weight=False, impl=norm_impl)
        self.ln2 = RMSNorm(d, use_weight=False, impl=norm_impl)

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "Block":
        return Block(Attention.init(cfg, generator), MLP.init(cfg, generator),
                     cfg.n_embd, cfg.norm_impl)

    def forward(self, x: torch.Tensor, rope: RopeTables,
                impl: str = "naive",
                key: tp.Optional[int] = None) -> torch.Tensor:
        attn_key, mlp_key = _split2(key)
        x = x + self.attn(self.ln1(x), rope, impl, attn_key)
        return x + self.mlp(self.ln2(x), mlp_key)

    def decode_paged_at(self, x, pool_k, pool_v, bt, rk, rv, layer, r,
                        sin_rows, cos_rows, pooled_len, paged_kernel="kernel",
                        pool_sk=None, pool_sv=None):
        x = x + self.attn.decode_paged_at(
            self.ln1(x), pool_k, pool_v, bt, rk, rv, layer, r, sin_rows,
            cos_rows, pooled_len, paged_kernel=paged_kernel, pool_sk=pool_sk,
            pool_sv=pool_sv,
        )
        return x + self.mlp(self.ln2(x))

    def verify_paged_at(self, x, pool_k, pool_v, bt, layer, start, sin_rows,
                        cos_rows, paged_kernel="kernel", pool_sk=None,
                        pool_sv=None):
        attn_out, k, v = self.attn.verify_paged_at(
            self.ln1(x), pool_k, pool_v, bt, layer, start, sin_rows,
            cos_rows, paged_kernel=paged_kernel, pool_sk=pool_sk,
            pool_sv=pool_sv,
        )
        x = x + attn_out
        return x + self.mlp(self.ln2(x)), k, v

    def prefill_paged_at(self, x, mask_self, sin_rows, cos_rows,
                         kv_grid=None, layer=0):
        attn_out, k, v = self.attn.prefill_paged_at(
            self.ln1(x), mask_self, sin_rows, cos_rows, kv_grid, layer,
        )
        x = x + attn_out
        return x + self.mlp(self.ln2(x)), k, v


class GPT(nn.Module):
    """The full model; ``blocks`` is a list of per-layer modules."""

    def __init__(self, cfg: ModelConfig, wte: Embedding,
                 blocks: tp.Sequence[Block], lm_head: tp.Optional[Linear]):
        super().__init__()
        self.config = cfg
        self.wte = wte
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = RMSNorm(cfg.n_embd, use_weight=False, eps=1e-5,
                            impl=cfg.norm_impl)
        self.lm_head = lm_head

    @staticmethod
    def init(
        cfg: ModelConfig,
        generator: tp.Optional[torch.Generator] = None,
        device: tp.Union[None, str, torch.device] = None,
        dtype: torch.dtype = torch.float32,
    ) -> "GPT":
        """Random init with the JAX package's distributions: truncated
        normal linears scaled ``1/sqrt(fan_in)``, an ``N(0, 1/D)``
        embedding, and an untied head initialized to the embedding's
        transpose. Drawn on the CPU from ``generator`` (so a seed gives
        the same weights on every device), then moved to ``device``
        (the card unless the caller asks for the CPU) in ``dtype``."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        blocks = [Block.init(cfg, generator) for _ in range(cfg.n_layer)]
        wte = Embedding.init(
            cfg.vocab_size, cfg.n_embd, 1 / math.sqrt(cfg.n_embd), generator
        )
        lm_head = (
            None if cfg.tie_embeddings
            else Linear(wte.weight.detach().t().contiguous())
        )
        return GPT(cfg, wte, blocks, lm_head).to(device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wte.weight.dtype

    def head_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """``[D, V]`` lm-head weight in ``dtype``; full-precision heads
        only (a quantized head's scale belongs in the product: use
        :meth:`project`)."""
        if isinstance(self.lm_head, QuantLinear):
            raise ValueError("quantized head: use GPT.project, which keeps "
                             "the int8 weight and its scale epilogue")
        if self.lm_head is None:
            return self.wte.weight.t().to(dtype)
        return self.lm_head.weight.to(dtype)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states ``[..., D]`` -> vocab logits ``[..., V]``: the one
        head entry point (``(h @ w_int8) * scale`` for a quantized head)."""
        if isinstance(self.lm_head, QuantLinear):
            return self.lm_head(h)
        return h @ self.head_weight(h.dtype)

    def hidden(self, tokens: torch.Tensor,
               attn_impl: tp.Optional[str] = None,
               key: tp.Optional[int] = None,
               deterministic: bool = True) -> torch.Tensor:
        """``[B, T, D]`` final (``ln_f``-normalized) hidden states of
        ``tokens [B, T]``, in the model's dtype. With ``deterministic``
        False and ``cfg.dropout > 0``, dropout is drawn from ``key`` (an
        int; none without one), split as the JAX model splits its PRNG
        key: one key for the embeddings, one per block, and within a block
        one per site."""
        cfg = self.config
        impl = attn_impl if attn_impl is not None else cfg.attn_impl
        t = tokens.shape[1]
        if t > cfg.block_size:
            raise ValueError(f"sequence {t} > block_size {cfg.block_size}")
        if cfg.remat not in ("none", "full", "auto"):
            # "auto" reaching the model means no trainer resolved it: with
            # or without gradients it behaves as "none", as in the JAX
            # package; "dots" (save the matmuls) is not ported
            raise ValueError(f"remat={cfg.remat!r} is not supported by the "
                             f"port (none | full | auto)")
        rope = _rope_tables_full(cfg.head_dim, t, cfg.rope_base,
                                 tokens.device)
        drop_key, block_keys = None, [None] * cfg.n_layer
        if key is not None and not deterministic:
            drop_key, block_key = split(key, 2)
            block_keys = split(block_key, cfg.n_layer)
        h = dropout(self.wte(tokens), cfg.dropout, drop_key)
        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for block, bkey in zip(self.blocks, block_keys):
            if remat:
                # the block's masks are functions of bkey: the recompute
                # draws the same ones
                h = torch.utils.checkpoint.checkpoint(
                    block, h, rope, impl, bkey, use_reentrant=False)
            else:
                h = block(h, rope, impl, bkey)
        return self.ln_f(h)

    def forward(self, tokens: torch.Tensor,
                attn_impl: tp.Optional[str] = None,
                key: tp.Optional[int] = None,
                deterministic: bool = True) -> torch.Tensor:
        """``[B, T, V]`` logits in the model's dtype."""
        return self.project(self.hidden(tokens, attn_impl, key,
                                        deterministic))


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
    return model.project(h), torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def prefill_chunk_paged(
    model: GPT,
    tokens: torch.Tensor,  # [1, T] int a whole prompt (right-padded)
    rope_len: int,
    kv_grid: tp.Optional[KVGrid] = None,  # an int8 pool's grid
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a fresh prompt from position 0 in one pass (the JAX
    function at ``start == 0``). Returns ``(h, ks, vs)``: final hidden
    states ``[1, T, D]`` and the per-layer post-rope K / raw V
    ``[L, 1, Hkv, T, C]`` for the page write (over an int8 pool,
    rounded to their pages' grids). Pad rows past the prompt's
    real length sit at later positions, so real rows never see them.
    Chunks that start past 0 and read resident pages come with chunked
    prefill."""
    cfg = model.config
    b, t = tokens.shape
    if b != 1:
        raise ValueError(f"prefill is per slot, got batch {b}")
    sin_t, cos_t = _rope_table(cfg.head_dim, rope_len, cfg.rope_base,
                               tokens.device)
    ii = torch.arange(t, device=tokens.device)
    mask_self = torch.where(
        ii[None, :] <= ii[:, None], 0.0, -math.inf
    ).to(torch.float32)  # [T, T]
    pos = ii.clamp(0, rope_len - 1)
    h = model.wte(tokens)  # [1, T, D]
    sin_rows, cos_rows = sin_t[pos].to(h.dtype), cos_t[pos].to(h.dtype)
    ks, vs = [], []
    for i, block in enumerate(model.blocks):
        h, k, v = block.prefill_paged_at(h, mask_self, sin_rows, cos_rows,
                                         kv_grid, i)
        ks.append(k)
        vs.append(v)
    return model.ln_f(h), torch.stack(ks), torch.stack(vs)
