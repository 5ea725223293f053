"""Decoder-only transformer for serving (counterpart of
``midgpt_tpu.models.gpt``'s serving paths).

The block structure and arithmetic follow the JAX package: weightless
RMSNorm pre-norms, a packed QKV projection of width ``(H + 2 Hkv) C``
(GQA falls out of the same code), per-head QK-LayerNorm applied before
interleaved RoPE, GELU (tanh approximation, as ``jax.nn.gelu``) or
SwiGLU MLPs, a final RMSNorm with eps 1e-5, and an untied head that
shares the embedding's init.

Two attention choreographies, deliberately different and never mixed:

- decode (:meth:`Attention.decode_paged_at`, through
  ``ops.paged_attn``): f32 upcast multiply-sums, mask added, then a
  DIVISION by sqrt(C), f32 probabilities through the value sums, one
  cast to the compute dtype at the end;
- prefill (:meth:`Attention.prefill_paged_at`): compute-dtype operands
  with f32 accumulation, mask added, then a MULTIPLICATION by
  ``1/sqrt(C)``, probabilities cast to the value dtype before PV.

Layers run unrolled (a Python loop over ``GPT.blocks``); the pool is
read-only inside a decode window, and K/V rows land in pages through
``serving.paged`` at window and prefill boundaries.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.layers import (
    Embedding,
    LayerNorm,
    Linear,
    RMSNorm,
    apply_rotary,
    rope_tables,
)
from midgpt_tpu_torch.ops.paged_attn import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from midgpt_tpu_torch.utils.platform import resolve_device


class Attention(nn.Module):
    """Causal self-attention with QK-norm + RoPE."""

    def __init__(self, wqkv: Linear, wo: Linear,
                 q_norm: tp.Optional[LayerNorm],
                 k_norm: tp.Optional[LayerNorm], n_head: int,
                 n_kv_head: int):
        super().__init__()
        self.wqkv, self.wo = wqkv, wo
        self.q_norm, self.k_norm = q_norm, k_norm
        self.n_head, self.n_kv_head = n_head, n_kv_head

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
    ) -> torch.Tensor:
        """Single-token attention over the paged pool plus the window's
        recent rows. This step's K/V row lands in recent row ``r``
        before the attention reads it. ``paged_kernel="kernel"`` goes
        through ``ops.paged_attn.paged_decode_attention`` (the CUDA
        kernel on the card, its plain version on the CPU);
        ``"reference"`` calls the plain version directly, on any
        device, for comparisons."""
        s = x.shape[0]
        h, hkv = self.n_head, self.n_kv_head
        c = x.shape[-1] // h
        q, k, v = self._qkv(x, sin_rows, cos_rows)  # [S, H|Hkv, 1, C]
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
                   r, layer)  # [S, Hkv, G, C]
        return self.wo(out.reshape(s, 1, h * c))

    def prefill_paged_at(
        self,
        x: torch.Tensor,  # [1, T, D] the prompt's hidden states, from position 0
        mask_self: torch.Tensor,  # [T, T] additive causal f32
        sin_rows: torch.Tensor,  # [T, C//2] rope rows at positions 0..T-1
        cos_rows: torch.Tensor,
    ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Causal multi-query attention of a fresh prompt over itself.
        Returns ``(out, k, v)``, k/v ``[1, Hkv, T, C]`` for the page
        write. The JAX version also reads the slot's resident pages for
        chunks at ``start > 0``; at ``start == 0`` every pool column is
        masked and contributes exactly zero, so monolithic prefill (the
        only prefill of this engine) leaves the pool part out."""
        b, t, d = x.shape
        h, hkv = self.n_head, self.n_kv_head
        c = d // h
        q, k, v = self._qkv(x, sin_rows, cos_rows)
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
                 w_gate: tp.Optional[Linear]):
        super().__init__()
        self.w_up, self.w_down, self.w_gate = w_up, w_down, w_gate

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
        return MLP(w_up, w_down, w_gate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.w_up(x)
        if self.w_gate is not None:
            hidden = F.silu(self.w_gate(x)) * up
        else:
            hidden = F.gelu(up, approximate="tanh")
        return self.w_down(hidden)


class Block(nn.Module):
    """Pre-norm residual block."""

    def __init__(self, attn: Attention, mlp: MLP, d: int):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1 = RMSNorm(d, use_weight=False)
        self.ln2 = RMSNorm(d, use_weight=False)

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator) -> "Block":
        return Block(Attention.init(cfg, generator), MLP.init(cfg, generator),
                     cfg.n_embd)

    def decode_paged_at(self, x, pool_k, pool_v, bt, rk, rv, layer, r,
                        sin_rows, cos_rows, pooled_len, paged_kernel="kernel"):
        x = x + self.attn.decode_paged_at(
            self.ln1(x), pool_k, pool_v, bt, rk, rv, layer, r, sin_rows,
            cos_rows, pooled_len, paged_kernel=paged_kernel,
        )
        return x + self.mlp(self.ln2(x))

    def prefill_paged_at(self, x, mask_self, sin_rows, cos_rows):
        attn_out, k, v = self.attn.prefill_paged_at(
            self.ln1(x), mask_self, sin_rows, cos_rows,
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
        self.ln_f = RMSNorm(cfg.n_embd, use_weight=False, eps=1e-5)
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
        """``[D, V]`` lm-head weight in ``dtype``."""
        if self.lm_head is None:
            return self.wte.weight.t().to(dtype)
        return self.lm_head.weight.to(dtype)

    def project(self, h: torch.Tensor) -> torch.Tensor:
        """Hidden states ``[..., D]`` -> vocab logits ``[..., V]``."""
        return h @ self.head_weight(h.dtype)


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, length: int, base: float,
                device: torch.device) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """f32 rope tables ``[length, C//2]`` on ``device``."""
    sin, cos = rope_tables(head_dim, length, base)
    return (torch.from_numpy(sin).float().to(device),
            torch.from_numpy(cos).float().to(device))


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
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every slot: each attends over its own pages
    (positions ``< pooled_len``) plus the recent rows ``0..r``, and
    appends its K/V to recent row ``r``. Returns ``(logits [S, V]`` in the
    compute dtype``, rk, rv)``."""
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
            pooled_len, paged_kernel=paged_kernel,
        )
    h = model.ln_f(h)
    return model.project(h)[:, 0, :], rk, rv


def prefill_chunk_paged(
    model: GPT,
    tokens: torch.Tensor,  # [1, T] int a whole prompt (right-padded)
    rope_len: int,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a fresh prompt from position 0 in one pass (the JAX
    function at ``start == 0``). Returns ``(h, ks, vs)``: final hidden
    states ``[1, T, D]`` and the per-layer post-rope K / raw V
    ``[L, 1, Hkv, T, C]`` for the page write. Pad rows past the prompt's
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
    for block in model.blocks:
        h, k, v = block.prefill_paged_at(h, mask_self, sin_rows, cos_rows)
        ks.append(k)
        vs.append(v)
    return model.ln_f(h), torch.stack(ks), torch.stack(vs)
