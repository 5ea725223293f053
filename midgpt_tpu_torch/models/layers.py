"""Primitive NN layers (counterpart of ``midgpt_tpu.models.layers``).

Layouts and numerics follow the JAX package:
- ``Linear`` stores its weight ``[in, out]`` and applies ``x @ W`` (not
  ``nn.Linear``'s ``[out, in]``); truncated-normal init in [-2, 2]
  scaled ``1/sqrt(fan_in)``, no bias.
- ``RMSNorm``: ``x * rsqrt(mean(x^2) + eps)``, optional scale; the block
  and final norms are weightless.
- ``LayerNorm``: mean-subtracting, learned scale, no bias (QK-norm).
- Both norms compute in float32 and round to the input dtype once. For
  float32 inputs that is the JAX arithmetic; for bf16 it is the f32
  function rounded once, where JAX rounds after each op.
- RoPE: GPT-J interleaved rotate-every-two; the sin/cos tables are built
  in NumPy float64 and cast to the compute dtype where they are used.
- Dropout is inverted (kept values scaled by ``1 / keep``) and keyed:
  randomness comes from integer keys (``fold_in``, ``split``: the
  host-side counterparts of ``jax.random``'s, a splitmix64 mix rather
  than threefry), and each mask is drawn from a generator seeded with
  its key at the site, so it is a function of the key alone, never of a
  running generator's state. That is what lets a checkpointed block
  redraw the same mask when it is recomputed, and a resumed run draw the
  masks an uninterrupted one would. (The attention masks' counter hash,
  evaluated in int64 PyTorch ops, would serve as well, but it costs more
  device and host time: PERF.md.)
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from midgpt_tpu_torch.sampling import splitmix64

_MASK64 = (1 << 64) - 1


class Embedding(nn.Module):
    """Token-id -> vector gather; weight ``[V, D]``."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    @staticmethod
    def init(vocab_size: int, dim: int, std: float,
             generator: torch.Generator) -> "Embedding":
        w = torch.empty(vocab_size, dim, dtype=torch.float32)
        nn.init.normal_(w, 0.0, std, generator=generator)
        return Embedding(w)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weight[tokens]


class Linear(nn.Module):
    """Bias-free linear with weight stored ``[in, out]``: ``x @ W``."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)

    @staticmethod
    def init(in_features: int, out_features: int,
             generator: torch.Generator) -> "Linear":
        w = torch.empty(in_features, out_features, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return Linear(w * (1 / math.sqrt(in_features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2, -1) + eps) [* weight]``.

    ``impl`` takes the JAX package's values and rule: ``"fused"`` runs
    ``ops.fused_norm`` (the CUDA kernels on the card, their plain versions
    on the CPU) where ``D % 128 == 0``; everything else, ``"auto"`` and
    ``"jnp"`` included, runs the plain chain below."""

    def __init__(self, dim: int, use_weight: bool = False, eps: float = 1e-6,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "jnp", "fused"):
            raise ValueError(f"norm impl {impl!r} is not auto | jnp | fused")
        self.eps = eps
        self.impl = impl
        self.weight = (
            nn.Parameter(torch.ones(dim))
            if use_weight else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "fused" and x.shape[-1] % 128 == 0:
            from midgpt_tpu_torch.ops.fused_norm import fused_rms_norm

            return fused_rms_norm(x, self.weight, self.eps)
        xf = x.to(torch.float32)
        out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        if self.weight is not None:
            out = out * self.weight.to(torch.float32)
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    """Mean-subtracting LayerNorm, learned scale, no bias (QK-norm)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        centered = xf - xf.mean(-1, keepdim=True)
        var = centered.square().mean(-1, keepdim=True)
        out = centered * torch.rsqrt(var + self.eps)
        return (out * self.weight.to(torch.float32)).to(x.dtype)


def rope_tables(
    head_dim: int, seq_len: int, base: float = 10000.0
) -> tp.Tuple[np.ndarray, np.ndarray]:
    """sin/cos tables ``[T, head_dim // 2]`` in NumPy float64."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    angles = np.einsum("i,j->ij", np.arange(seq_len), inv_freq)
    return np.sin(angles), np.cos(angles)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """``[a b c d] -> [-b a -d c]``."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def apply_rotary(
    x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
) -> torch.Tensor:
    """Interleaved RoPE. ``x``: ``[..., T, C]``; sin/cos broadcastable to
    ``[..., T, C // 2]``, cast to ``x``'s dtype before use."""
    sin_full = torch.repeat_interleave(sin.to(x.dtype), 2, dim=-1)
    cos_full = torch.repeat_interleave(cos.to(x.dtype), 2, dim=-1)
    return x * cos_full + rotate_every_two(x) * sin_full


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and the integer ``data``."""
    return splitmix64(splitmix64(key & _MASK64) ^ (data & _MASK64)) & (
        (1 << 63) - 1)


def split(key: int, n: int) -> tp.List[int]:
    """``n`` keys derived from ``key``."""
    return [fold_in(key, i) for i in range(n)]


def int32_seed(key: int) -> int:
    """The low 32 bits of ``key`` as a signed int32 (a kernel seed)."""
    return ((key & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def dropout(x: torch.Tensor, rate: float,
            key: tp.Optional[int]) -> torch.Tensor:
    """Inverted dropout, its mask drawn from a generator on ``x``'s device
    seeded with ``key``; no-op without a key or at rate 0."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(key)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
