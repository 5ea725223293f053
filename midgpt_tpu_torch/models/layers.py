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
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn


class Embedding(nn.Module):
    """Token-id -> vector gather; weight ``[V, D]``."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)

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
        self.weight = nn.Parameter(weight, requires_grad=False)

    @staticmethod
    def init(in_features: int, out_features: int,
             generator: torch.Generator) -> "Linear":
        w = torch.empty(in_features, out_features, dtype=torch.float32)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return Linear(w * (1 / math.sqrt(in_features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2, -1) + eps) [* weight]``."""

    def __init__(self, dim: int, use_weight: bool = False, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = (
            nn.Parameter(torch.ones(dim), requires_grad=False)
            if use_weight else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
        self.weight = nn.Parameter(torch.ones(dim), requires_grad=False)

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
