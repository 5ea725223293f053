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
  than threefry). A forward's keys are one row of int64 site keys
  (:func:`dropout_site_keys`, laid out by :func:`site_row`) on the
  device, and each mask is a counter hash of its site's key and the
  element index (``ops.dropout``, a CUDA kernel on the card; the
  attention kernels read the low 32 bits of theirs), so it is a function
  of the key alone: a checkpointed block redraws the same mask when it
  is recomputed, a resumed run draws the masks an uninterrupted one
  would, and a captured CUDA graph draws each replay's masks from the
  keys its step wrote into the row.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch import nn

from midgpt_tpu_torch.ops.dropout import dropout as keyed
from midgpt_tpu_torch.sampling import splitmix64

_MASK64 = (1 << 64) - 1


class Embedding(nn.Module):
    """Token-id -> vector gather; weight ``[V, D]``.

    Under a tensor axis (``self.tensor``; JAX's ``embed_tokens``) the
    lookup is vocab-parallel: each held shard of ``V / tp`` rows looks up
    the ids in its range, writes zeros for the others, and the shards'
    rows are summed (``parallel.tensor.reduce_from_tensor``); the weight's
    gradient stays local."""

    tensor = None  # the tensor axis's exchange (GPT.shard_tensor_)

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
        ex = self.tensor
        if ex is None:
            return self.weight[tokens]
        from midgpt_tpu_torch.parallel.tensor import (
            held_shard,
            reduce_from_tensor,
        )

        vl = self.weight.shape[0] // len(ex.held)
        parts = []
        for j, r in ex.shards():
            local = tokens - r * vl
            inside = (local >= 0) & (local < vl)
            rows = held_shard(self.weight, j, ex, 0)[local.clamp(0, vl - 1)]
            parts.append(torch.where(inside[..., None], rows, 0))
        return reduce_from_tensor(parts, ex)


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


# a layer's dropout sites in a row of site keys: the attention
# probabilities (the flash kernels' seed), the attention output after wo,
# the MLP output
SITES_PER_LAYER = 3


def site_row(n_layer: int) -> tp.Dict[str, tp.Any]:
    """The layout of a forward's row of site keys: ``"embed"`` (the
    embedding dropout's index), ``"layers"`` (layer ``l``'s slice, its
    sites in :data:`SITES_PER_LAYER`'s order) and ``"size"``."""
    return {"embed": 0,
            "layers": [slice(1 + SITES_PER_LAYER * l,
                             1 + SITES_PER_LAYER * (l + 1))
                       for l in range(n_layer)],
            "size": 1 + SITES_PER_LAYER * n_layer}


def dropout_site_keys(key: int, n_layer: int) -> tp.List[int]:
    """A forward's site keys from its key, in :func:`site_row`'s layout,
    split as the JAX model splits its PRNG key: one key for the embedding
    and one for the blocks, one per block, within a block one for the
    attention (split again into the probabilities' and the output's) and
    one for the MLP."""
    embed, blocks = split(key, 2)
    row = [embed]
    for bkey in split(blocks, n_layer):
        attn, mlp = split(bkey, 2)
        row += [*split(attn, 2), mlp]
    return row


def dropout_key_table(step_key: int, g: int, n_layer: int) -> np.ndarray:
    """int64 ``[g, sites]``: each microbatch's site keys, the step key
    split into one key a microbatch (``split(step_key, g)``)."""
    return np.array([dropout_site_keys(k, n_layer)
                     for k in split(step_key, g)], dtype=np.int64)


def key_row(key: tp.Union[int, torch.Tensor], n_layer: int,
            device) -> torch.Tensor:
    """A forward's row of site keys on ``device``: a tensor row itself, an
    int's :func:`dropout_site_keys` copied there."""
    if isinstance(key, torch.Tensor):
        if tuple(key.shape) != (site_row(n_layer)["size"],):
            raise ValueError(f"a key row holds {site_row(n_layer)['size']} "
                             f"site keys, got {tuple(key.shape)}")
        return key
    return torch.tensor(dropout_site_keys(key, n_layer), dtype=torch.int64,
                        device=device)


def dropout(x: torch.Tensor, rate: float,
            key: tp.Union[None, int, torch.Tensor],
            row_offset: int = 0,
            seq: tp.Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Inverted dropout under ``key`` (an int, or a one-element int64
    tensor on x's device): ``ops.dropout``'s counter-hash mask; no-op
    without a key or at rate 0. ``row_offset`` is the global index of
    x's first row (dim 0) and ``seq = (i, S)`` says each row of x is the
    ``i``-th of ``S`` equal column slices of a global row (a sequence
    rank's ``[B, T/S, D]``): x draws the masks of the same elements of
    the global batch."""
    if key is None or rate == 0.0:
        return x
    if not isinstance(key, torch.Tensor):
        key = torch.tensor(key, dtype=torch.int64, device=x.device)
    per_row = x.numel() // x.shape[0] if x.numel() else 0
    i, s = seq
    return keyed(x, key, rate, row_offset * per_row * s + i * per_row,
                 per_row or None, per_row * s or None)
