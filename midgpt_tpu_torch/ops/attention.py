"""Attention ops: the naive oracle and the dispatch (counterpart of
``midgpt_tpu.ops.attention``).

``naive_attention`` mirrors the JAX package's reference math: scores from
compute-dtype Q/K accumulated in f32, the causal mask added as -inf
BEFORE the scale, softmax in f32 of ``scores * (1/sqrt(C))``,
probabilities cast to the value dtype before PV. Layout ``[B, H, T, C]``;
GQA broadcasts the KV heads through a reshape.
"""

from __future__ import annotations

import math

import torch


def causal_mask(t: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """``[T, T]`` additive mask: 0 on and below the diagonal, -inf above."""
    ii = torch.arange(t, device=device)
    return torch.where(ii[None, :] <= ii[:, None], 0.0, -math.inf).to(dtype)


def naive_attention(
    q: torch.Tensor,  # [B, H, T, C]
    k: torch.Tensor,  # [B, Hkv, T, C]
    v: torch.Tensor,  # [B, Hkv, T, C]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Reference-math attention, ``[B, H, T, C]`` in v's dtype."""
    b, h, t, c = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"n_head {h} not divisible by n_kv_head {hkv}")
    f32 = torch.float32
    qg = q.reshape(b, hkv, h // hkv, t, c)
    # compute-dtype operands, f32 accumulation: the exact products of the
    # upcast operands summed in f32
    scores = qg.to(f32) @ k[:, :, None].to(f32).transpose(-1, -2)
    if causal:
        scores = scores + causal_mask(t, q.device)
    scale = 1.0 / math.sqrt(c)
    probs = torch.softmax(scores * scale, dim=-1).to(v.dtype)
    out = probs.to(f32) @ v[:, :, None].to(f32)
    return out.to(v.dtype).reshape(b, h, t, c)


def attention(q, k, v, *, impl: str = "naive", causal: bool = True):
    """Dispatch on ``[B, H, T, C]`` q/k/v. The port has the naive path;
    the flash kernels (``ops/flash.py`` in the JAX package) come in a
    later slice."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal)
    if impl == "flash":
        raise NotImplementedError(
            "the flash kernels are not ported yet; use attn_impl='naive' "
            "or 'fused'")
    raise ValueError(f"unknown attention impl {impl!r}")
