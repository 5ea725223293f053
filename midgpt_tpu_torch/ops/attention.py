"""Attention ops: the naive oracle and the dispatch (counterpart of
``midgpt_tpu.ops.attention``).

``naive_attention`` mirrors the JAX package's reference math: scores from
compute-dtype Q/K accumulated in f32, the causal mask added as -inf
BEFORE the scale, softmax in f32 of ``scores * (1/sqrt(C))``,
probabilities cast to the value dtype before PV. Layout ``[B, H, T, C]``;
GQA broadcasts the KV heads through a reshape.

Attention dropout draws its keep-mask from the flash kernels' counter
hash (``ops.flash.dropout_mask_reference``) on both paths, so the naive
path drops exactly what the kernels drop for the same seed. (The JAX
package's naive path draws ``jax.random.bernoulli`` instead; JAX's and
PyTorch's random streams cannot match anyway.)
"""

from __future__ import annotations

import math
import typing as tp

import torch

from midgpt_tpu_torch.ops.flash import (
    dropout_mask_reference,
    flash_attention,
    flash_attention_dropout,
)


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
    dropout_rate: float = 0.0,
    seed: tp.Optional[int] = None,
) -> torch.Tensor:
    """Reference-math attention, ``[B, H, T, C]`` in v's dtype; with a
    ``seed`` and ``dropout_rate > 0`` the probabilities are dropped by the
    counter-hash mask of ``seed`` and scaled by ``1 / keep``."""
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
    probs = torch.softmax(scores * scale, dim=-1)
    if dropout_rate > 0.0 and seed is not None:
        keep = 1.0 - dropout_rate
        mask = dropout_mask_reference(seed, b, h, t, dropout_rate, q.device)
        probs = torch.where(mask.reshape(probs.shape), probs / keep, 0.0)
    out = probs.to(v.dtype).to(f32) @ v[:, :, None].to(f32)
    return out.to(v.dtype).reshape(b, h, t, c)


def resolve_impl(impl: str, device: torch.device) -> str:
    """Resolve ``"auto"``: flash for CUDA tensors, naive otherwise. On the
    card every shape goes to the flash kernels, which raise for one they
    do not take (T not a multiple of their 64-row tile, C not 64 or 128):
    a CUDA tensor never takes the naive path unasked. (The JAX package
    sends T % 128 != 0 to its naive path on the TPU; 128 is its Pallas
    block, not these kernels' tile.)"""
    if impl != "auto":
        return impl
    return "flash" if device.type == "cuda" else "naive"


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "auto",
    causal: bool = True,
    dropout_rate: float = 0.0,
    seed: tp.Optional[int] = None,
) -> torch.Tensor:
    """Dispatch on ``[B, H, T, C]`` q/k/v; attention dropout at
    ``dropout_rate`` is drawn only with a ``seed``.

    impl:
      auto  - flash for CUDA tensors, naive for CPU ones
      naive - reference O(T^2) math (oracle)
      flash - the flash kernels (``ops.flash``; their plain versions for
              CPU tensors)
    """
    impl = resolve_impl(impl, q.device)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal,
                               dropout_rate=dropout_rate, seed=seed)
    if impl == "flash":
        if dropout_rate > 0.0 and seed is not None:
            return flash_attention_dropout(q, k, v, seed, dropout_rate, causal)
        return flash_attention(q, k, v, causal)
    raise ValueError(f"unknown attention impl {impl!r}")
