"""Token sampling (counterpart of ``midgpt_tpu.sampling``'s
``sample_token`` and ``derive_request_key``).

Greedy decoding is an argmax (first index on ties, as ``jnp.argmax``).
Temperature / top-k sampling is a Gumbel-max draw, the same construction
as ``jax.random.categorical``. JAX's and PyTorch's random streams cannot
match, so sampled tokens are never compared with the JAX package bit for
bit; what is kept is the determinism contract: the noise for stream
position ``i`` of a request is a function of (engine seed, request seed,
``i``) alone, never of the slot, the window size or the batch, so a
request's sampled stream does not depend on how it was scheduled.

The noise is a counter hash of (key, vocabulary index) computed where the
logits live: the host derives one 63-bit key per (slot, step), and the
device turns ``[S]`` keys into ``[S, V]`` uniforms with integer ops. The
hash uses only non-negative int64 arithmetic that cannot overflow, so the
CPU and the card compute the same bits.
"""

from __future__ import annotations

import typing as tp

import torch

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_key(base_seed: int, seed: int, token_index: int) -> int:
    """The 63-bit noise key of one request's stream position: a function
    of (engine seed, request seed, token index) only."""
    key = _splitmix64(_splitmix64(_splitmix64(base_seed) ^ (seed & _MASK64))
                      ^ (token_index & _MASK64))
    return key & ((1 << 63) - 1)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijection of ``[0, 2^32)`` in int64: xor-shifts and multiplies by
    odd constants below 2^31, so no product reaches 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 15)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[..., vocab]`` (f32, on ``keys``' device) from int64
    keys ``[...]`` (:func:`request_key`): row ``i`` depends on
    ``keys[i]`` alone."""
    idx = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    lo = (keys & _MASK32)[..., None]
    hi = ((keys >> 32) & _MASK32)[..., None]
    h = _mix32(_mix32(idx ^ lo) ^ hi)
    # 24 high bits -> a uniform strictly inside (0, 1)
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0**-24
    return -torch.log(-torch.log(u))


def _scaled_masked(logits: torch.Tensor, temperature: float,
                   top_k: tp.Optional[int]) -> torch.Tensor:
    """Temperature-scale and top-k-mask ``logits``."""
    logits = logits / temperature
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be positive, got {top_k}")
        top_k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return logits


def sample_token(
    logits: torch.Tensor,  # [..., V]
    temperature: float,
    top_k: tp.Optional[int] = None,
    gumbel: tp.Optional[torch.Tensor] = None,  # [..., V] noise
) -> torch.Tensor:
    """Greedy argmax at ``temperature == 0``; otherwise a Gumbel-max draw
    from the tempered, top-k-filtered distribution, with the caller's
    noise (:func:`gumbel_noise`)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gumbel is None:
        raise ValueError("sampling at temperature > 0 needs gumbel noise")
    scaled = _scaled_masked(logits, temperature, top_k)
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
