"""Token sampling (counterpart of ``midgpt_tpu.sampling``'s
``sample_token`` and ``derive_request_key``, and of its speculation half:
``target_probs``, ``acceptance_mask``, ``residual_logits``).

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

Speculative rejection sampling draws one more uniform per drafted stream
position, from that position's key salted with :data:`SPEC_ACCEPT_SALT`
(:func:`acceptance_key`): a substream of its own, so a rejection at
position ``i`` resamples with exactly the categorical key the decode
window would have used there.
"""

from __future__ import annotations

import typing as tp

import torch

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_key(base_seed: int, seed: int, token_index: int) -> int:
    """The 63-bit noise key of one request's stream position: a function
    of (engine seed, request seed, token index) only."""
    key = splitmix64(splitmix64(splitmix64(base_seed) ^ (seed & _MASK64))
                      ^ (token_index & _MASK64))
    return key & ((1 << 63) - 1)


# Salt of the acceptance substream (the JAX package's value).
SPEC_ACCEPT_SALT = 0x5BEC


def acceptance_key(base_seed: int, seed: int, token_index: int) -> int:
    """The 63-bit key of the acceptance uniform at one stream position:
    the position's :func:`request_key` salted, through ``splitmix64``."""
    key = request_key(base_seed, seed, token_index) ^ SPEC_ACCEPT_SALT
    return splitmix64(key) & ((1 << 63) - 1)


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


def _uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n]`` f32 uniforms strictly inside (0, 1) from int64 keys
    ``[...]``: the counter hash of (key, index), its 24 high bits."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lo = (keys & _MASK32)[..., None]
    hi = ((keys >> 32) & _MASK32)[..., None]
    h = _mix32(_mix32(idx ^ lo) ^ hi)
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0**-24


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel noise ``[..., vocab]`` (f32, on ``keys``' device) from int64
    keys ``[...]`` (:func:`request_key`): row ``i`` depends on
    ``keys[i]`` alone."""
    return -torch.log(-torch.log(_uniforms(keys, vocab)))


def acceptance_uniforms(keys: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in (0, 1) per int64 key (:func:`acceptance_key`),
    the same 24-bit construction as :func:`gumbel_noise`."""
    return _uniforms(keys, 1)[..., 0]


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


def target_probs(logits: torch.Tensor, temperature: float,
                 top_k: tp.Optional[int]) -> torch.Tensor:
    """The distribution :func:`sample_token` draws from at the same
    ``(temperature, top_k)``, as f32 probabilities: the softmax of the
    same tempered, top-k-masked logits."""
    return torch.softmax(
        _scaled_masked(logits.to(torch.float32), temperature, top_k), dim=-1)


def acceptance_mask(u: torch.Tensor, q_sel: torch.Tensor,
                    p_sel: torch.Tensor) -> torch.Tensor:
    """Rejection-sampling acceptance of a drafted token ``t``:
    ``u * q(t) <= p(t)``, the multiplied form of ``u <= p(t) / q(t)`` (no
    division; ``q(t) = 0`` always accepts). One-hot drafts have
    ``q(t) = 1``."""
    return (u * q_sel) <= p_sel


def residual_logits(p: torch.Tensor, q: torch.Tensor, temperature: float
                    ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Logits whose :func:`sample_token` draw is the residual draw
    ``normalize(max(p - q, 0))``: ``temperature * log(normalize(...))``,
    ``-inf`` off the residual's support, and the residual mass
    ``sum(max(p - q, 0))`` (the caller keeps the raw row where it is 0).
    The draw divides by the temperature again, top-k masking leaves a row
    of at most top-k finite entries as it is, and the Gumbel argmax is
    shift-invariant, so the carried row draws exactly the residual."""
    resid = torch.clamp(p - q, min=0.0)
    mass = resid.sum(dim=-1)
    denom = torch.where(mass > 0.0, mass, torch.ones_like(mass))[..., None]
    norm = torch.where(resid > 0.0, resid / denom, torch.ones_like(resid))
    out = torch.where(resid > 0.0, temperature * torch.log(norm),
                      torch.full_like(resid, -torch.inf))
    return out, mass
