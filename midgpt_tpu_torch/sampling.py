"""Token sampling and the fixed-batch KV-cached sampler (counterpart of
``midgpt_tpu.sampling``: ``sample_token`` and ``derive_request_key``, its
speculation half ``target_probs``, ``acceptance_mask``,
``residual_logits``, and :func:`generate` / :func:`make_sampler`).

Greedy decoding is an argmax (first index on ties, as ``jnp.argmax``).
Temperature / top-k sampling is a Gumbel-max draw, the same construction
as ``jax.random.categorical``. JAX's and PyTorch's random streams cannot
match, so sampled tokens are never compared with the JAX package bit for
bit; what is kept is the determinism contract: the noise for stream
position ``i`` of a request is a function of (engine seed, request seed,
``i``) alone, never of the slot, the window size or the batch, so a
request's sampled stream does not depend on how it was scheduled.

The noise is a counter hash of (key, vocabulary index) computed where the
logits live: one 63-bit key per (slot, step), and the device turns
``[S]`` keys into ``[S, V]`` uniforms with integer ops. The hash uses
only non-negative int64 arithmetic that cannot overflow, so the CPU and
the card compute the same bits. The keys come from :func:`request_key`
on the host, or from :func:`request_keys` on the device (the serving
engine's programs, which read no host value), bit for bit the same.

Speculative rejection sampling draws one more uniform per drafted stream
position, from that position's key salted with :data:`SPEC_ACCEPT_SALT`
(:func:`acceptance_key`): a substream of its own, so a rejection at
position ``i`` resamples with exactly the categorical key the decode
window would have used there.

The fixed-batch sampler (:func:`generate`) runs one ring cache for the
whole batch, all rows starting and stopping together: the reference
midGPT's inference path with its sliding window past ``block_size``,
which the serving engine (``serving.generate_served``, capped at
``block_size``) does not give. Row ``i``'s generated token ``t`` draws
its noise from ``request_key(seed, i, t)``, the engine's convention with
the engine seed as ``seed`` and the request seed as the row index, so a
sampled stream does not depend on ``chunk_len`` and, at f32 and
``total <= block_size``, equals ``generate_served(..., seed=seed)``'s
stream for request ``i``. The JAX package's ``_pin_cache_layout`` (a TPU
tiling constraint on the cache) has no counterpart, and there is no
``mesh`` parameter: sampling over several cards is not ported.
"""

from __future__ import annotations

import typing as tp

import numpy as np
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


def _bits64(c: int) -> int:
    """``c`` in ``[0, 2^64)`` as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """The logical right shift of int64 bits: the arithmetic shift with
    the ``n`` sign-filled high bits masked off."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def splitmix64_bits(x: torch.Tensor) -> torch.Tensor:
    """:func:`splitmix64` on int64 tensors, elementwise: the uint64 value
    ``v`` travels as the int64 with its bits, and int64 sums and products
    wrap as uint64's do mod 2^64, so the bits are the host function's."""
    x = x + _bits64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _bits64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _bits64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def request_keys(base_seed: int, seeds: torch.Tensor,
                 token_index: torch.Tensor) -> torch.Tensor:
    """:func:`request_key` on the device: int64 keys for request seeds
    ``seeds`` (int64) at stream positions ``token_index`` (any integer
    dtype, broadcast against ``seeds``), bit for bit the host's."""
    key = splitmix64_bits(seeds.to(torch.int64)
                          ^ _bits64(splitmix64(base_seed)))
    key = splitmix64_bits(key ^ token_index.to(torch.int64))
    return key & ((1 << 63) - 1)


def acceptance_keys(base_seed: int, seeds: torch.Tensor,
                    token_index: torch.Tensor) -> torch.Tensor:
    """:func:`acceptance_key` on the device, as :func:`request_keys`."""
    key = request_keys(base_seed, seeds, token_index) ^ SPEC_ACCEPT_SALT
    return splitmix64_bits(key) & ((1 << 63) - 1)


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


def _draw(logits: torch.Tensor, keys: tp.Optional[torch.Tensor],
          temperature: float, top_k: tp.Optional[int]) -> torch.Tensor:
    """``[B]`` int32 tokens from ``logits [B, V]`` (taken in f32, as the
    engine takes its carried logits) with the noise of int64 ``keys``
    ``[B]`` (None when greedy)."""
    gumbel = None if keys is None else gumbel_noise(keys, logits.shape[-1])
    return sample_token(logits.to(torch.float32), temperature, top_k, gumbel)


def _row_keys(seed: int, rows: int, token_indices: tp.Sequence[int],
              device: torch.device) -> torch.Tensor:
    """``[len(token_indices), rows]`` int64 noise keys, one host-to-device
    copy: row ``i``'s generated token ``t`` keyed ``request_key(seed, i,
    t)``."""
    return torch.tensor(
        [[request_key(seed, i, t) for i in range(rows)]
         for t in token_indices], dtype=torch.int64).to(device)


@torch.no_grad()
def generate(
    model,
    prompt,  # [B, P] int token ids (array or tensor)
    max_new_tokens: int,
    *,
    seed: int = 0,
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    sliding: str = "exact",
    chunk_len: int = 64,
    device: tp.Union[None, str, torch.device] = None,
) -> torch.Tensor:
    """``[B, max_new_tokens]`` int32 continuations of ``prompt`` (on
    ``device``: the card unless the caller asks for the CPU; the model
    must already be there). A prompt longer than ``block_size`` is
    cropped to its last ``block_size`` tokens, as the reference does.

    Up to ``block_size`` tokens in all, decoding is KV-cached over a ring
    of ``wp = ceil(w / r_len) * r_len`` slots (``w = min(total,
    block_size)``, ``r_len = min(chunk_len, w)``), in chunks of ``r_len``
    steps: each step writes a small recent buffer and attends over it and
    the read-only ring (:func:`~midgpt_tpu_torch.models.gpt.
    decode_step_recent`); the chunk's rows are merged into the ring at
    its end. A partial first chunk aligns every later chunk's base to
    ``r_len``, so a merge never wraps. Past ``block_size`` the window
    slides:

    - ``sliding="exact"``: after the chunked decode up to ``w`` tokens,
      one full forward of the last ``w`` tokens per new token (positions
      from 0), the reference's own computation;
    - ``sliding="kv"``: the ring evicts its oldest slot (RoPE tables of
      ``total`` positions); past tokens keep the hidden states they were
      computed with, so it departs from the reference once the window
      slides.

    Greedy at ``temperature == 0``; otherwise temperature and top-k
    sampling with the noise keyed per (row, token index), see the module
    docstring."""
    from midgpt_tpu_torch.models.gpt import (
        KVCache,
        decode_step_recent,
        full_forward_impl,
        merge_recent,
        prefill,
    )
    from midgpt_tpu_torch.utils.platform import resolve_device

    if sliding not in ("exact", "kv"):
        raise ValueError(f"unknown sliding mode {sliding!r}")
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, not {device}")
    cfg = model.config
    if not isinstance(prompt, torch.Tensor):
        prompt = torch.from_numpy(np.asarray(prompt))
    prompt = prompt.to(device=device, dtype=torch.int32)
    if prompt.shape[1] > cfg.block_size:
        prompt = prompt[:, -cfg.block_size:]
    b, p = prompt.shape
    total = p + max_new_tokens
    w = min(total, cfg.block_size)
    r_len = min(chunk_len, w)
    wp = -(-w // r_len) * r_len
    cache = KVCache.init(cfg, b, wp, dtype=cache_dtype, device=device)
    logits, cache = prefill(model, prompt, cache)
    rshape = (cfg.n_layer, b, cfg.kv_heads, r_len, cfg.head_dim)
    sampled = temperature > 0.0

    def run_chunked(logits, n_steps: int):
        """``n_steps`` chunked decode steps from position ``p``."""
        toks, base, end = [], p, p + n_steps
        while base < end:
            clen = min(r_len - base % r_len, end - base)
            keys = (_row_keys(seed, b, range(base - p, base - p + clen),
                              device) if sampled else None)
            rk = torch.zeros(rshape, dtype=cache_dtype, device=device)
            rv = torch.zeros_like(rk)
            for r in range(clen):
                tok = _draw(logits, None if keys is None else keys[r],
                            temperature, top_k)
                logits, rk, rv = decode_step_recent(
                    model, tok, base + r, cache, rk, rv, r, base, w, total)
                toks.append(tok)
            merge_recent(cache, rk, rv, base % wp, clen)
            base += clen
        return logits, toks

    if sliding == "kv":
        _, toks = run_chunked(logits, max_new_tokens)
        return _stacked(toks, b, device)
    n1 = w - p  # tokens decodable before the window slides
    logits, toks = run_chunked(logits, n1)
    if total <= w:
        return _stacked(toks, b, device)
    # exact sliding: a full forward of the last w tokens per new token
    window = torch.cat([prompt, _stacked(toks, b, device)], dim=1)
    impl = full_forward_impl(cfg)
    for t in range(n1, max_new_tokens):
        keys = _row_keys(seed, b, [t], device)[0] if sampled else None
        tok = _draw(logits, keys, temperature, top_k)
        toks.append(tok)
        window = torch.cat([window[:, 1:], tok[:, None]], dim=1)
        logits = model.project(model.hidden(window, attn_impl=impl)[:, -1])
    return _stacked(toks, b, device)


def _stacked(toks: tp.List[torch.Tensor], b: int,
             device: torch.device) -> torch.Tensor:
    """``[B, N]`` from N ``[B]`` token tensors."""
    if not toks:
        return torch.zeros((b, 0), dtype=torch.int32, device=device)
    return torch.stack(toks, dim=1)


def make_sampler(
    max_new_tokens: int,
    *,
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    sliding: str = "exact",
    chunk_len: int = 64,
    device: tp.Union[None, str, torch.device] = None,
) -> tp.Callable[..., torch.Tensor]:
    """A ``(model, prompt, seed) -> tokens [B, max_new_tokens]`` sampler
    over :func:`generate` with these settings."""

    def sampler(model, prompt, seed: int = 0) -> torch.Tensor:
        return generate(model, prompt, max_new_tokens, seed=seed,
                        temperature=temperature, top_k=top_k,
                        cache_dtype=cache_dtype, sliding=sliding,
                        chunk_len=chunk_len, device=device)

    return sampler
