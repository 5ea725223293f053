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
tiling constraint on the cache) has no counterpart.

``mesh`` (a tensor-only ``parallel.mesh.ServingMesh``, JAX's
``make_sampler(mesh=)``) samples under its tensor axis: the model's
column- and row-parallel shards (cut once from the full model,
``models.gpt.tensor_copy``), the ring cache and the recent rows split by
whole KV heads (``[L, B, Hkv / tp, W, C]`` a rank), the logits
vocabulary-sharded and each token through the greedy combiner or the
gathered row (``sample_token``). On a loopback mesh every rank is a
shard of this process, and each program launches every rank's kernels.

As JAX jits ``generate`` into one program (``make_sampler``), the port
runs it as programs (``serving.programs.Program``) over static tensors
of one shape (:class:`SamplerPrograms`): the prefill at ``(B, P)``, one
decode chunk of ``r_len`` steps whose base is a device scalar it
advances itself (so every full chunk replays one graph), a partial chunk
per distinct length, and one exact re-forward step past ``block_size``
whose token index is a device scalar too. A call is one pinned copy in
(the prompt, ``splitmix64(seed)``, the bases), the replays, and the
output's copy; on the CPU the same bodies run eagerly. The programs are
cached by JAX's key with the mesh's fingerprint (:func:`sampler_programs`),
bound to their model by weakref.
"""

from __future__ import annotations

import collections
import itertools
import typing as tp
import weakref

import numpy as np
import torch

from midgpt_tpu_torch.parallel.tensor import as_shards, shardwise

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


def request_keys(base_seed: tp.Union[int, torch.Tensor],
                 seeds: torch.Tensor,
                 token_index: torch.Tensor) -> torch.Tensor:
    """:func:`request_key` on the device: int64 keys for request seeds
    ``seeds`` (int64) at stream positions ``token_index`` (any integer
    dtype, broadcast against ``seeds``), bit for bit the host's. A tensor
    ``base_seed`` is ``splitmix64(base_seed)`` already, as int64 bits
    (:func:`mixed_seed`): one program then serves every engine seed."""
    mixed = (base_seed if isinstance(base_seed, torch.Tensor)
             else mixed_seed(base_seed))
    key = splitmix64_bits(seeds.to(torch.int64) ^ mixed)
    key = splitmix64_bits(key ^ token_index.to(torch.int64))
    return key & ((1 << 63) - 1)


def mixed_seed(base_seed: int) -> int:
    """``splitmix64(base_seed)`` as the int64 with its bits: the first
    stage of every :func:`request_key`."""
    return _bits64(splitmix64(base_seed))


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
    tensor=None,  # parallel.tensor.TensorExchange of vocab-sharded logits
) -> torch.Tensor:
    """Greedy argmax at ``temperature == 0``; otherwise a Gumbel-max draw
    from the tempered, top-k-filtered distribution, with the caller's
    noise (:func:`gumbel_noise`).

    Under a tensor axis (``tensor``) ``logits`` hold its held vocabulary
    shards (``GPT.project``): the greedy branch takes the combiner
    (``parallel.tensor.greedy_argmax``: one ``(max, index)`` a shard, the
    lowest index on ties, as the whole row's argmax), and a draw gathers
    the whole row first, so the token is the one tensor = 1 draws."""
    from midgpt_tpu_torch.parallel.tensor import gather_vocab, greedy_argmax

    if temperature == 0.0:
        return greedy_argmax(logits, tensor).to(torch.int32)
    if gumbel is None:
        raise ValueError("sampling at temperature > 0 needs gumbel noise")
    logits = gather_vocab(logits, tensor)
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
          temperature: float, top_k: tp.Optional[int],
          tensor=None) -> torch.Tensor:
    """``[B]`` int32 tokens from ``logits [B, V]`` (taken in f32, as the
    engine takes its carried logits; under ``tensor`` its held vocabulary
    shards) with the noise of int64 ``keys`` ``[B]`` (None when
    greedy)."""
    vocab = logits.shape[-1]
    if tensor is not None:
        vocab = vocab // len(tensor.held) * tensor.size
    gumbel = None if keys is None else gumbel_noise(keys, vocab)
    return sample_token(logits.to(torch.float32), temperature, top_k, gumbel,
                        tensor)


class SamplerPrograms:
    """The static tensors and programs of one :func:`generate` shape on one
    model: the ring cache, the recent rows, the carried f32 logits, the
    output ``[B, max_new_tokens]``, the window of the exact re-forward,
    and (in the prefill program's int32 buffer) the prompt, the mixed
    seed, the chunk base, the step's row in the chunk and the
    re-forward's token index. A chunk of JAX's ``one_chunk`` is ``n``
    replays of one decode step program (its row ``r`` a device scalar it
    advances) and one replay of the merge program of length ``n`` (the
    rows into the ring, the base advanced, ``r`` and the rows cleared), so
    a shape captures one step whatever its chunk length. The programs
    carry what their bodies update in place and do not rewrite alike
    (logits, rows, window, indices), so a capture's warm-up leaves the
    state as it found it. ``plan`` is the chunk lengths in order (JAX's
    partial first chunk, full chunks, partial last chunk),
    ``n_reforward`` the exact re-forwards past ``block_size``."""

    def __init__(self, model, b: int, p: int, max_new_tokens: int,
                 temperature: float, top_k: tp.Optional[int],
                 cache_dtype: torch.dtype, sliding: str, chunk_len: int,
                 device: torch.device, key: tp.Tuple):
        from midgpt_tpu_torch.models.gpt import (
            KVCache,
            _rope_table,
            _rope_tables_full,
        )
        from midgpt_tpu_torch.serving.programs import Program

        cfg = model.config
        self.model = weakref.ref(model)
        self.key = key
        self.p, self.n = p, max_new_tokens
        self.temperature, self.top_k = temperature, top_k
        self.total = p + max_new_tokens
        self.w = min(self.total, cfg.block_size)
        self.r_len = min(chunk_len, self.w)
        self.wp = -(-self.w // self.r_len) * self.r_len
        ex = self.tensor = model.tensor
        self.cache = KVCache.init(cfg, b, self.wp, dtype=cache_dtype,
                                  device=device, tensor=ex)
        # the recent rows [L, B, Hkv, R, C], each shard at its ring's heads
        self.rk, self.rv = (shardwise(lambda ck: torch.zeros(
            (cfg.n_layer, b, ck.shape[2], self.r_len, cfg.head_dim),
            dtype=cache_dtype, device=device), self.cache.k)
            for _ in range(2))
        held_v = cfg.vocab_size if ex is None else (
            cfg.vocab_size // ex.size * len(ex.held))
        self.logits = torch.zeros((b, held_v), dtype=torch.float32,
                                  device=device)
        self.out = torch.zeros((b, max_new_tokens), dtype=torch.int32,
                               device=device)
        self.rows = torch.arange(b, dtype=torch.int64, device=device)
        exact = sliding == "exact"
        decodable = self.w - p if exact else max_new_tokens
        self.plan = _chunk_plan(p, decodable, self.r_len)
        self.n_reforward = max_new_tokens - decodable
        self.window = (torch.zeros((b, self.w), dtype=torch.int32,
                                   device=device) if exact else None)
        pool = (torch.cuda.graph_pool_handle() if device.type == "cuda"
                else None)
        i32, i64 = torch.int32, torch.int64
        self.prefill = Program(
            key + ("prefill",), device,
            [("prompt", (b, p), i32), ("mixed", (1,), i64),
             ("base", (1,), i32), ("r", (1,), i32), ("t", (1,), i32)],
            quiet=lambda x: None, pool=pool)
        self.x = self.prefill.inputs
        ints = self.prefill._ints

        def program(name, carry):
            return Program(key + name, device, (), quiet=lambda x: None,
                           carry=carry, pool=pool)

        self.step = (program(("step",), (self.logits, ints)) if self.plan
                     else None)
        self.merges = {n: program(("merge", n), (*as_shards(self.rk),
                                                 *as_shards(self.rv), ints))
                       for n in sorted(set(self.plan))}
        self.reforward = (program(("reforward",),
                                  (self.window, self.logits, ints))
                          if self.n_reforward else None)
        # the rope tables the bodies read (keyed by a tensor's device, as
        # the bodies key them), held for the graphs' lifetime: the table
        # caches may drop them
        dev = self.logits.device
        self._tables = (
            _rope_table(cfg.head_dim, self.total, cfg.rope_base, dev),
            _rope_tables_full(cfg.head_dim, p, cfg.rope_base, dev),
            _rope_tables_full(cfg.head_dim, self.w, cfg.rope_base, dev))

    def programs(self) -> tp.List:
        """Every program of this shape, in the order a call first runs
        them."""
        return ([self.prefill] + ([self.step] if self.step else [])
                + [self.merges[n] for n in dict.fromkeys(self.plan)]
                + ([self.reforward] if self.reforward else []))

    def _model(self):
        model = self.model()
        if model is None:
            raise RuntimeError("the sampler's model is gone")
        return model

    def _keys(self, token_index: torch.Tensor) -> tp.Optional[torch.Tensor]:
        """Row ``i``'s key at token ``token_index``: ``request_key(seed,
        i, t)`` with the seed's mix from the program's input."""
        if self.temperature == 0.0:
            return None
        return request_keys(self.x["mixed"], self.rows, token_index)

    def prefill_body(self, x, probs) -> torch.Tensor:
        """The prompt's forward into the ring's first ``P`` slots, the
        logits after its last token, the exact window's first ``P``
        tokens, the recent rows cleared."""
        from midgpt_tpu_torch.models.gpt import prefill

        logits, _ = prefill(self._model(), x["prompt"], self.cache)
        self.logits.copy_(logits)
        if self.window is not None:
            self.window[:, : self.p].copy_(x["prompt"])
        self._clear_rows()
        return x["base"]

    def _clear_rows(self) -> None:
        for rows in (*as_shards(self.rk), *as_shards(self.rv)):
            rows.zero_()

    def step_body(self, x, probs) -> torch.Tensor:
        """One step of JAX's ``one_chunk`` at the device base and row
        ``r``: the token from the carried logits into the output at ``base
        - P + r`` (and the exact window), its decode step over the ring
        and the recent rows (its K/V into row ``r``), then ``r += 1`` on
        the device."""
        from midgpt_tpu_torch.models.gpt import decode_step_recent

        base, r = self.x["base"], self.x["r"]
        at = base.long() + r.long()
        tok = _draw(self.logits, self._keys(at - self.p), self.temperature,
                    self.top_k, self.tensor)
        self.out.index_copy_(1, at - self.p, tok[:, None])
        if self.window is not None:
            self.window.index_copy_(1, at, tok[:, None])
        logits, _, _ = decode_step_recent(
            self._model(), tok, at, self.cache, self.rk, self.rv, r, base,
            self.w, self.total)
        self.logits.copy_(logits)
        r.add_(1)
        return r

    def merge_body(self, clen: int):
        """The end of a chunk of ``clen`` steps: its rows merged into the
        ring at ``base % wp``, then ``base += clen``, ``r = 0`` and the
        rows cleared, on the device."""
        from midgpt_tpu_torch.models.gpt import merge_recent

        def body(x, probs) -> torch.Tensor:
            base = self.x["base"]
            merge_recent(self.cache, self.rk, self.rv,
                         torch.remainder(base, self.wp), clen)
            base.add_(clen)
            self.x["r"].zero_()
            self._clear_rows()
            return base

        return body

    def reforward_body(self, x, probs) -> torch.Tensor:
        """JAX's ``body2``: one token from the carried logits at the device
        token index, the window shifted in place, one full forward of it
        (``full_forward_impl``), the index advanced."""
        from midgpt_tpu_torch.models.gpt import full_forward_impl

        model = self._model()
        t = self.x["t"]
        tok = _draw(self.logits, self._keys(t), self.temperature,
                    self.top_k, self.tensor)
        self.out.index_copy_(1, t.long(), tok[:, None])
        self.window.copy_(torch.cat([self.window[:, 1:], tok[:, None]],
                                    dim=1))
        h = model.hidden(self.window, attn_impl=full_forward_impl(
            model.config))
        self.logits.copy_(model.project(h[:, -1]))
        t.add_(1)
        return t

    def load(self, prompt: np.ndarray, seed: int) -> None:
        """The prompt ``[B, P]``, the seed's mix and the starting base, row
        and token index into the static inputs: one pinned copy."""
        self.prefill.load(prompt=prompt, mixed=mixed_seed(seed),
                          base=self.p, r=0, t=self.n - self.n_reforward)

    def run(self) -> None:
        """The prefill, every chunk of the plan (its steps, then its
        merge) and every re-forward: on the card replays only (each
        program captured at its first run)."""
        self.prefill.run(self.prefill_body)
        for n in self.plan:
            for _ in range(n):
                self.step.run(self.step_body)
            self.merges[n].run(self.merge_body(n))
        for _ in range(self.n_reforward):
            self.reforward.run(self.reforward_body)

    def read(self) -> torch.Tensor:
        """The output, copied out of the static buffer (the next call
        overwrites it)."""
        return self.out.clone()

    def __call__(self, prompt: np.ndarray, seed: int) -> torch.Tensor:
        """One :func:`generate` call: :meth:`load`, :meth:`run`,
        :meth:`read`."""
        self.load(prompt, seed)
        self.run()
        return self.read()


def _chunk_plan(p: int, n_steps: int, r_len: int) -> tp.List[int]:
    """Chunk lengths of ``n_steps`` decode steps from position ``p``: a
    partial first chunk to align the base to ``r_len`` (merges never wrap
    the ring), the full chunks, a partial last chunk."""
    plan, base, end = [], p, p + n_steps
    while base < end:
        plan.append(min(r_len - base % r_len, end - base))
        base += plan[-1]
    return plan


# the sampler programs by key, least recently used first
_SAMPLERS: "collections.OrderedDict[tp.Tuple, SamplerPrograms]" = (
    collections.OrderedDict())
SAMPLER_CACHE_SIZE = 4


def sampler_programs(model, b: int, p: int, max_new_tokens: int, *,
                     temperature: float, top_k: tp.Optional[int],
                     cache_dtype: torch.dtype, sliding: str,
                     chunk_len: int, device: torch.device
                     ) -> SamplerPrograms:
    """The :class:`SamplerPrograms` of this shape, made at its first call:
    keyed as JAX's ``_cached_program`` keys ``make_sampler`` (config,
    shapes, sampling constants, cache dtype, sliding, chunk length, here
    the device and the model's identity). The key also holds the address
    and dtype of every parameter and buffer: a graph reads them where they
    were at its capture, so a model whose tensors were moved or replaced
    (``model.to(dtype)``, ``load_state_dict(..., assign=True)``) gets new
    programs. At most :data:`SAMPLER_CACHE_SIZE` stay (a ring for B = 8
    at 124M holds about 300 MB), and a model's programs go with it."""
    weights = tuple((t.data_ptr(), t.dtype) for t in itertools.chain(
        model.parameters(), model.buffers()))
    ex = model.tensor
    mesh = None if ex is None else (ex.size, ex.held, ex.grouped)
    key = ("sampler", model.config, b, p, max_new_tokens, temperature,
           top_k, cache_dtype, sliding, chunk_len, str(device), mesh,
           weights, id(model))
    progs = _SAMPLERS.get(key)
    if progs is not None and progs.model() is model:
        _SAMPLERS.move_to_end(key)
        return progs
    mine = [k for k in _SAMPLERS if k[-1] == id(model)]
    if not mine:
        weakref.finalize(model, _forget_model, id(model))
    for k in mine:  # programs of the model's earlier tensors: never again
        if k[-2] != weights:
            del _SAMPLERS[k]
    progs = SamplerPrograms(model, b, p, max_new_tokens, temperature, top_k,
                            cache_dtype, sliding, chunk_len, device, key)
    _SAMPLERS[key] = progs
    while len(_SAMPLERS) > SAMPLER_CACHE_SIZE:
        _SAMPLERS.popitem(last=False)
    return progs


def _forget_model(ident: int) -> None:
    for k in [k for k in _SAMPLERS if k[-1] == ident]:
        del _SAMPLERS[k]


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
    mesh=None,
) -> torch.Tensor:
    """``[B, max_new_tokens]`` int32 continuations of ``prompt`` (on
    ``device``: the card unless the caller asks for the CPU; the model
    must already be there). A prompt longer than ``block_size`` is
    cropped to its last ``block_size`` tokens, as the reference does.
    ``mesh``: sample under its tensor axis (module docstring; the full
    ``model``'s shards are cut at the first call and kept with it).

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
    docstring. The work runs as the replays of this shape's
    :class:`SamplerPrograms` (eagerly on the CPU)."""
    from midgpt_tpu_torch.utils.platform import resolve_device

    if sliding not in ("exact", "kv"):
        raise ValueError(f"unknown sliding mode {sliding!r}")
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    if mesh is not None and device is None:
        device = mesh.device
    device = resolve_device(device)
    model = _mesh_model(model, mesh)
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, not {device}")
    cfg = model.config
    if isinstance(prompt, torch.Tensor):
        prompt = prompt.cpu().numpy()
    prompt = np.asarray(prompt).astype(np.int32)[:, -cfg.block_size:]
    b, p = prompt.shape
    progs = sampler_programs(
        model, b, p, max_new_tokens, temperature=float(temperature),
        top_k=top_k, cache_dtype=cache_dtype, sliding=sliding,
        chunk_len=chunk_len, device=device)
    return progs(prompt, seed)


def _mesh_model(model, mesh):
    """The model the sampler runs under ``mesh``: ``model`` itself without
    a tensor axis above one rank (or over a group), else its shards
    (``models.gpt.tensor_copy``: cut once a mesh, kept while the model
    lives; a model already cut for the mesh as it is)."""
    from midgpt_tpu_torch.models.gpt import check_serving_tensor, tensor_copy

    if mesh is None:
        if model.tensor is not None:
            raise ValueError("a tensor-sharded model needs its mesh=")
        return model
    check_serving_tensor(model.config, mesh)
    ex = mesh.tensor
    if mesh.tp == 1 and not ex.grouped:
        return model
    return tensor_copy(model, ex)


def make_sampler(
    max_new_tokens: int,
    *,
    mesh=None,
    temperature: float = 1.0,
    top_k: tp.Optional[int] = None,
    cache_dtype: torch.dtype = torch.bfloat16,
    sliding: str = "exact",
    chunk_len: int = 64,
    device: tp.Union[None, str, torch.device] = None,
) -> tp.Callable[..., torch.Tensor]:
    """A ``(model, prompt, seed) -> tokens [B, max_new_tokens]`` sampler
    over :func:`generate` with these settings (``mesh``: under its tensor
    axis, JAX's ``make_sampler(mesh=)``)."""

    def sampler(model, prompt, seed: int = 0) -> torch.Tensor:
        return generate(model, prompt, max_new_tokens, seed=seed,
                        temperature=temperature, top_k=top_k,
                        cache_dtype=cache_dtype, sliding=sliding,
                        chunk_len=chunk_len, device=device, mesh=mesh)

    return sampler
