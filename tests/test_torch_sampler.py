"""The port's fixed-batch KV-cached sampler against the JAX package's.

- ``decode_step`` over a ring cache (with and without wrap-around):
  logits and cache against JAX's at every position (1e-5), and against
  the full forward's rows (2e-4, the JAX package's own bound);
- ``prefill`` at an aligned and an unaligned prompt: logits and the
  time-minor cache against JAX's, zero beyond the prompt; ``prefill``
  against the ``prefill_stepwise`` oracle;
- the chunked path (``decode_step_recent`` + ``merge_recent``) against
  JAX's and against the ``decode_step`` oracle, over ``r_len``, window
  and KV heads (JAX's ``test_chunked_decode_matches_decode_step_oracle``);
- greedy ``generate`` streams token for token equal to JAX's at f32 for
  both sliding modes, ``chunk_len`` 1, 5 and 64, totals below and above
  ``block_size``, a cropped prompt, MHA, GQA, MoE and int8 weights; the
  exact mode also against the reference's crop-and-reforward rollout;
- sampled streams, port against port (JAX's random bits cannot be
  matched): the same for every ``chunk_len`` and for the same seed, a
  row unchanged by other rows, and equal to ``generate_served``'s at f32
  for ``total <= block_size``;
- the sampler's full forwards: flash or fused configurations take
  "auto" at every length, and an unaligned prompt runs; the flash
  dispatch pads a T its tile does not divide (exact under the causal
  mask) and matches the naive path at every length.

JAX's outputs are computed once per module (fixtures) to keep the file
quick.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu import quant as jq
from midgpt_tpu.models import gpt as jg
from midgpt_tpu.sampling import generate as jax_generate
from midgpt_tpu_torch import quant as tq
from midgpt_tpu_torch.models import gpt as tg
from midgpt_tpu_torch.sampling import generate, make_sampler
from midgpt_tpu_torch.serving import generate_served

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)

MOE = dict(MHA, mlp="moe", moe_experts=4, moe_capacity=1.0)
CFGS = {"mha": MHA, "gqa": GQA, "moe": MOE}
F32 = torch.float32


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pairs():
    return {name: model_pair(kw) for name, kw in CFGS.items()}


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ["mha", "gqa"])
@pytest.mark.parametrize("w", [16, 8], ids=["ring16", "ring8_wraps"])
def test_decode_step_matches_jax_and_full_forward(pairs, name, w):
    jm, tm, _ = pairs[name]
    vocab = CFGS[name]["vocab_size"]
    toks = _tokens(vocab, (2, 16), 1)
    jc = jg.KVCache.init(jm.config, 2, w, dtype=jnp.float32)
    tc = tg.KVCache.init(tm.config, 2, w, dtype=F32, device="cpu")
    full = tm(t(toks).long())
    for pos in range(16):
        jl, jc = jg.decode_step(jm, jnp.asarray(toks[:, pos]),
                                jnp.asarray(pos, jnp.int32), jc, rope_len=16)
        tl, tc = tg.decode_step(tm, t(toks[:, pos]), pos, tc, rope_len=16)
        _close(tl, jl, 1e-5, f"logits at {pos}")
        if pos < w:  # nothing evicted yet: the full forward's row
            _close(tl, full[:, pos], 2e-4, f"vs full forward at {pos}")
    _close(tc.k, jc.k, 1e-5, "cache k")
    _close(tc.v, jc.v, 1e-5, "cache v")


@pytest.mark.parametrize("name,p", [("mha", 64), ("mha", 21), ("gqa", 21)],
                         ids=["mha_aligned", "mha_unaligned", "gqa_unaligned"])
def test_prefill_matches_jax(pairs, name, p):
    jm, tm, _ = pairs[name]
    toks = _tokens(CFGS[name]["vocab_size"], (2, p), 2)
    jl, jc = jg.prefill(jm, jnp.asarray(toks),
                        jg.KVCache.init(jm.config, 2, 72, dtype=jnp.float32))
    tl, tc = tg.prefill(tm, t(toks),
                        tg.KVCache.init(tm.config, 2, 72, dtype=F32,
                                        device="cpu"))
    _close(tl, jl, 1e-5, "logits")
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        assert got.shape == ref.shape  # [L, B, Hkv, C, W], time minor
        _close(got[..., :p], ref[..., :p], 1e-5)
        assert not got[..., :p].eq(0).all()
        assert got[..., p:].eq(0).all()
    # the same prefill with the flash dispatch (padded where 64 does not
    # divide P; its plain version here)
    h, (ks, _) = tm.hidden(t(toks), attn_impl="flash", return_kv=True)
    _close(tm.project(h[:, -1]), jl, 1e-5, "flash logits")
    _close(ks.transpose(-1, -2), jc.k[..., :p], 1e-5, "flash k")


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_prefill_matches_stepwise_oracle(pairs, name):
    """(Not MoE: its capacity drops claims at T = 12, never at T = 1.)"""
    _, tm, _ = pairs[name]
    toks = t(_tokens(CFGS[name]["vocab_size"], (2, 12), 3))
    la, ca = tg.prefill(tm, toks, tg.KVCache.init(tm.config, 2, 24, F32,
                                                  "cpu"))
    lb, cb = tg.prefill_stepwise(tm, toks, tg.KVCache.init(tm.config, 2, 24,
                                                           F32, "cpu"))
    _close(la, lb, 2e-4, "logits")
    _close(ca.k, cb.k, 2e-5, "cache k")
    _close(ca.v, cb.v, 2e-5, "cache v")


def _chunked(mod, model, tokens, p, total, window, r_len, init, zeros, arr,
             num=int):
    """Teacher-forced chunked decode in either package: logits per
    position after the prompt."""
    cfg = model.config
    wp = -(-window // r_len) * r_len
    cache = init(wp)
    _, cache = mod.prefill(model, arr(tokens[:, :p]), cache)
    out, base = [], p
    rshape = (cfg.n_layer, 2, cfg.kv_heads, r_len, cfg.head_dim)
    while base < total:
        clen = min(r_len - base % r_len, total - base)
        rk, rv = zeros(rshape), zeros(rshape)
        for r in range(clen):
            lg, rk, rv = mod.decode_step_recent(
                model, arr(tokens[:, base + r]), num(base + r), cache, rk,
                rv, num(r), base, window, total)
            out.append(np.asarray(lg))
        cache = mod.merge_recent(cache, rk, rv, base % wp, clen)
        base += clen
    return out


@pytest.mark.parametrize("r_len,window,kv_heads",
                         [(4, 16, None), (16, 8, None), (4, 16, 2)])
def test_chunked_decode_matches_jax_and_decode_step_oracle(r_len, window,
                                                           kv_heads):
    jm, tm, _ = model_pair(dict(MHA, n_kv_head=kv_heads))
    p, total = 5, 22
    toks = _tokens(96, (2, total), 4)
    ref = _chunked(
        jg, jm, toks, p, total, window, r_len,
        lambda n: jg.KVCache.init(jm.config, 2, n, dtype=jnp.float32),
        lambda s: jnp.zeros(s, jnp.float32), jnp.asarray,
        lambda i: jnp.asarray(i, jnp.int32))
    got = _chunked(
        tg, tm, toks, p, total, window, r_len,
        lambda n: tg.KVCache.init(tm.config, 2, n, F32, "cpu"),
        lambda s: torch.zeros(s, dtype=F32), t)
    # the oracle: plain ring decode over exactly `window` slots
    cache = tg.KVCache.init(tm.config, 2, window, F32, "cpu")
    _, cache = tg.prefill(tm, t(toks[:, :p]), cache)
    for i, pos in enumerate(range(p, total)):
        lo, cache = tg.decode_step(tm, t(toks[:, pos]), pos, cache,
                                   rope_len=total)
        _close(got[i], ref[i], 1e-5, f"vs JAX at {pos}")
        _close(got[i], lo, 2e-4, f"vs decode_step at {pos}")


# (model, sliding, prompt length, new tokens); block_size is 64
STREAMS = {
    "mha_exact_below": ("mha", "exact", 10, 20),
    "mha_exact_above": ("mha", "exact", 40, 40),
    "mha_kv_above": ("mha", "kv", 40, 40),
    "mha_exact_cropped": ("mha", "exact", 80, 12),
    "mha_kv_cropped": ("mha", "kv", 80, 12),
    "gqa_exact_above": ("gqa", "exact", 40, 40),
    "gqa_kv_above": ("gqa", "kv", 40, 40),
    "moe_exact_above": ("moe", "exact", 40, 40),
    "moe_kv_above": ("moe", "kv", 40, 40),
}


def _prompt(case):
    name, _, p, _ = STREAMS[case]
    return _tokens(CFGS[name]["vocab_size"], (3, p), 5)


@pytest.fixture(scope="module")
def jax_streams(pairs):
    out = {}
    for case, (name, sliding, _, n) in STREAMS.items():
        out[case] = np.asarray(jax_generate(
            pairs[name][0], jnp.asarray(_prompt(case)), n,
            key=jax.random.PRNGKey(0), temperature=0.0,
            cache_dtype=jnp.float32, sliding=sliding, chunk_len=5))
    return out


@pytest.mark.parametrize("chunk_len", [1, 5, 64])
@pytest.mark.parametrize("case", list(STREAMS))
def test_greedy_streams_match_jax(pairs, jax_streams, case, chunk_len):
    """JAX's chunk length changes its speed, not its stream: one JAX run
    per case holds the port at every chunk length. Below block_size the
    two sliding modes are the same computation."""
    name, sliding, _, n = STREAMS[case]
    got = generate(pairs[name][1], _prompt(case), n, temperature=0.0,
                   cache_dtype=F32, sliding=sliding, chunk_len=chunk_len,
                   device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, n)
    np.testing.assert_array_equal(got.numpy(), jax_streams[case])
    if case == "mha_exact_below":
        kv = generate(pairs[name][1], _prompt(case), n, temperature=0.0,
                      cache_dtype=F32, sliding="kv", chunk_len=chunk_len,
                      device="cpu")
        np.testing.assert_array_equal(kv.numpy(), jax_streams[case])


def test_exact_sliding_is_the_reference_rollout(pairs):
    """Past block_size the exact mode conditions on the last block_size
    tokens through a full forward, as the reference sampler does."""
    _, tm, _ = pairs["mha"]
    prompt = _prompt("mha_exact_above")
    got = generate(tm, prompt, 40, temperature=0.0, cache_dtype=F32,
                   chunk_len=5, device="cpu").numpy()
    idx = prompt.astype(np.int64)
    for _ in range(40):
        logits = tm(torch.from_numpy(idx[:, -64:]))[:, -1]
        idx = np.concatenate([idx, logits.argmax(-1).numpy()[:, None]], 1)
    np.testing.assert_array_equal(got, idx[:, 40:])


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_int8_greedy_streams_match_jax(pairs, name):
    jm, tm, _ = pairs[name]
    prompt = _tokens(CFGS[name]["vocab_size"], (3, 40), 6)
    ref = jax_generate(jq.quantize_model(jm), jnp.asarray(prompt), 40,
                       key=jax.random.PRNGKey(0), temperature=0.0,
                       cache_dtype=jnp.float32, chunk_len=8)
    got = generate(tq.quantize_model(tm), prompt, 40, temperature=0.0,
                   cache_dtype=F32, chunk_len=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


SAMPLED = dict(temperature=0.8, top_k=5, cache_dtype=F32, device="cpu")


@pytest.mark.parametrize("sliding", ["exact", "kv"])
def test_sampled_streams_do_not_depend_on_chunk_len(pairs, sliding):
    _, tm, _ = pairs["mha"]
    prompt = _prompt("mha_exact_above")
    outs = [generate(tm, prompt, 40, seed=3, sliding=sliding, chunk_len=c,
                     **SAMPLED).numpy() for c in (1, 5, 64)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    greedy = generate(tm, prompt, 40, sliding=sliding, temperature=0.0,
                      cache_dtype=F32, device="cpu").numpy()
    assert (outs[0] != greedy).any()


def test_sampled_streams_repeat_with_the_seed(pairs):
    _, tm, _ = pairs["gqa"]
    prompt = _prompt("gqa_exact_above")
    sampler = make_sampler(30, **SAMPLED)
    a, b, c = (sampler(tm, prompt, s).numpy() for s in (3, 3, 4))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_sampled_row_does_not_depend_on_other_rows(pairs):
    _, tm, _ = pairs["mha"]
    prompt = _prompt("mha_exact_above")
    alone = generate(tm, prompt[:1], 30, seed=7, **SAMPLED).numpy()
    batch = generate(tm, prompt, 30, seed=7, **SAMPLED).numpy()
    np.testing.assert_array_equal(batch[:1], alone)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_streams_equal_generate_served(pairs, name, temperature):
    """At f32 and total <= block_size the fixed-batch sampler gives every
    row the served stream of the request with that index (the engine
    keys request i's token t as the sampler keys row i's). Not MoE: the
    engine prefills at its padded bucket, and capacity depends on T."""
    _, tm, _ = pairs[name]
    prompt = _tokens(CFGS[name]["vocab_size"], (4, 17), 8)
    kw = dict(temperature=temperature, top_k=5, seed=11)
    got = generate(tm, prompt, 30, cache_dtype=F32, chunk_len=8,
                   device="cpu", **kw).numpy()
    ref = generate_served(tm, list(prompt), 30, slots=2, window=4,
                          device="cpu", **kw)
    np.testing.assert_array_equal(got, np.stack(ref))


@pytest.mark.parametrize("n", [1, 63, 65, 250])
def test_full_forward_impl_by_length(n):
    """Kernel configurations take "auto" whatever the length: the flash
    dispatch pads a causal T its tile does not divide and slices the
    output back, which is exact (with GQA and with dropout) against the
    naive path at that length; a non-causal ragged T is not padded."""
    from midgpt_tpu_torch.ops import attention as ta

    cfg = tg.ModelConfig(**MHA)
    for impl in ("auto", "flash", "fused"):
        assert tg.full_forward_impl(
            dataclasses.replace(cfg, attn_impl=impl)) == "auto"
    assert tg.full_forward_impl(
        dataclasses.replace(cfg, attn_impl="naive")) == "naive"
    g = torch.Generator().manual_seed(n)
    q = torch.randn(2, 4, n, 64, generator=g)
    k, v = (torch.randn(2, 2, n, 64, generator=g) for _ in range(2))
    for kw in ({}, dict(dropout_rate=0.25, seed=5)):
        got = ta.attention(q, k, v, impl="flash", **kw)
        assert got.shape == q.shape
        _close(got, ta.attention(q, k, v, impl="naive", **kw), 1e-5, str(kw))
    full = ta.attention(q, k, v, impl="flash", causal=False)
    _close(full, ta.attention(q, k, v, impl="naive", causal=False), 1e-5)


@pytest.mark.parametrize("impl", ["flash", "fused"])
def test_kernel_configured_unaligned_prompt_runs(pairs, impl, monkeypatch):
    """A flash or fused configuration samples from a prompt the kernels'
    tile does not divide: the prefill and the exact re-forwards of
    block_size = 64 tokens take "auto" (the kernels on the card, flash
    padded to its tile for the prefill; naive here); the stream equals
    the naive configuration's."""
    _, tm, params = pairs["mha"]
    from midgpt_tpu_torch.convert import gpt_from_jax_params

    km = gpt_from_jax_params(params, tg.ModelConfig(**MHA, attn_impl=impl),
                             device="cpu")
    seen = []
    hidden = tg.GPT.hidden

    def spy(self, tokens, attn_impl=None, *a, **k):
        seen.append((tokens.shape[1], attn_impl))
        return hidden(self, tokens, attn_impl, *a, **k)

    monkeypatch.setattr(tg.GPT, "hidden", spy)
    prompt = _tokens(96, (2, 21), 9)
    got = generate(km, prompt, 46, temperature=0.0, cache_dtype=F32,
                   chunk_len=8, device="cpu")
    assert seen == [(21, "auto")] + [(64, "auto")] * 3
    ref = generate(tm, prompt, 46, temperature=0.0, cache_dtype=F32,
                   chunk_len=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
