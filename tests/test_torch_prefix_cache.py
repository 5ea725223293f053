"""The port's prefix cache, copy-on-write and chunked prefill against the
JAX package's.

A 2-layer model gets the same weights in both packages
(``torch_port_util.model_pair``); the JAX engine runs its Pallas decode
and verify kernels in interpret mode (``paged_kernel="pallas"``) over an
f32 pool, the port its plain versions on the CPU. Checked:

- greedy streams on shared-prefix traffic (one 18-token system prompt,
  four tails, more requests than slots) equal the JAX engine's request by
  request with the cache on and off and with one-pass prefill and chunks
  of 8 and 5 tokens; the same with ``speculate=4`` and with
  ``kv_quant="int8"``; the int8 cache hits (cold pages, the
  copy-on-write page, decode-written pages) equal the cache-off run;
- ``PrefixIndex`` follows JAX's through one random sequence of calls:
  the same canonical pages, matches, eviction order and ``check()``;
  ``copy_page`` equals JAX's bit for bit and carries an int8 pool's
  scale rows;
- a repeated prompt computes only its last token (JAX
  ``test_shared_prefix_skips_prefill_compute``); a multi-turn prompt hits
  pages written by decode windows; a long prompt's chunks spread over
  windows while another request decodes; after every step of a
  shared-prefix trace under page pressure the allocator and the index
  hold their invariants and no writable page is shared;
- admission: a request reserves its prompt's pages less its matched
  full pages, reclaiming cold pages leaf first, with the JAX engine's
  counts after every step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving.paged import PagedKVPool as JaxPagedKVPool
from midgpt_tpu.serving.paged import PrefixIndex as JaxPrefixIndex
from midgpt_tpu.serving.paged import copy_page as jax_copy_page
from midgpt_tpu_torch.serving import (
    PagedKVPool,
    PrefixIndex,
    ServingEngine,
    copy_page,
)

from torch_port_util import GQA, MHA, assert_pages_home, model_pair, t

torch.set_num_threads(2)

KW = dict(slots=2, page_size=8, window=4)


def _shared_prefix_case(vocab, seed=0):
    """One 18-token system prompt with four tails of 3, 5, 7 and 9 tokens
    (JAX ``shared_prefix_case``'s shapes), and each request's budget."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, size=18)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, vocab, size=n)])
               .astype(np.int32) for n in (3, 5, 7, 9)]
    return prompts, [9, 12, 7, 10]


def _jax_streams(jm, prompts, lens, **kw):
    eng = JaxServingEngine(jm, cache_dtype=jnp.float32, paged_kernel="pallas",
                           **{**KW, **kw})
    rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    fin = eng.run()
    return [list(map(int, fin[r].tokens)) for r in rids], eng


def _port_streams(tm, prompts, lens, check_every_step=False, **kw):
    eng = ServingEngine(tm, device="cpu", **{**KW, **kw})
    rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    while eng.has_work:
        eng.step()
        if check_every_step:
            eng.alloc.check()
            if eng.index is not None:
                eng.index.check(eng.alloc)
    streams = [list(map(int, eng.finished[r].tokens)) for r in rids]
    stats = eng.stats()
    assert_pages_home(eng)
    return streams, stats


VARIANTS = [(False, None), (True, None), (False, 8), (True, 8), (True, 5)]


@pytest.mark.parametrize("prefix_cache,chunk", VARIANTS,
                         ids=[f"cache{int(c)}-chunk{k}" for c, k in VARIANTS])
def test_cache_and_chunking_streams_match_jax(prefix_cache, chunk):
    jm, tm, _ = model_pair(MHA)
    prompts, lens = _shared_prefix_case(MHA["vocab_size"])
    kw = dict(prefix_cache=prefix_cache, prefill_chunk=chunk)
    ref, jeng = _jax_streams(jm, prompts, lens, **kw)
    got, st = _port_streams(tm, prompts, lens, check_every_step=True, **kw)
    assert got == ref
    assert len({tuple(x) for x in got}) > 1
    js = jeng.stats()
    for key in ("prefill_tokens_saved", "prefill_tokens_computed",
                "prefill_dispatches", "copy_dispatches", "prefix_hit_rate"):
        assert st[key] == js[key], key
    if prefix_cache:
        assert st["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("prefix_cache,chunk", [(True, None), (True, 5)],
                         ids=["cache1-chunkNone", "cache1-chunk5"])
def test_spec_cache_streams_match_jax(prefix_cache, chunk):
    jm, tm, _ = model_pair(GQA)
    prompts, lens = _shared_prefix_case(GQA["vocab_size"], seed=1)
    kw = dict(prefix_cache=prefix_cache, prefill_chunk=chunk, speculate=4)
    ref, _ = _jax_streams(jm, prompts, lens, **kw)
    got, st = _port_streams(tm, prompts, lens, **kw)
    assert got == ref
    assert st["verify_dispatches"] > 0 and st["prefill_tokens_saved"] > 0
    off, _ = _port_streams(tm, prompts, lens, prefix_cache=False)
    assert got == off


@pytest.mark.parametrize("prefix_cache,chunk,spec",
                         [(True, None, 0), (True, 5, 0), (True, 8, 3)],
                         ids=["chunkNone", "chunk5", "chunk8-spec3"])
def test_kv_quant_cache_streams_match_jax(prefix_cache, chunk, spec):
    jm, tm, _ = model_pair(MHA)
    prompts, lens = _shared_prefix_case(MHA["vocab_size"], seed=2)
    kw = dict(prefix_cache=prefix_cache, prefill_chunk=chunk,
              kv_quant="int8", speculate=spec)
    ref, _ = _jax_streams(jm, prompts, lens, **kw)
    got, st = _port_streams(tm, prompts, lens, check_every_step=True, **kw)
    assert got == ref
    assert st["prefill_tokens_saved"] > 0


def test_kv_quant_prefix_cache_hits_equal_cache_off():
    """The int8 hits (JAX ``test_kv_quant_prefix_cache_hit_identity``):
    cold pages aliased into a new table, the copy-on-write page (the
    repeated bare prompt matches a partial page) and decode-written
    pages read under their own scales; streams equal the cache-off run
    and JAX's."""
    jm, tm, _ = model_pair(MHA)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, MHA["vocab_size"], size=24).astype(np.int32)
    tails = [rng.integers(0, MHA["vocab_size"], size=n).astype(np.int32)
             for n in (3, 5)]
    reqs = [prompt] + [np.concatenate([prompt, x]) for x in tails] + [prompt]
    lens = [6, 8, 7, 5]
    kw = dict(slots=1, kv_quant="int8")
    cold, _ = _port_streams(tm, reqs, lens, prefix_cache=False, **kw)
    hit, st = _port_streams(tm, reqs, lens, **kw)
    ref, _ = _jax_streams(jm, reqs, lens, **kw)
    assert hit == cold == ref
    assert st["prefill_tokens_saved"] > 0 and st["copy_dispatches"] >= 1


def test_prefix_index_follows_jax():
    """One random sequence of register / match / touch_cold / revive /
    evict_cold_leaf over chains that share prefixes: both indexes give
    the same results and pass ``check()`` after every call."""
    ps = 4
    rng = np.random.default_rng(0)
    ours, ref = PrefixIndex(ps), JaxPrefixIndex(ps)
    seqs = [list(rng.integers(0, 5, size=n)) for n in (12, 16, 9)]
    next_page = 0
    for step in range(300):
        op = rng.integers(0, 5)
        if op == 0:  # register a sequence's pages, sharing a prefix
            base = seqs[rng.integers(len(seqs))]
            cut = int(rng.integers(0, len(base) + 1))
            seq = base[:cut] + list(rng.integers(0, 5, size=rng.integers(
                1, 3 * ps)))
            seqs.append(seq)
            p_ours = p_ref = -1
            for i in range(len(seq) // ps):
                chunk = seq[i * ps : (i + 1) * ps]
                a = ours.register(p_ours, chunk, next_page)
                b = ref.register(p_ref, chunk, next_page)
                assert a == b
                next_page += 1
                p_ours, p_ref = a, b
        elif op == 1:  # match a known sequence, maybe cut, maybe extended
            seq = seqs[rng.integers(len(seqs))]
            toks = seq[: rng.integers(0, len(seq) + 1)] + list(
                rng.integers(0, 5, size=rng.integers(0, 3)))
            assert ours.match(toks) == ref.match(toks)
            for parent in (-1, *ref._meta):
                chunk = list(rng.integers(0, 5, size=ps))
                assert ours.lookup(parent, chunk) == ref.lookup(parent, chunk)
        elif op in (2, 3) and len(ref):
            page = int(rng.choice(sorted(ref._meta)))
            if op == 2:
                ours.touch_cold(page)
                ref.touch_cold(page)
            else:
                ours.revive(page)
                ref.revive(page)
        elif op == 4:
            assert ours.evict_cold_leaf() == ref.evict_cold_leaf()
        ours.check()
        ref.check()
        assert (len(ours), ours.cold_pages) == (len(ref), ref.cold_pages)
        assert all((p in ours) == (p in ref) for p in range(next_page + 1))
    while (victim := ref.evict_cold_leaf()) is not None:
        assert ours.evict_cold_leaf() == victim
    assert ours.evict_cold_leaf() is None


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_copy_page_matches_jax(quant):
    rng = np.random.default_rng(4)
    shape = (2, 6, 2, 8, 4)  # [L, NP, Hkv, C, PS]
    if quant:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        sk = np.exp2(rng.integers(-9, -3, size=shape[:3])).astype(np.float32)
        sv = np.exp2(rng.integers(-9, -3, size=shape[:3])).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        sk = sv = None
    jpool = JaxPagedKVPool(
        k=jnp.asarray(k), v=jnp.asarray(v), page_size=shape[-1],
        scale_k=None if sk is None else jnp.asarray(sk),
        scale_v=None if sv is None else jnp.asarray(sv))
    pool = PagedKVPool(t(k), t(v), shape[-1], *(
        (None, None) if sk is None else (t(sk), t(sv))))
    jpool = jax_copy_page(jpool, jnp.asarray(1, jnp.int32),
                          jnp.asarray(4, jnp.int32))
    copy_page(pool, 1, 4)
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(jpool.k))
    np.testing.assert_array_equal(pool.v.numpy(), np.asarray(jpool.v))
    if quant:
        assert not np.array_equal(sk[:, 1], sk[:, 4])  # the copy moved them
        np.testing.assert_array_equal(pool.scale_k.numpy(),
                                      np.asarray(jpool.scale_k))
        np.testing.assert_array_equal(pool.scale_v.numpy(),
                                      np.asarray(jpool.scale_v))
        np.testing.assert_array_equal(pool.scale_k[:, 4].numpy(), sk[:, 1])


def test_shared_prefix_skips_prefill_compute():
    """A repeated 24-token prompt: the second admission computes only its
    last token; 16 tokens ride two shared pages and 7 the copy-on-write
    page; both requests' streams equal, and JAX's."""
    jm, tm, _ = model_pair(MHA)
    prompt = np.random.default_rng(5).integers(
        0, MHA["vocab_size"], size=24).astype(np.int32)
    eng = ServingEngine(tm, slots=1, page_size=8, window=4, device="cpu")
    r1 = eng.submit(prompt, 6)
    eng.run()
    assert eng.prefill_tokens_computed == 24
    r2 = eng.submit(prompt, 6)
    fin = eng.run()
    assert eng.prefill_tokens_computed - 24 == 1
    assert eng.prompt_tokens_cached == 23 == fin[r2].cached_tokens
    assert eng.copy_dispatches == 1
    st = eng.stats()
    assert st["prefill_tokens_saved"] == 23 and st["prefix_hit_rate"] > 0
    assert fin[r1].tokens == fin[r2].tokens
    ref, _ = _jax_streams(jm, [prompt], [6], slots=1)
    assert fin[r2].tokens == ref[0]


def test_multiturn_hits_decode_written_pages():
    """Turn 2's prompt is turn 1's prompt, its generated tokens and a
    reply, so its hit covers pages the decode windows wrote; streams
    equal the cache-off run's."""
    _, tm, _ = model_pair(MHA)
    p0 = np.random.default_rng(6).integers(
        0, MHA["vocab_size"], size=12).astype(np.int32)

    def run(cache):
        eng = ServingEngine(tm, slots=1, page_size=8, window=4,
                            prefix_cache=cache, device="cpu")
        ra = eng.submit(p0, 10)
        a = eng.run()[ra].tokens
        turn2 = np.concatenate([p0, np.asarray(a, np.int32),
                                np.asarray([7, 3], np.int32)])
        rb = eng.submit(turn2, 10)
        return a, eng.run()[rb].tokens, eng

    a_on, b_on, eng = run(True)
    a_off, b_off, _ = run(False)
    assert (a_on, b_on) == (a_off, b_off)
    assert eng.prompt_tokens_cached > len(p0)  # past the prompt's pages


def test_chunked_prefill_interleaves_with_decode():
    """With a budget of one 8-token chunk a window, a 48-token prompt's
    prefill spreads over windows while a running request keeps decoding;
    both streams equal the one-pass engine's."""
    _, tm, _ = model_pair(MHA)
    rng = np.random.default_rng(7)
    short = rng.integers(0, MHA["vocab_size"], size=4).astype(np.int32)
    long = rng.integers(0, MHA["vocab_size"], size=48).astype(np.int32)
    eng = ServingEngine(tm, slots=2, page_size=8, window=4, prefill_chunk=8,
                        prefill_budget=8, device="cpu")
    r_short = eng.submit(short, 16)
    eng.step()
    req = eng.slot_req[0]
    before = len(req.tokens)
    r_long = eng.submit(long, 8)
    eng.step()
    eng.step()
    assert eng.prefilling.any(), "the long prompt is still prefilling"
    assert len(req.tokens) > before, "decode starved during the prefill"
    fin = eng.run()
    assert eng.prefill_dispatches >= 7
    one_pass = ServingEngine(tm, slots=2, page_size=8, window=4,
                             device="cpu")
    ra, rb = one_pass.submit(short, 16), one_pass.submit(long, 8)
    ref = one_pass.run()
    assert fin[r_short].tokens == ref[ra].tokens
    assert fin[r_long].tokens == ref[rb].tokens


def test_sharing_invariants_every_step_under_pressure():
    """A shared-prefix trace on 10 pages with chunked prefill: after every
    step the allocator and the index hold their invariants, every page a
    slot may write (not indexed) has one reference and one table, and
    the streams equal those of a pool with room for all."""
    _, tm, _ = model_pair(MHA)
    rng = np.random.default_rng(8)
    sys_prompt = rng.integers(0, MHA["vocab_size"], size=16)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, MHA["vocab_size"], size=2 + i)]).astype(np.int32)
        for i in range(6)]
    eng = ServingEngine(tm, slots=2, page_size=8, num_pages=10, window=4,
                        prefill_chunk=8, device="cpu")
    rids = [eng.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        assert steps < 500
        eng.alloc.check()
        eng.index.check(eng.alloc)
        for s in eng._active_slots():
            for pg in eng.slot_pages[s]:
                if pg in eng.index:
                    continue  # full and indexed: never written again
                assert eng.alloc.refcount(pg) == 1
                assert [v for v in eng._active_slots()
                        if pg in eng.slot_pages[v]] == [s]
    got = [eng.finished[r].tokens for r in rids]
    assert eng.stats()["prefill_tokens_saved"] > 0
    assert_pages_home(eng)
    roomy = ServingEngine(tm, slots=2, page_size=8, window=4, device="cpu")
    rr = [roomy.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
    ref = roomy.run()
    assert got == [ref[r].tokens for r in rr]


def test_admission_needs_reservation_less_matched_pages():
    """A 4-page pool, one slot, the trace through the port's engine and
    JAX's, their counts held equal after every step. A 22-token request
    (17 prompt + 5 new) runs, then retires its two full pages cold. A
    request sharing both pages reserves its prompt's 3 pages less the 2
    matched: the free list holds it, nothing is reclaimed. A request
    sharing nothing reserves its prompt's 3 pages, which takes one cold
    page (leaf first); its growth to 4 pages takes the other."""
    jm, tm, _ = model_pair(MHA)
    rng = np.random.default_rng(9)
    a = rng.integers(0, MHA["vocab_size"], size=17).astype(np.int32)
    other = rng.integers(0, MHA["vocab_size"], size=20).astype(np.int32)
    kw = dict(slots=1, page_size=8, num_pages=4, window=4)
    eng = ServingEngine(tm, device="cpu", **kw)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32,
                            paged_kernel="pallas", **kw)

    def counts(e):
        return (len(e._active_slots()), len(e.queue), e.cold_reclaims,
                e.prompt_tokens_cached, e.alloc.free_pages,
                e.alloc.cached_pages, e.evictions)

    def step_both():
        eng.step()
        jeng.step()
        assert counts(eng) == counts(jeng)

    def drain_both():
        while eng.has_work or jeng.has_work:
            step_both()

    for e in (eng, jeng):
        e.submit(a, 5)
    drain_both()
    assert (eng.alloc.cached_pages, eng.alloc.free_pages) == (2, 2)
    for e in (eng, jeng):
        e.submit(np.concatenate([a, [1]]).astype(np.int32), 6)
    step_both()
    assert eng.prompt_tokens_cached == 16 and eng.cold_reclaims == 0
    drain_both()
    for e in (eng, jeng):
        e.submit(other, 12)
    step_both()
    assert eng.cold_reclaims == 1 and eng._active_slots() == [0]
    drain_both()
    assert eng.cold_reclaims == 2
    for r, req in eng.finished.items():
        assert req.tokens == list(map(int, jeng.finished[r].tokens))
    assert_pages_home(eng)
