"""The port's cold-page host spill against the JAX package's.

A 2-layer model (block 64, vocab 96, 4 heads, D = 32) gets the same
weights in both packages (``torch_port_util.model_pair``); both engines
serve f32 pools on the CPU, JAX's through its plain paged path. Ported
from the single-engine spill tests of ``tests/test_serving_longctx.py``:

- under a pool too small for the trace's chains, greedy streams equal the
  JAX engine's and the ample pool's, and a resubmission faults the spilled
  prefix back byte for byte (float and int8 pools: the scale planes
  travel with their pages); sampled streams equal the ample pool's (port
  against port: JAX's random bits cannot be matched);
- prefetch on queue batches the fault-backs: fewer ``import_pages`` calls
  on the resubmissions' path than fault on match, the same streams;
- a host budget discards the oldest spilled prefixes; the store's
  ``nbytes`` is a running count equal to JAX's for the same payloads; a
  fault-back's chain is protected from its own budget pass; a COW source
  that was spilled comes back before its copy; the invariants hold after
  every step of a busy trace; a long prompt in an undersized pool
  finishes;
- step for step against the JAX engine: the slots' requests, the block
  tables, the spilled virtual ids in spill order, every ``stats()`` key
  and every live gauge (the host store's bytes among them), and both
  ``check``s (the allocator, the index with the spill store) after
  every step;
- ``PrefixIndex``'s spill half follows JAX's through one random sequence
  of calls; ``export_pages`` payloads equal JAX's bit for bit (bf16
  compared as int16 against uint16, int8 with its scale planes), and
  ``import_pages`` is their exact inverse.

Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midgpt_tpu_torch.serving.engine as engine_mod
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving.paged import HostSpillStore as JaxHostSpillStore
from midgpt_tpu.serving.paged import PagedKVPool as JaxPagedKVPool
from midgpt_tpu.serving.paged import PrefixIndex as JaxPrefixIndex
from midgpt_tpu.serving.paged import export_pages as jax_export_pages
from midgpt_tpu_torch.serving import (
    ENGINE_STATS_KEYS,
    HostSpillStore,
    PagedKVPool,
    PrefixIndex,
    ServingEngine,
    export_pages,
    import_pages,
    pages_needed,
)

from torch_port_util import model_pair, t

torch.set_num_threads(2)

CFG = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)
VOCAB = CFG["vocab_size"]
KW = dict(slots=2, window=4, page_size=8, prefill_chunk=8)
MAX_STEPS = 600


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def models():
    jm, tm, _ = model_pair(CFG)
    return jm, tm


def _prompts(n, base_len=5, stride=3, seed0=100):
    return [np.random.default_rng(seed0 + i).integers(
        0, VOCAB, size=base_len + stride * i).astype(np.int32)
        for i in range(n)]


def _port(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**KW, **kw})


def _jax(jm, **kw):
    return JaxServingEngine(jm, cache_dtype=jnp.float32, **{**KW, **kw})


def _serve(eng, prompts, n_new):
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run(MAX_STEPS)
    return [list(map(int, fin[r].tokens)) for r in rids]


def _check(eng):
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc, eng._spill_store)


def _force_spill(eng, k=None):
    """Spill ``k`` cold pages (all when None) through the engine's own
    reservation path."""
    target = eng.alloc.num_pages if k is None else eng.alloc.free_pages + k
    eng._try_reserve(target)


# -- streams under pressure ----------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_spill_streams_and_faultback_match_jax(models, kv_quant):
    """A pool too small for the chains: cold pages spill instead of being
    reclaimed, streams equal the ample pool's and the JAX engine's; the
    same prompts again walk onto spilled nodes and fault them back (an
    int8 pool's scale planes with them), the same streams again."""
    jm, tm = models
    prompts = _prompts(4 if kv_quant is None else 3, base_len=22, stride=0,
                       seed0=300 if kv_quant is None else 400)
    num_pages = 8 if kv_quant is None else 7
    kw = dict(kv_quant=kv_quant)
    ref = _serve(_port(tm, **kw), prompts, 12)
    eng = _port(tm, num_pages=num_pages, spill="on", **kw)
    jeng = _jax(jm, num_pages=num_pages, spill="on", **kw)
    got, jgot = _serve(eng, prompts, 12), _serve(jeng, prompts, 12)
    assert got == jgot == ref
    assert eng.stats()["spilled_pages"] > 0
    _check(eng)
    again, jagain = _serve(eng, prompts, 12), _serve(jeng, prompts, 12)
    assert again == jagain == ref
    st = eng.stats()
    assert st["spill_faultback_pages"] > 0
    assert st == jeng.stats()
    _check(eng)


def test_spill_sampled_streams_equal_ample_pool(models):
    """Sampled streams (T 0.8, top-k 16): pressure, spill and fault-back
    move no draw (port against port)."""
    _, tm = models
    prompts = _prompts(3, base_len=22, stride=0, seed0=500)
    kw = dict(temperature=0.8, top_k=16)
    ref = _serve(_port(tm, **kw), prompts, 12)
    eng = _port(tm, num_pages=7, spill="on", **kw)
    assert _serve(eng, prompts, 12) == ref
    assert eng.stats()["spilled_pages"] > 0
    _check(eng)


def test_spill_prefetch_batches_faultbacks(models, monkeypatch):
    """Prefetch on queue fetches the queue head's spilled chain in one
    batched ``import_pages`` call a step: fewer import calls on the
    resubmissions' path than fault on match, the same streams as JAX's in
    both modes."""
    jm, tm = models
    prompts = _prompts(4, base_len=22, stride=0, seed0=700)
    ref = _serve(_port(tm), prompts, 12)
    real = engine_mod.import_pages
    calls, stats = {}, {}
    for mode in ("off", "on"):
        counter = {"n": 0}

        def counting(*a, _c=counter, **k):
            _c["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(engine_mod, "import_pages", counting)
        eng = _port(tm, num_pages=8, spill="on", spill_prefetch=mode)
        jeng = _jax(jm, num_pages=8, spill="on", spill_prefetch=mode)
        assert _serve(eng, prompts, 12) == _serve(jeng, prompts, 12) == ref
        assert eng.stats()["spill_resident_pages"] > 0
        base = counter["n"]
        assert _serve(eng, prompts, 12) == _serve(jeng, prompts, 12) == ref
        _check(eng)
        calls[mode] = counter["n"] - base
        stats[mode] = eng.stats()
        assert stats[mode] == jeng.stats()
    assert stats["off"]["spill_prefetch_pages"] == 0
    assert stats["on"]["spill_prefetch_pages"] > 0
    assert stats["on"]["spill_faultback_pages"] > 0
    assert 0 < calls["on"] < calls["off"], (calls, stats)


def test_spill_budget_discards_oldest(models):
    """``spill_budget_pages=3``: past it the oldest spilled prefixes are
    forgotten, streams unchanged, JAX's counts."""
    jm, tm = models
    prompts = _prompts(5, base_len=22, stride=0, seed0=600)
    ref = _serve(_port(tm), prompts, 12)
    kw = dict(num_pages=8, spill="on", spill_budget_pages=3)
    eng, jeng = _port(tm, **kw), _jax(jm, **kw)
    assert _serve(eng, prompts, 12) == _serve(jeng, prompts, 12) == ref
    st = eng.stats()
    assert st["spilled_pages"] > 0 and st["spill_discards"] > 0
    assert st["spill_resident_pages"] <= 3
    assert st == jeng.stats()
    _check(eng)


def test_store_nbytes_and_protected_discard():
    """``HostSpillStore.nbytes`` is a running count, equal to JAX's store
    for the same payloads; ``discard_spilled_oldest`` honours ``protect``
    and goes leaf first, as JAX's."""
    x = np.arange(8, dtype=np.float32)
    ours, ref = HostSpillStore(budget_pages=1), JaxHostSpillStore(
        budget_pages=1)
    for node, pl in ((-2, (x, x, None, None)), (-3, (x, x, x, x))):
        ours.put(node, tuple(None if a is None else torch.from_numpy(a)
                             for a in pl))
        ref.put(node, pl)
        assert ours.nbytes == ref.nbytes and ours.over_budget == \
            ref.over_budget
    assert ours.nbytes == 6 * x.nbytes
    ours.pop(-2)
    assert ours.nbytes == 4 * x.nbytes and len(ours) == 1
    ours.pop(-3)
    assert ours.nbytes == 0
    with pytest.raises(ValueError):
        HostSpillStore(budget_pages=-1)

    for idx in (PrefixIndex(2), JaxPrefixIndex(2)):
        p0 = idx.register(PrefixIndex._ROOT, (1, 2), 0)
        p1 = idx.register(p0, (3, 4), 1)
        idx.touch_cold(p1)
        idx.touch_cold(p0)
        v1 = idx.spill(p1)  # deepest first: the tail spills oldest
        v0 = idx.spill(p0)
        assert (v1, v0) == (-2, -3)
        assert idx.discard_spilled_oldest({v0, v1}) is None
        assert idx.discard_spilled_oldest({v1}) is None  # v0 has a child
        assert idx.discard_spilled_oldest() == v1
        assert idx.discard_spilled_oldest({v1}) == v0


def test_budget_discard_protects_inflight_faultback_chain(models):
    """A fault-back's own reservation may spill past the budget; the
    discard pass must not drop the chain it is bringing back (the store
    overshoots until the fault-back pops them)."""
    _, tm = models
    a = _prompts(1, base_len=20, stride=0, seed0=800)[0]  # 2 full pages
    b = _prompts(1, base_len=28, stride=0, seed0=801)[0]
    ref = _serve(_port(tm), [a], 3)
    eng = _port(tm, spill="on", spill_budget_pages=2, num_pages=4)
    assert _serve(eng, [a], 3) == ref
    _force_spill(eng)  # a's chain to the host, the store at its budget
    assert len(eng._spill_store) == 2
    eng.submit(b, 3, seed=1)
    eng.run(MAX_STEPS)  # b's cold chain holds all but one page
    assert eng.alloc.free_pages == 1
    eng._spill_store.budget_pages = 1
    assert _serve(eng, [a], 3) == ref
    st = eng.stats()
    assert st["spill_faultback_pages"] >= 2 and st["spill_discards"] > 0
    _check(eng)


def test_cow_on_spilled_parent_page(models):
    """B is A's first 12 tokens: it matches A's first page and 4 tokens
    into the second, spilled, which comes back from the host before it is
    copied. The streams equal the no-spill run's and JAX's."""
    jm, tm = models
    a = _prompts(1, base_len=16, stride=0, seed0=700)[0]
    b = a[:12]
    ref = _serve(_port(tm), [a, b], 8)
    outs = []
    for eng in (_port(tm, spill="on"), _jax(jm, spill="on")):
        got_a = _serve(eng, [a], 8)
        _force_spill(eng)
        assert eng.stats()["spilled_pages"] >= 2
        assert eng.index.coldest_leaf() is None
        got_b = _serve(eng, [b], 8)
        assert eng.stats()["spill_faultback_pages"] >= 2
        assert eng.stats()["copy_dispatches"] >= 1
        outs.append(got_a + got_b)
    assert outs[0] == outs[1] == ref
    _check(eng)


def test_spill_invariants_every_step(models):
    """A shared-prefix trace in spill mode under pressure: after every
    step the allocator, the index and the store agree, every slot page is
    resident, and a writable page has one owner."""
    _, tm = models
    sys_prompt = _prompts(1, base_len=16, seed0=800)[0]
    prompts = [np.concatenate([sys_prompt, tail])
               for tail in _prompts(6, base_len=2, stride=1, seed0=810)]
    eng = _port(tm, num_pages=10, spill="on")
    rids = [eng.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
        assert steps < MAX_STEPS
        _check(eng)
        spilled = {n for n in eng.index._meta if eng.index.is_spilled(n)}
        assert len(spilled) == len(eng._spill_store)
        for s in eng._active_slots():
            for pg in eng.slot_pages[s]:
                assert pg >= 0 and not eng.index.is_spilled(pg)
                if pg not in eng.index:
                    assert eng.alloc.refcount(pg) == 1
    assert eng.alloc.held_pages == 0
    assert eng.alloc.free_pages + eng.alloc.cached_pages == \
        eng.alloc.num_pages
    assert all(len(eng.finished[r].tokens) == 10 for r in rids)
    assert eng.stats()["spilled_pages"] > 0


def test_long_prompt_completes_in_undersized_pool(models):
    """8 pages against a 7-page request and short ones beside it: parking
    and spill absorb the pressure, every stream equals the ample pool's
    and JAX's, nothing is deferred or shed, and the long chain comes back
    from the host for a resubmission."""
    jm, tm = models
    long_p = _prompts(1, base_len=40, stride=0, seed0=1100)[0]
    shorts = _prompts(4, base_len=6, stride=0, seed0=1110)
    assert pages_needed(len(long_p) + 16, 8) == 7
    ref_long = _serve(_port(tm), [long_p], 16)
    ref_short = _serve(_port(tm), shorts, 8)
    streams = []
    for eng in (_port(tm, num_pages=8, spill="on"),
                _jax(jm, num_pages=8, spill="on")):
        rl = eng.submit(long_p, 16, seed=0)
        rs = [eng.submit(p, 8, seed=1 + i) for i, p in enumerate(shorts)]
        steps = 0
        while eng.queue or eng._active_slots():
            eng.step()
            steps += 1
            assert steps < MAX_STEPS
            _check(eng)
        fin = eng.finished
        st = eng.stats()
        assert st["spilled_pages"] > 0
        assert st["deferred_submits"] == 0 and st["shed_requests"] == 0
        r2 = eng.submit(long_p, 16, seed=0)
        eng.run(MAX_STEPS)
        streams.append([list(map(int, fin[r].tokens)) for r in [rl, *rs, r2]])
        _check(eng)
    assert streams[0] == streams[1] == [ref_long[0], *ref_short, ref_long[0]]


# -- step for step against the JAX engine ---------------------------------------

TRACES = [
    pytest.param(dict(), id="prefetch"),
    pytest.param(dict(spill_prefetch="off"), id="faultback"),
    pytest.param(dict(spill_budget_pages=2), id="budget"),
    pytest.param(dict(kv_quant="int8"), id="int8"),
    pytest.param(dict(speculate=3), id="spec3"),
]


@pytest.mark.parametrize("kw", TRACES)
def test_spill_trace_step_for_step_matches_jax(models, kw):
    """Two rounds of the same four prompts (the second walks onto spilled
    nodes) through both engines in lockstep: after every step the slots'
    requests, the block tables, the spilled virtual ids in spill order and
    every ``stats()`` key agree, and both engines pass both checks."""
    jm, tm = models
    prompts = _prompts(4, base_len=22, stride=0, seed0=900)
    kw = dict(num_pages=8, spill="on", **kw)
    eng, jeng = _port(tm, **kw), _jax(jm, **kw)
    seen_faultback = False
    for _ in range(2):
        rids = [eng.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
        jrids = [jeng.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
        assert rids == jrids
        steps = 0
        while eng.has_work or jeng.has_work:
            eng.step()
            jeng.step()
            steps += 1
            assert steps < MAX_STEPS
            _check(eng)
            _check(jeng)
            assert [r and r.rid for r in eng.slot_req] == \
                [r and r.rid for r in jeng.slot_req]
            np.testing.assert_array_equal(eng.bt, jeng.bt)
            assert list(eng.index._spilled) == list(jeng.index._spilled)
            ours, ref = eng.stats(), jeng.stats()
            assert tuple(ours) == ENGINE_STATS_KEYS
            assert ours == ref
            # the live gauges, spill_resident_bytes (the store's nbytes)
            # among them
            assert eng.metrics_snapshot()["gauges"] == \
                jeng.metrics_snapshot()["gauges"]
            seen_faultback |= ours["spill_faultback_pages"] > 0
        assert [eng.finished[r].tokens for r in rids] == \
            [list(map(int, jeng.finished[r].tokens)) for r in rids]
    assert eng.stats()["spilled_pages"] > 0 and seen_faultback


# -- the index, the payloads -----------------------------------------------------


def test_prefix_index_spill_half_follows_jax():
    """One random sequence of register / match / touch_cold / revive /
    coldest_leaf + spill / unspill / discard_spilled_oldest /
    evict_cold_leaf: both indexes give the same ids, matches and victims
    and pass ``check()`` after every call."""
    ps = 4
    rng = np.random.default_rng(1)
    ours, ref = PrefixIndex(ps), JaxPrefixIndex(ps)
    seqs = [list(rng.integers(0, 4, size=n)) for n in (12, 16, 9)]
    next_page = 0
    for _ in range(400):
        op = int(rng.integers(0, 8))
        if op == 0:
            base = seqs[rng.integers(len(seqs))]
            cut = int(rng.integers(0, len(base) + 1))
            seq = base[:cut] + list(rng.integers(0, 4, size=rng.integers(
                1, 3 * ps)))
            seqs.append(seq)
            p_ours = p_ref = -1
            for i in range(len(seq) // ps):
                chunk = seq[i * ps : (i + 1) * ps]
                if p_ref in ref._spilled:
                    break  # a resident page never chains under a virtual id
                a = ours.register(p_ours, chunk, next_page)
                b = ref.register(p_ref, chunk, next_page)
                assert a == b
                next_page += 1
                p_ours, p_ref = a, b
        elif op == 1:
            seq = seqs[rng.integers(len(seqs))]
            toks = seq[: rng.integers(0, len(seq) + 1)]
            assert ours.match(toks) == ref.match(toks)
        elif op in (2, 3):
            resident = sorted(p for p in ref._meta if p >= 0)
            if resident:
                page = int(rng.choice(resident))
                if op == 2:
                    ours.touch_cold(page)
                    ref.touch_cold(page)
                else:
                    ours.revive(page)
                    ref.revive(page)
        elif op == 4:
            victim = ref.coldest_leaf()
            assert ours.coldest_leaf() == victim
            if victim is not None:
                assert ours.spill(victim) == ref.spill(victim)
        elif op == 5 and ref.spilled_count:
            # unspill the shallowest spilled node (its parent is resident)
            vid = next(v for v in ref._spilled
                       if not ref.is_spilled(ref._meta[v][0]))
            ours.unspill(vid, next_page)
            ref.unspill(vid, next_page)
            next_page += 1
        elif op == 6:
            protect = set(list(ref._spilled)[:1])
            assert ours.discard_spilled_oldest(protect) == \
                ref.discard_spilled_oldest(protect)
        elif op == 7:
            assert ours.evict_cold_leaf() == ref.evict_cold_leaf()
        ours.check()
        ref.check()
        assert ours._meta == ref._meta
        assert list(ours._spilled) == list(ref._spilled)
        assert ours.spilled_count == ref.spilled_count
    assert ref.spilled_count or ref._next_spill < -2


def _pools(quant: bool, dtype):
    """The same random pool in both packages: ``[L, NP, Hkv, C, PS]``
    payloads (bf16 built from the same bits) and, for int8, po2 scales."""
    rng = np.random.default_rng(3)
    shape = (2, 7, 2, 8, 4)
    if quant:
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8)
                for _ in range(2))
        sk, sv = (np.exp2(rng.integers(-9, -3, size=shape[:3]))
                  .astype(np.float32) for _ in range(2))
        tk, tv = t(k), t(v)
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        sk = sv = None
        tk, tv = t(k).to(dtype), t(v).to(dtype)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    scales = (None, None) if sk is None else (t(sk), t(sv))
    pool = PagedKVPool(tk, tv, shape[-1], *scales)
    jpool = JaxPagedKVPool(
        k=jk, v=jv, page_size=shape[-1],
        scale_k=None if sk is None else jnp.asarray(sk),
        scale_v=None if sv is None else jnp.asarray(sv))
    return pool, jpool


@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_export_pages_matches_jax_and_import_inverts(case):
    """``export_pages`` of pages (3, 0, 5) equals JAX's bit for bit, scale
    planes included; ``import_pages`` of the payload into other pages of a
    scribbled pool restores them bit for bit, and refuses a payload
    without its scales or of the wrong dtype."""
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    pool, jpool = _pools(case == "int8", dtype)
    ids = [3, 0, 5]
    got = export_pages(pool, ids)
    ref = jax_export_pages(jpool, ids)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
            continue
        assert tuple(a.shape) == b.shape
        if case == "bf16":
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(b).view(np.uint16).astype(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    before = [x.clone() for x in (pool.k, pool.v, pool.scale_k, pool.scale_v)
              if x is not None]
    for x in (pool.k, pool.v):
        x[:, [1, 2, 6]] = x[:, [6, 6, 6]] if case == "int8" else 0
    if pool.quantized:
        pool.scale_k[:, [1, 2, 6]] = 7.0
        pool.scale_v[:, [1, 2, 6]] = 7.0
    import_pages(pool, [1, 2, 6], *got)
    after = [x for x in (pool.k, pool.v, pool.scale_k, pool.scale_v)
             if x is not None]
    for a, b in zip(after, before):
        assert torch.equal(a[:, [1, 2, 6]], b[:, ids])
    if pool.quantized:
        with pytest.raises(ValueError):
            import_pages(pool, [1, 2, 6], got[0], got[1])
    else:
        with pytest.raises(ValueError):
            import_pages(pool, [1, 2, 6], got[0].double(), got[1])
    with pytest.raises(ValueError):
        import_pages(pool, [1, 2], *got)
