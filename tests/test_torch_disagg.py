"""Disaggregated prefill/decode pools, the page handoff and prefix-affinity
routing: the port's ``ServingCluster`` against the JAX package's, on the
CPU.

The model, knobs and lockstep are ``test_torch_cluster``'s: the same
weights in both packages, f32 pools, ``slots=2, page_size=8, window=4``,
and after every cluster step the invariants on every live engine of
both clusters and their agreement on routes, records between pools,
health and every ``stats()`` key (``handoffs``,
``handoff_pages_moved``, ``handoff_bytes``, ``prefix_affinity_hits``,
``routed_fallback`` ...). Greedy streams equal JAX's and the monolithic
engine's token for token.

Ported from ``tests/test_serving_disagg.py`` (1+1 with the role split,
1+1 / 2+1 / 2+2 placement, the chain on both sides of a handoff, a
cancel of a record between pools, affinity against least-loaded on a
Zipf tenant trace, the imbalance cap, the feature matrix across splits,
eviction around handoffs), the handoff cases of
``tests/test_serving_faults.py`` (a failed export served again cold, a
prefill replica's crash, the whole prefill pool dead),
``tests/test_telemetry.py`` (the stats contract of a disaggregated
cluster, the handoff spans of the Chrome trace) and
``tests/test_serving_longctx.py`` (a handoff whose chain is partly
spilled on the prefill replica). The matrix's sampled case is held port
against port (JAX's random bits are not the port's); JAX's ``layer_scan``
case has no counterpart (the port runs unrolled layers). The engine's
seam alone: ``export_request`` then ``import_request`` carries pages,
scale planes and the logits row bit for bit, and the record's bytes are
JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import FaultPlan as JaxFaultPlan
from midgpt_tpu.serving import ServingCluster as JaxServingCluster
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu_torch.serving import (
    CLUSTER_STATS_KEYS,
    FaultPlan,
    HandoffFailed,
    ServingCluster,
    ServingEngine,
    chrome_trace,
)

from torch_port_util import (
    assert_clusters_agree,
    check_engines,
    cluster_lockstep,
    cluster_streams,
    model_pair,
)

torch.set_num_threads(2)

CFG = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)
VOCAB = CFG["vocab_size"]
KW = dict(slots=2, page_size=8, window=4)
SPLITS = [(1, 1), (2, 1), (2, 2)]


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


def _clusters(models, plan=None, **kw):
    jm, tm = models
    kw = {**KW, **kw}
    tkw, jkw = dict(kw), dict(kw)
    if plan is not None:
        tkw["fault_plan"] = FaultPlan.parse(plan)
        jkw["fault_plan"] = JaxFaultPlan.parse(plan)
    return (ServingCluster(tm, device="cpu", **tkw),
            JaxServingCluster(jm, cache_dtype=jnp.float32, **jkw))


def _mono(tm, prompts, n_new, **kw):
    eng = ServingEngine(tm, device="cpu", **{**KW, **kw})
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run(400)
    return [[int(x) for x in fin[r].tokens] for r in rids]


def _split(split):
    return dict(prefill_replicas=split[0], decode_replicas=split[1])


def _lockstep_run(models, prompts, n_new, plan=None, **kw):
    cl, jc = _clusters(models, plan=plan, **kw)
    rids = [cl.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    for i, p in enumerate(prompts):
        jc.submit(p, n_new, seed=i)
    cluster_lockstep(cl, jc)
    got = cluster_streams(cl, rids)
    assert sorted(cl.finished) == sorted(rids), "every request finishes"
    assert got == cluster_streams(jc, rids)
    return cl, jc, got


# -- streams and the role split -------------------------------------------------


def test_disagg_1p1_streams_match_jax_and_monolithic(models):
    """Prefill on replica 0, page handoff, decode on replica 1: the
    streams equal JAX's and the monolithic engine's, every request hands
    off once, and the roles held (the prefill replica never decoded, the
    decode replica never prefilled)."""
    prompts = _prompts(4, base_len=5, stride=2)
    cl, _, got = _lockstep_run(models, prompts, 8, **_split((1, 1)))
    assert got == _mono(models[1], prompts, 8)
    st = cl.stats()
    assert st["handoffs"] == len(prompts) and st["handoff_failures"] == 0
    assert st["handoff_pages_moved"] > 0 and st["handoff_bytes"] > 0
    assert st["prefill_replicas"] == 1 and st["decode_replicas"] == 1
    pre, dec = cl.engines
    assert pre.decode_dispatches == 0 and pre.prefill_dispatches > 0
    assert dec.decode_dispatches > 0 and dec.prefill_dispatches == 0


@pytest.mark.parametrize("split", SPLITS, ids=["1+1", "2+1", "2+2"])
def test_disagg_split_placement_invariance(models, split):
    """The pool split changes latency, never tokens."""
    prompts = _prompts(4, base_len=5, stride=2)
    cl, _, got = _lockstep_run(models, prompts, 8, **_split(split))
    assert got == _mono(models[1], prompts, 8)
    assert cl.stats()["handoffs"] == len(prompts)


def test_disagg_cluster_stats_same_contract(models):
    """A disaggregated cluster answers the same key tuple; the snapshot
    carries the handoff counters."""
    cl, _, _ = _lockstep_run(models, _prompts(3), 6, **_split((1, 1)))
    st = cl.stats()
    assert tuple(st) == CLUSTER_STATS_KEYS
    assert st["handoffs"] == 3
    snap = cl.metrics_snapshot()["cluster"]
    assert snap["handoffs"] == st["handoffs"]
    assert snap["handoff_bytes"] == st["handoff_bytes"] > 0


def test_chrome_trace_handoff_spans_match_jax(models):
    """Handoffs render as spans in their own lane (tid 3) of the prefill
    replica's dispatch process, with pages and bytes; the decode
    replica's lane holds decode windows alone; every replica's events
    equal JAX's."""
    prompts = _prompts(3)
    cl, jc, _ = _lockstep_run(models, prompts, 6, telemetry=True,
                              **_split((1, 1)))
    assert ([t.sequence_signature() for t in cl.telemetries]
            == [t.sequence_signature() for t in jc.telemetries])
    pre, dec = cl.engines
    spans = [e for e in chrome_trace(pre.telemetry)["traceEvents"]
             if e["ph"] == "X" and e["pid"] == 2]
    hand = [e for e in spans if e["name"] == "handoff"]
    assert len(hand) == len(prompts) and {e["tid"] for e in hand} == {3}
    jhand = [d for d in jc.engines[0].telemetry.dispatches
             if d.kind == "handoff"]
    assert [(e["args"]["pages"], e["args"]["bytes"]) for e in hand] == [
        (d.data["pages"], d.data["bytes"]) for d in jhand]
    assert all(e["args"]["pages"] > 0 and e["args"]["bytes"] > 0
               for e in hand)
    assert not any(e["name"] == "decode_window" for e in spans)
    dspans = [e for e in chrome_trace(dec.telemetry)["traceEvents"]
              if e["ph"] == "X" and e["pid"] == 2]
    assert dspans and all(e["name"] == "decode_window" for e in dspans)


def test_handoff_registers_the_chain_on_both_sides(models):
    """Export retires the source chain cold (the prefill replica keeps
    serving hits on it); import registers it in the destination's index;
    a repeat prompt prefills from the prefill replica's cache."""
    prompt = np.random.default_rng(9).integers(0, VOCAB, 33).astype(np.int32)
    cl, jc = _clusters(models, **_split((1, 1)))
    r0 = cl.submit(prompt, 6, seed=0)
    jc.submit(prompt, 6, seed=0)
    cluster_lockstep(cl, jc)
    pre, dec = cl.engines
    probe = [int(x) for x in prompt[:-1]]
    assert pre.index.match(probe)[2] > 0
    assert dec.index.match(probe)[2] > 0
    saved0 = pre.prompt_tokens_cached
    r1 = cl.submit(prompt, 6, seed=0)
    jc.submit(prompt, 6, seed=0)
    cluster_lockstep(cl, jc)
    assert pre.prompt_tokens_cached > saved0
    assert cluster_streams(cl, [r1]) == cluster_streams(cl, [r0])


def test_cancel_catches_a_request_between_pools(models):
    """With one decode slot the second request waits exported, as a
    record; cancel finds it there: the record drops, nothing leaks, it is
    never served again, and the other request finishes."""
    prompts = _prompts(2, base_len=5, stride=2)
    cl, jc = _clusters(models, slots=1, **_split((1, 1)))
    rids = [cl.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
    for i, p in enumerate(prompts):
        jc.submit(p, 12, seed=i)
    for _ in range(100):
        if cl._handoff:
            break
        cl.step()
        jc.step()
        check_engines(cl)
        assert_clusters_agree(cl, jc)
    assert cl._handoff
    (grid,) = cl._handoff
    assert cl.lookup(grid) is not None
    assert cl.cancel(grid) is True and jc.cancel(grid) is True
    assert grid not in cl._handoff and grid not in cl._route
    assert cl.cancelled[grid].outcome == "cancelled"
    assert cl.cancel(grid) is False
    cluster_lockstep(cl, jc)
    cl._harvest()
    assert [r for r in rids if r in cl.finished] == [
        r for r in rids if r != grid]
    check_engines(cl)


# -- prefix affinity ------------------------------------------------------------


def _zipf_trace(n_requests=12, n_tenants=3, sys_len=24, seed=0):
    """Each request: one of ``n_tenants`` system prompts (Zipf weights)
    and a token of its own."""
    rng = np.random.default_rng(seed)
    tenants = [np.random.default_rng(50 + t).integers(
        0, VOCAB, sys_len).astype(np.int32) for t in range(n_tenants)]
    w = 1.0 / np.arange(1, n_tenants + 1)
    w /= w.sum()
    return [np.concatenate([tenants[rng.choice(n_tenants, p=w)],
                            np.asarray([i % VOCAB], np.int32)])
            for i in range(n_requests)]


def test_affinity_beats_least_loaded_on_a_zipf_trace(models):
    """Arrivals between steps (the router sees resident state): affinity
    gives a strictly higher hit rate than least-loaded at equal streams
    and tokens, each affinity or fallback admission where JAX's made it;
    affinity hits and fallbacks count every request."""
    trace = _zipf_trace()
    out = {}
    for aff in (False, True):
        cl, jc = _clusters(models, replicas=2, affinity=aff)
        rids = []
        for i, p in enumerate(trace):
            rids.append(cl.submit(p, 6, seed=i))
            jc.submit(p, 6, seed=i)
            cl.step()
            jc.step()
            check_engines(cl)
            assert_clusters_agree(cl, jc)
        cluster_lockstep(cl, jc)
        st = cl.stats()
        out[aff] = (cluster_streams(cl, rids),
                    st["prefill_tokens_saved"] / st["prompt_tokens_total"],
                    st["tokens_generated"], st)
    (s_off, hit_off, tok_off, _), (s_on, hit_on, tok_on, st) = (
        out[False], out[True])
    assert s_on == s_off and tok_on == tok_off
    assert hit_on > hit_off, (hit_on, hit_off)
    assert st["prefix_affinity_hits"] > 0
    assert st["prefix_affinity_hits"] + st["routed_fallback"] == len(trace)


@pytest.mark.parametrize("cap,want", [(0, 1), (4, 0)], ids=["cap0", "cap4"])
def test_affinity_load_imbalance_cap(models, cap, want):
    """Replica 0 holds the prefix and one more request than replica 1:
    with ``affinity_max_imbalance=0`` the cache replica is barred (a
    fallback), with 4 the hit justifies the gap."""
    prompt = np.random.default_rng(3).integers(0, VOCAB, 33).astype(np.int32)
    filler = _prompts(1, base_len=6, stride=0)[0]
    cl, jc = _clusters(models, replicas=2, affinity=True,
                       affinity_max_imbalance=cap)
    for c in (cl, jc):
        c.submit(prompt, 6, seed=0)
        c.run()
        c.submit(filler, 6, seed=1)
        rid = c.submit(prompt, 6, seed=2)
        assert c._route[rid][0] == want
    assert_clusters_agree(cl, jc)
    if cap == 0:
        assert cl.routed_fallback >= 1
    else:
        assert cl.prefix_affinity_hits >= 1


# -- the feature matrix, eviction, spill ------------------------------------------

MATRIX = [
    dict(prefix_cache=False),
    dict(prefix_cache=True, prefill_chunk=4),
    dict(kv_quant="int8"),
    dict(speculate=2),
]


@pytest.mark.parametrize("extra", MATRIX,
                         ids=["cache-off", "chunk", "kvq", "spec"])
@pytest.mark.parametrize("split", SPLITS, ids=["1+1", "2+1", "2+2"])
def test_disagg_matrix_across_splits(models, extra, split):
    """Cache off, chunked prefill, an int8 pool (scale planes in the
    record) and speculation, each across every split: JAX's streams and
    the monolithic engine's."""
    prompts = _prompts(4, base_len=5, stride=2)
    cl, _, got = _lockstep_run(models, prompts, 8, **extra, **_split(split))
    assert got == _mono(models[1], prompts, 8, **extra)
    assert cl.stats()["handoffs"] >= len(prompts)


@pytest.mark.parametrize("split", SPLITS, ids=["1+1", "2+1", "2+2"])
def test_disagg_sampled_speculation_across_splits(models, split):
    """Sampled speculation (T 0.8, top-k 12) through the handoff: the
    monolithic port engine's streams (port against port)."""
    _, tm = models
    prompts = _prompts(4, base_len=5, stride=2)
    kw = dict(speculate=2, temperature=0.8, top_k=12)
    cl = ServingCluster(tm, device="cpu", **KW, **kw, **_split(split))
    rids = [cl.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
    while cl.has_work:
        cl.step()
        check_engines(cl)
    assert cluster_streams(cl, rids) == _mono(tm, prompts, 8, **kw)
    assert cl.stats()["handoffs"] >= len(prompts)


def test_disagg_eviction_under_pressure_around_handoffs(models):
    """A pool too small for every request evicts on both pools while
    handoffs run (an evicted decode slot prefills again locally): the
    invariants hold every step and the streams equal the monolithic
    engine's under the same pressure, and JAX's."""
    prompts = _prompts(4, base_len=9, stride=3)
    kw = dict(page_size=4, num_pages=8)
    cl, _, got = _lockstep_run(models, prompts, 10, **kw, **_split((1, 1)))
    assert got == _mono(models[1], prompts, 10, **kw)
    st = cl.stats()
    assert st["evictions"] > 0 and st["handoffs"] >= len(prompts)


def test_disagg_handoff_of_a_partially_spilled_chain(models):
    """Spill on the prefill replica: turn 1 hands off and its chain
    retires cold there; two of its deepest pages are spilled; turn 2
    (turn 1's prompt and tokens and five new ones) matches the partly
    spilled chain, faults it back and hands off, with the monolithic
    engine's two turns and JAX's."""
    _, tm = models
    kw = dict(prefill_chunk=8, prefix_cache=True, spill="on")
    a = np.random.default_rng(1000).integers(0, VOCAB, 26).astype(np.int32)
    mono = ServingEngine(tm, device="cpu", **KW, **kw)
    r1 = mono.submit(a, 8, seed=0)
    ref1 = [int(x) for x in mono.run()[r1].tokens]
    b = np.concatenate([a, np.asarray(ref1, np.int32),
                        np.random.default_rng(1001).integers(
                            0, VOCAB, 5).astype(np.int32)])
    r2 = mono.submit(b, 8, seed=1)
    ref2 = [int(x) for x in mono.run()[r2].tokens]
    cl, jc = _clusters(models, **kw, **_split((1, 1)))
    rid1 = cl.submit(a, 8, seed=0)
    jc.submit(a, 8, seed=0)
    cluster_lockstep(cl, jc)
    assert cluster_streams(cl, [rid1]) == [ref1]
    for c in (cl, jc):
        pre = next(e for e in c.engines if e.role == "prefill")
        chain = pre.alloc.cached_pages
        assert chain >= 3
        pre._try_reserve(pre.alloc.free_pages + 2)  # spill the 2 coldest
        assert pre.stats()["spilled_pages"] == 2
        assert 0 < pre.stats()["spill_resident_pages"] < chain
        pre.index.check(pre.alloc, pre._spill_store)
    assert_clusters_agree(cl, jc)
    rid2 = cl.submit(b, 8, seed=1)
    jc.submit(b, 8, seed=1)
    cluster_lockstep(cl, jc)
    assert cluster_streams(cl, [rid2]) == [ref2]
    assert cl.engines[0].stats()["spill_faultback_pages"] > 0


# -- handoff faults -------------------------------------------------------------

HANDOFF_FAULTS = {
    # the next export fails: the copy is abandoned, served again cold
    "handoff": dict(plan="2:handoff@0", split=(1, 1)),
    # a prefill replica dies before its first handoff: its requests go
    # to the surviving prefill replica
    "prefill_crash": dict(plan="1:crash@0", split=(2, 1)),
    # the whole prefill pool dies: the decode pool serves alone
    "prefill_pool_dead": dict(plan="2:crash@0", split=(1, 1)),
}


@pytest.mark.parametrize("case", list(HANDOFF_FAULTS))
def test_handoff_faults_match_jax(models, case):
    """Each handoff fault keeps the fault-free streams, step for step with
    JAX's cluster."""
    jm, tm = models
    prompts = _prompts(4, base_len=5, stride=2)
    refs = _mono(tm, prompts, 8)
    c = HANDOFF_FAULTS[case]
    cl, _, got = _lockstep_run(models, prompts, 8, plan=c["plan"],
                               **_split(c["split"]))
    assert got == refs
    st = cl.stats()
    assert st["faults_injected"] == 1
    if case == "handoff":
        assert cl.health == ["healthy", "healthy"]
        assert st["handoff_failures"] == 1 and st["requeued_requests"] >= 1
        assert st["handoffs"] == len(prompts)
    elif case == "prefill_crash":
        assert cl.health == ["dead", "healthy", "healthy"]
        assert st["failovers"] == 1 and st["requeued_requests"] >= 1
        assert st["handoffs"] == len(prompts)
        assert st["handoff_failures"] == 0
    else:
        assert cl.health == ["dead", "healthy"]
        assert st["failovers"] == 1 and st["handoff_failures"] == 0


# -- the engine's seam ------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_export_import_round_trip_is_bit_exact(models, kv_quant):
    """A prefill-role engine's handoff-ready slot exported and imported
    into a fresh engine: the destination's pages (and scale planes) and
    logits row equal the source's bit for bit, the record's bytes equal
    JAX's record's, and a poisoned export raises before the slot
    changes."""
    jm, tm = models
    prompt = np.random.default_rng(7).integers(0, VOCAB, 21).astype(np.int32)
    kw = dict(KW, kv_quant=kv_quant)
    src = ServingEngine(tm, device="cpu", role="prefill", **kw)
    jsrc = JaxServingEngine(jm, cache_dtype=jnp.float32, role="prefill", **kw)
    for e in (src, jsrc):
        e.submit(prompt, 8, seed=0)
        while not e.handoff_ready_slots():
            e.step()
    (s,) = src.handoff_ready_slots()
    assert src.decode_dispatches == 0 and not src._decoding_slots()
    n = -(-int(src.pooled_len[s]) // 8)
    ids = [int(x) for x in src.bt[s, :n]]
    planes = [src.pool.k, src.pool.v] + (
        [src.pool.scale_k, src.pool.scale_v] if kv_quant else [])
    before = [a[:, ids].clone() for a in planes]
    row = src.logits[s].clone()
    src._handoff_poison = True
    with pytest.raises(HandoffFailed):
        src.export_request(s)
    assert src.handoff_ready_slots() == [s]
    rec = src.export_request(s)
    jrec = jsrc.export_request(jsrc.handoff_ready_slots()[0])
    assert rec.nbytes == jrec.nbytes and rec.n_pages == jrec.n_pages == n
    assert rec.ctx == [int(x) for x in jrec.ctx] and rec.ready is None
    assert src.alloc.held_pages == 0 and not src.handoff_ready_slots()
    dst = ServingEngine(tm, device="cpu", role="decode", **kw)
    rid = dst.import_request(rec)
    (t,) = dst._active_slots()
    got_ids = [int(x) for x in dst.bt[t, :n]]
    dplanes = [dst.pool.k, dst.pool.v] + (
        [dst.pool.scale_k, dst.pool.scale_v] if kv_quant else [])
    for a, b in zip(dplanes, before):
        assert torch.equal(a[:, got_ids], b)
    assert torch.equal(dst.logits[t], row)
    assert dst.lookup(rid) is rec.req and dst._decoding_slots() == [t]
    dst.run()
    assert dst.finished[rid].tokens == _mono(tm, [prompt], 8, **{
        k: v for k, v in kw.items() if k not in KW})[0]
    with pytest.raises(ValueError):
        src.export_request(0)
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", role="router", **KW)
