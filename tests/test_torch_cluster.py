"""The port's ``ServingCluster`` against the JAX package's, on the CPU.

A 2-layer model gets the same weights in both packages
(``torch_port_util.model_pair``); engines run f32 pools, ``slots=2,
page_size=8, window=4``, as JAX's own cluster tests run. Each trace goes
through both clusters in lockstep (``cluster_lockstep``): after every
cluster step the allocator and prefix-index invariants hold on every
live engine of both, and the two agree on each request's replica and
engine id, health and its reasons, and every ``stats()`` key (the
inventory is ``CLUSTER_STATS_KEYS``, ``per_replica`` included). Greedy
streams then equal JAX's token for token and the monolithic engine's;
with tracing on, each replica's event sequence equals its JAX twin's.

Ported from ``tests/test_serving_faults.py`` (a rejection uses no id,
a full queue spills over, crash, transient retry and exhaustion, the
watchdog's cold failover, every replica dead, the composite chaos plan
over the cache x chunk x speculation x int8 pool matrix, flight dumps
and replay), ``tests/test_telemetry.py`` (the stats contract and its
aggregation, the Prometheus expansion) and ``tests/test_frontdoor.py``
(the tie-break and placement, a cancel routed to its owner, the chaos +
cancel + deadline composite and its matrix). Port against port, since
JAX's random bits cannot be matched: sampled streams do not depend on
placement or on a failover. Also the port's own surfaces:
``serving_devices``, ``devices=``, a shared telemetry instance refused,
and kernel loading from the replicas' worker threads (one build, a
partial file named by process and thread).
"""

import asyncio
import json
import os
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import AsyncFrontDoor as JaxAsyncFrontDoor
from midgpt_tpu.serving import ClusterUnavailable as JaxClusterUnavailable
from midgpt_tpu.serving import FaultPlan as JaxFaultPlan
from midgpt_tpu.serving import ServingCluster as JaxServingCluster
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving import VirtualClock as JaxVirtualClock
from midgpt_tpu_torch.serving import (
    CLUSTER_STATS_KEYS,
    ENGINE_STATS_KEYS,
    AdmissionRejected,
    AsyncFrontDoor,
    ClusterUnavailable,
    EngineTelemetry,
    FaultPlan,
    ServingCluster,
    ServingEngine,
    VirtualClock,
    serving_devices,
)
from midgpt_tpu_torch.telemetry import prometheus_text

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
# the watchdog and the scripted stall past it (JAX's tests: 0.5 and 1.5 s;
# wider here, so a round of the JAX cluster that compiles a program
# under a loaded test machine does not trip it)
WATCHDOG_S, WEDGE_S = 1.0, 2.5


@pytest.fixture(autouse=True)
def _no_grad():
    # this thread's; the replicas' worker threads serve under the
    # engine's own no_grad dispatches
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
    """The port's cluster (CPU) and JAX's on the same knobs; ``plan`` a
    fault plan spec for both."""
    jm, tm = models
    kw = {**KW, **kw}
    tkw, jkw = dict(kw), dict(kw)
    if plan is not None:
        tkw["fault_plan"] = FaultPlan.parse(plan)
        jkw["fault_plan"] = JaxFaultPlan.parse(plan)
    return (ServingCluster(tm, device="cpu", **tkw),
            JaxServingCluster(jm, cache_dtype=jnp.float32, **jkw))


def _mono(tm, prompts, n_new, seeds=None, **kw):
    """The monolithic port engine's streams (request seed = index)."""
    eng = ServingEngine(tm, device="cpu", **{**KW, **kw})
    seeds = range(len(prompts)) if seeds is None else seeds
    rids = [eng.submit(p, n_new, seed=s) for p, s in zip(prompts, seeds)]
    fin = eng.run(400)
    return [[int(x) for x in fin[r].tokens] for r in rids]


def _lockstep_run(models, prompts, n_new, plan=None, **kw):
    """Submit ``prompts`` to both clusters and drive them in lockstep;
    returns (port cluster, JAX cluster, port streams)."""
    cl, jc = _clusters(models, plan=plan, **kw)
    rids = [cl.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    jrids = [jc.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    assert rids == jrids
    assert_clusters_agree(cl, jc)
    cluster_lockstep(cl, jc)
    got = cluster_streams(cl, rids)
    assert sorted(cl.finished) == sorted(rids), "every request finishes"
    assert got == cluster_streams(jc, rids)
    return cl, jc, got


# -- replicas: streams, placement, stats ---------------------------------------

REPLICA_CASES = [
    dict(replicas=2),
    dict(replicas=3),
    dict(replicas=2, prefill_chunk=4),
    dict(replicas=3, prefix_cache=False),
    dict(replicas=2, speculate=2),
    dict(replicas=2, kv_quant="int8"),
]


@pytest.mark.parametrize(
    "kw", REPLICA_CASES,
    ids=["r2", "r3", "r2-chunk", "r3-nocache", "r2-spec", "r2-kvq8"])
def test_cluster_streams_and_stats_match_jax(models, kw):
    """Least-loaded admission with the lowest-index tie-break places each
    request where JAX's does, every step agrees, and every greedy stream
    equals JAX's and the monolithic engine's: placement never changes a
    token."""
    prompts = _prompts(5, base_len=5, stride=2)
    cl, _, got = _lockstep_run(models, prompts, 8, **kw)
    eng_kw = {k: v for k, v in kw.items() if k != "replicas"}
    assert got == _mono(models[1], prompts, 8, **eng_kw)
    assert all(e.tokens_generated > 0 for e in cl.engines)


def test_cluster_stats_key_contract_and_aggregation(models):
    """``stats()`` has exactly ``CLUSTER_STATS_KEYS``, each replica's
    exactly ``ENGINE_STATS_KEYS``; the counters sum over replicas; a
    cluster that is not disaggregated reports the handoff and routing
    counters as zeros; the snapshot is JSON."""
    prompts = _prompts(4)
    cl, _, got = _lockstep_run(models, prompts, 8, replicas=2)
    st = cl.stats()
    assert tuple(st) == CLUSTER_STATS_KEYS
    per = st["per_replica"]
    assert len(per) == 2 and all(tuple(p) == ENGINE_STATS_KEYS for p in per)
    for k in ("decode_dispatches", "tokens_generated", "windows",
              "prompt_tokens_total"):
        assert st[k] == sum(p[k] for p in per)
    assert st["tokens_generated"] == sum(len(x) for x in got)
    assert st["prefill_replicas"] == 0 and st["decode_replicas"] == 0
    for k in ("handoffs", "handoff_pages_moved", "handoff_bytes",
              "handoff_failures", "prefix_affinity_hits", "routed_fallback"):
        assert st[k] == 0, k
    json.dumps(cl.metrics_snapshot())


def test_prometheus_text_expands_a_clusters_replicas(models):
    """A cluster's snapshot renders per-replica series and the cluster's
    numbers as ``scope="cluster"`` gauges, as JAX's does."""
    cl, jc, _ = _lockstep_run(models, _prompts(4), 8, replicas=2)
    text = prometheus_text(cl.metrics_snapshot())
    assert 'midgpt_tokens_generated_total{replica="0"}' in text
    assert 'midgpt_tokens_generated_total{replica="1"}' in text
    assert 'midgpt_failovers{scope="cluster"} 0' in text
    assert 'midgpt_dp_replicas{scope="cluster"} 2' in text
    assert cl.metrics_snapshot()["cluster"] == jc.metrics_snapshot()[
        "cluster"]


def test_cluster_passes_rejection_through_without_using_an_id(models):
    cl, jc = _clusters(models, replicas=2, slots=1, page_size=4,
                       num_pages=2, window=2)
    for c, exc in ((cl, AdmissionRejected), (jc, Exception)):
        with pytest.raises(exc):
            c.submit(np.zeros(4, np.int32), 8)
        assert not c._route and c._next_rid == 0
    assert cl.stats()["reject_reasons"] == {"lifetime_exceeds_pool": 1}
    assert_clusters_agree(cl, jc)


def test_cluster_submit_spills_over_a_full_queue(models):
    """The least-loaded replica's full queue sends the request to the
    next replica in load order; only when every queue is full does the
    overload outcome surface (here the shed policy's rejection)."""
    prompts = _prompts(4, base_len=4, stride=0)
    cl, jc = _clusters(models, replicas=2, max_queue=1,
                       overload_policy="shed")
    for c in (cl, jc):
        # replica 1: two running requests (load 2, queue 0); replica 0: a
        # full queue (load 1)
        c.engines[1].submit(prompts[0], 16)
        c.engines[1].step()
        c.engines[1].submit(prompts[1], 16)
        c.engines[1].step()
        assert len(c.engines[1]._active_slots()) == 2
        c.engines[0].submit(prompts[2], 8)
        rid = c.submit(prompts[3], 8)
        assert c._route[rid][0] == 1
    with pytest.raises(AdmissionRejected) as exc:
        cl.submit(prompts[3], 8)
    assert exc.value.reason == "queue_full"
    with pytest.raises(Exception):
        jc.submit(prompts[3], 8)
    assert_clusters_agree(cl, jc)


def test_cluster_tiebreak_and_placement_match_jax(models):
    """Equal loads go to the lowest index, so placement replays: the same
    trace routes the same way twice, 0, 1, 2 first, and as JAX's."""
    prompts = _prompts(6, base_len=4, stride=1)

    def routes(c):
        for i, p in enumerate(prompts):
            c.submit(p, 6, seed=i)
        return [c._route[g][0] for g in sorted(c._route)]

    r1 = routes(_clusters(models, replicas=3)[0])
    cl, jc = _clusters(models, replicas=3)
    assert routes(cl) == r1 == routes(jc)
    assert r1[:3] == [0, 1, 2]


# -- failover -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_case(models):
    """The fault-free streams of four requests on one engine of each
    package (which also warms JAX's programs, so the watchdog's timing
    sees no compile)."""
    jm, tm = models
    prompts = _prompts(4, base_len=5, stride=2)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32, **KW)
    jr = [jeng.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
    fin = jeng.run()
    refs = _mono(tm, prompts, 8)
    assert refs == [[int(x) for x in fin[r].tokens] for r in jr]
    return prompts, refs


FAILOVER_CASES = {
    # replica 0 crashes with tokens emitted: warm failover
    "crash": dict(plan="2:crash@0", replicas=2),
    # one transient: the same replica retries, no failover
    "transient": dict(plan="2:transient@0", replicas=2, backoff_s=0.0),
    # step 2 raises, the retries re-enter step() at 3, 4, 5
    "transient_exhausted": dict(
        plan="2:transient@0;3:transient@0;4:transient@0;5:transient@0",
        replicas=2, max_retries=3, backoff_s=0.0),
    # a stall past the watchdog: cold failover, the engine abandoned
    "wedge": dict(plan=f"2:wedge@0:{WEDGE_S}", replicas=2,
                  dispatch_timeout_s=WATCHDOG_S),
}


@pytest.mark.parametrize("case", list(FAILOVER_CASES))
def test_cluster_failover_matches_jax(models, ref_case, case):
    """Each failure path of the health machine: the survivors finish
    every request with the fault-free streams, and health, its reasons,
    the retries, trips, failovers and requeues equal JAX's at every
    step."""
    prompts, refs = ref_case
    cl, _, got = _lockstep_run(models, prompts, 8, **FAILOVER_CASES[case])
    assert got == refs
    st = cl.stats()
    assert st["faults_injected"] >= 1
    if case == "crash":
        assert cl.health == ["dead", "healthy"]
        assert cl.health_reason[0] == "crashed"
        assert st["failovers"] == 1 and st["requeued_requests"] >= 1
        assert cl.engines[0].tokens_generated >= 1  # progress kept
    elif case == "transient":
        assert cl.health == ["healthy", "healthy"]
        assert st["retries"] == 1 and st["failovers"] == 0
        assert st["watchdog_trips"] == 0
    elif case == "transient_exhausted":
        assert cl.health_reason[0] == "transient_exhausted"
        assert st["retries"] == 3 and st["failovers"] == 1
    else:
        assert cl.health == ["dead", "healthy"]
        assert cl.health_reason[0] == "wedged"
        assert st["watchdog_trips"] == 1 and st["failovers"] == 1
        # cold: the abandoned engine was never drained
        assert cl.engines[0]._active_slots()
        assert st["requeued_requests"] >= 1


def test_all_replicas_dead_raises_cluster_unavailable(models, ref_case):
    prompts, _ = ref_case
    cl, jc = _clusters(models, plan="1:crash@0;1:crash@1", replicas=2)
    for c in (cl, jc):
        for i, p in enumerate(prompts):
            c.submit(p, 8, seed=i)
    with pytest.raises(ClusterUnavailable) as exc:
        cl.run()
    with pytest.raises(JaxClusterUnavailable) as jexc:
        jc.run()
    assert str(exc.value) == str(jexc.value)
    assert cl.health == jc.health == ["dead", "dead"]
    with pytest.raises(ClusterUnavailable):
        cl.submit(prompts[0], 8)


# transient (retried) then a crash on replica 0, every free page of
# replica 1 held for 2 steps, a wedge on replica 2: replica 1 survives
CHAOS = f"2:transient@0;4:crash@0;3:exhaust@1:all:2;3:wedge@2:{WEDGE_S}"
CHAOS_MATRIX = [
    dict(prefix_cache=True),
    dict(prefix_cache=False),
    dict(prefix_cache=False, prefill_chunk=8),
    dict(prefix_cache=True, prefill_chunk=8, speculate=4),
    dict(prefix_cache=True, speculate=4, kv_quant="int8"),
]


@pytest.mark.parametrize(
    "kw", CHAOS_MATRIX,
    ids=["cache", "nocache", "chunked", "cache-chunk-spec",
         "cache-spec-kvq8"])
def test_chaos_composite_plan_matches_jax(models, kw):
    """Crash, wedge, transient and exhaustion in one scripted plan on
    three replicas: every request finishes with the fault-free streams,
    no page stays quarantined, each step agrees with JAX's cluster, and
    the run replays."""
    jm, tm = models
    prompts = _prompts(6, base_len=5, stride=2)
    prompts = [np.concatenate([prompts[0][:4], p]) if i % 2 else p
               for i, p in enumerate(prompts)]
    refs = _mono(tm, prompts, 16, **kw)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32, **KW, **kw)
    jr = [jeng.submit(p, 16, seed=i) for i, p in enumerate(prompts)]
    jfin = jeng.run()  # JAX's programs compiled before the watchdog runs
    assert refs == [[int(x) for x in jfin[r].tokens] for r in jr]
    chaos = dict(plan=CHAOS, replicas=3, dispatch_timeout_s=WATCHDOG_S,
                 max_retries=2, backoff_s=0.0, **kw)
    cl, _, got = _lockstep_run(models, prompts, 16, **chaos)
    assert got == refs
    assert cl.health[1] == "healthy" and "dead" in cl.health
    st = cl.stats()
    assert st["failovers"] >= 1 and st["faults_injected"] >= 3
    assert all(e.alloc.quarantined_pages == 0 for e in cl.engines)
    cl2 = ServingCluster(tm, device="cpu", fault_plan=FaultPlan.parse(CHAOS),
                         **{k: v for k, v in chaos.items() if k != "plan"},
                         **KW)
    rids = [cl2.submit(p, 16, seed=i) for i, p in enumerate(prompts)]
    cl2.run()
    assert cluster_streams(cl2, rids) == got and cl2.health == cl.health


def test_chaos_telemetry_flight_dumps_and_replay(models, ref_case, tmp_path):
    """Every terminal path with tracing on and ``flight_dir`` set: crash
    (warm), wedge past the watchdog (cold), exhausted retries. The
    survivors' streams are the fault-free ones, each dead replica leaves
    one dump holding the injection that killed it, and each replica's
    event sequence equals its JAX twin's and a replay's."""
    prompts, refs = ref_case
    spec = (f"2:crash@0;2:wedge@1:{WEDGE_S};2:transient@2;3:transient@2;"
            "4:transient@2")
    jm, tm = models

    def run(sub, jax_too=False):
        d = tmp_path / sub
        d.mkdir()
        kw = dict(replicas=4, dispatch_timeout_s=WATCHDOG_S, max_retries=2,
                  backoff_s=0.0, telemetry=True, flight_dir=str(d))
        cl, jc = _clusters(models, plan=spec, **kw)
        rids = [cl.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
        if jax_too:
            for i, p in enumerate(prompts):
                jc.submit(p, 8, seed=i)
            cluster_lockstep(cl, jc)
            assert ([t.sequence_signature() for t in cl.telemetries]
                    == [t.sequence_signature() for t in jc.telemetries])
        else:
            cl.run()
        return cl, cluster_streams(cl, rids)

    cl, got = run("a", jax_too=True)
    assert got == refs
    assert cl.health == ["dead", "dead", "dead", "healthy"]
    assert {os.path.basename(p) for p in cl.flight_dumps} == {
        "flight_replica0_crashed.json", "flight_replica1_wedged.json",
        "flight_replica2_transient_exhausted.json"}
    for p in cl.flight_dumps:
        rec = json.load(open(p))
        assert any(e["kind"] == "fault" for e in rec["telemetry"]["events"])
        assert rec["stats"]["faults_injected"] >= 1 and "replica" in rec
    sigs = [t.sequence_signature() for t in cl.telemetries]
    assert all(sigs)
    cl2, got2 = run("b")
    assert got2 == got
    assert [t.sequence_signature() for t in cl2.telemetries] == sigs


# -- sampled streams, port against port -----------------------------------------


def test_sampled_streams_do_not_depend_on_placement_or_failover(models):
    """At temperature 0.8 with top-k a request's stream is a function of
    the request: one engine, three replicas and a crash's warm failover
    give the same streams (JAX's random bits are not the port's)."""
    _, tm = models
    prompts = _prompts(5, base_len=5, stride=2)
    kw = dict(temperature=0.8, top_k=12)
    ref = _mono(tm, prompts, 10, **kw)
    assert len({tuple(x) for x in ref}) > 1
    for extra in (dict(replicas=3),
                  dict(replicas=2, fault_plan=FaultPlan.parse("2:crash@0"))):
        cl = ServingCluster(tm, device="cpu", **KW, **kw, **extra)
        rids = [cl.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
        cl.run()
        check_engines(cl)
        assert cluster_streams(cl, rids) == ref, extra


# -- the port's own surfaces ------------------------------------------------------


def test_serving_devices_and_devices_argument(models):
    """``serving_devices`` takes the first ``dp_replicas`` devices, with
    a replica's tensor ranks on its one device (``tp_size > 1``: a
    loopback mesh, ``serving_meshes(..., loopback=True)``); ``devices=``
    of one device gives replica i ``devices[i]`` and serves as
    ``replicas=N`` does, and several distinct devices are refused
    (ROADMAP Q9)."""
    _, tm = models
    assert serving_devices(1, 2, ["cpu", "cpu", "cpu"]) == [
        torch.device("cpu")] * 2
    assert serving_devices(2, 1, ["cpu", "cpu"]) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        serving_devices(1, 3, ["cpu", "cpu"])
    prompts = _prompts(4)
    a = ServingCluster(tm, devices=serving_devices(1, 2, ["cpu"] * 2), **KW)
    b = ServingCluster(tm, replicas=2, device="cpu", **KW)
    assert [e.device for e in a.engines] == [torch.device("cpu")] * 2
    assert all(e.model is tm for e in a.engines)  # one model, shared
    out = []
    for c in (a, b):
        rids = [c.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
        c.run()
        out.append(cluster_streams(c, rids))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        ServingCluster(tm, devices=["cpu"], device="cpu", **KW)
    with pytest.raises(ValueError):
        ServingCluster(tm, replicas=3, devices=["cpu"] * 2, **KW)
    with pytest.raises(NotImplementedError, match="Q9"):
        ServingCluster(tm, devices=["cpu", "meta"], **KW)


def test_replicas_of_one_device_step_in_turn(models):
    """Replicas on one device step in turn on the caller's thread; a
    watchdog needs a worker thread it can abandon, so with one the same
    replicas step on the pool. The streams and every stats() key are the
    same either way."""
    _, tm = models
    prompts = _prompts(5)
    out = []
    for kw in (dict(), dict(dispatch_timeout_s=600.0)):
        cl = ServingCluster(tm, replicas=3, device="cpu", **KW, **kw)
        assert (cl._pool is None) == (not kw)
        rids = [cl.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
        cl.run()
        out.append((cluster_streams(cl, rids), cl.stats()))
    assert out[0] == out[1]


def test_shared_telemetry_instance_refused_for_several_replicas(models):
    _, tm = models
    with pytest.raises(ValueError, match="telemetry=True"):
        ServingCluster(tm, replicas=2, device="cpu",
                       telemetry=EngineTelemetry(), **KW)
    cl = ServingCluster(tm, replicas=2, device="cpu", telemetry=True, **KW)
    t0, t1 = cl.telemetries
    assert t0 is not None and t1 is not None and t0 is not t1


# -- the front door over a cluster ------------------------------------------------


async def _drain_all(fd):
    while await fd.pump():
        pass


def test_frontdoor_cancel_routes_to_owner(models):
    """A cancel through the front door follows the cluster's route to the
    replica that holds the request; the cluster's terminal dicts mirror
    it and the route drops, as in JAX's front door."""
    jm, tm = models
    prompts = _prompts(4)

    async def go(cl, fd_cls):
        fd = fd_cls(cl, check_invariants=True)
        streams = [await fd.submit(p, 16, seed=i)
                   for i, p in enumerate(prompts)]
        while not streams[2].tokens:
            await fd.pump()
        owner = cl._route[streams[2].rid][0]
        streams[2].cancel()
        await _drain_all(fd)
        return streams, owner

    cl, jc = _clusters(models, replicas=2)
    streams, owner = asyncio.run(go(cl, AsyncFrontDoor))
    jstreams, jowner = asyncio.run(go(jc, JaxAsyncFrontDoor))
    assert owner == jowner == 0
    assert streams[2].outcome == "cancelled"
    assert streams[2].rid in cl.cancelled and streams[2].rid not in cl._route
    assert cl.engines[owner].cancelled_requests == 1
    assert [s.outcome for s in streams] == [s.outcome for s in jstreams]
    assert [s.tokens for s in streams] == [
        [int(x) for x in s.tokens] for s in jstreams]
    assert cl.stats()["cancelled_requests"] == 1
    assert_clusters_agree(cl, jc)


FRONTDOOR_CHAOS = [dict(), dict(prefill_chunk=8, speculate=4)]


@pytest.mark.parametrize("kw", FRONTDOOR_CHAOS, ids=["base", "chunk-spec"])
def test_frontdoor_chaos_cancel_crash_deadline_composite(models, kw):
    """A replica crash while a cancel and a deadline shed flow through the
    front door, on a virtual clock advanced a unit a pump: outcomes,
    streams, health and each replica's event sequence equal JAX's front
    door's and a replay's; finished streams are the fault-free ones,
    cancelled and expired ones a prefix of them."""
    jm, tm = models
    prompts = _prompts(6, base_len=5, stride=2)
    refs = _mono(tm, prompts, 8, **kw)
    cancel_at, deadline_s = {1: 2}, {4: 3.0}

    def drive(jax_side):
        async def go():
            clk = JaxVirtualClock() if jax_side else VirtualClock()
            ckw = dict(replicas=3, telemetry=True, clock=clk, backoff_s=0.0,
                       max_retries=2, **KW, **kw)
            if jax_side:
                cl = JaxServingCluster(
                    jm, cache_dtype=jnp.float32,
                    fault_plan=JaxFaultPlan.parse("2:crash@0"), **ckw)
                fd = JaxAsyncFrontDoor(cl, check_invariants=True)
            else:
                cl = ServingCluster(tm, device="cpu",
                                    fault_plan=FaultPlan.parse("2:crash@0"),
                                    **ckw)
                fd = AsyncFrontDoor(cl, check_invariants=True)
            streams = [await fd.submit(p, 8, seed=i,
                                       deadline_s=deadline_s.get(i),
                                       priority=i % 2)
                       for i, p in enumerate(prompts)]
            done = set()
            for _ in range(200):
                alive = await fd.pump()
                clk.advance(1.0)
                for i, at in cancel_at.items():
                    if i not in done and len(streams[i].tokens) >= at:
                        streams[i].cancel()
                        done.add(i)
                if not alive:
                    break
            return (cl, [s.outcome for s in streams],
                    [[int(x) for x in s.tokens] for s in streams],
                    [t.sequence_signature() for t in cl.telemetries])

        return asyncio.run(go())

    cl, outcomes, tokens, sigs = drive(False)
    jc, joutcomes, jtokens, jsigs = drive(True)
    assert (outcomes, tokens, sigs) == (joutcomes, jtokens, jsigs)
    assert cl.health == jc.health and "dead" in cl.health
    assert outcomes[1] == "cancelled" and None not in outcomes
    for i, (o, toks) in enumerate(zip(outcomes, tokens)):
        if o == "finished":
            assert toks == refs[i]
        else:
            assert toks == refs[i][: len(toks)]
    st = cl.stats()
    assert st["cancelled_requests"] >= 1 and st["failovers"] >= 1
    check_engines(cl)
    cl2, outcomes2, tokens2, sigs2 = drive(False)
    assert (outcomes2, tokens2, sigs2) == (outcomes, tokens, sigs)
    assert cl2.health == cl.health


# -- kernel loading from the replicas' worker threads -------------------------


def test_kernel_load_builds_once_across_threads(monkeypatch):
    """Replica workers that reach an unloaded kernel at once: ``load``'s
    lock lets one build and load it, the others take that library."""
    from midgpt_tpu_torch.ops import build

    starts = []

    def slow_start(name):
        starts.append(name)
        time.sleep(0.05)  # a build in progress
        return None

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_start_build", slow_start)
    monkeypatch.setattr(build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: object()))
    gate = threading.Barrier(6)
    libs = []

    def worker():
        gate.wait()
        libs.append(build.load("fused_norm"))

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert starts == ["fused_norm"]
    assert len(libs) == 6 and all(lib is libs[0] for lib in libs)


def test_partial_build_files_are_named_by_thread(monkeypatch, tmp_path):
    from midgpt_tpu_torch.ops import build

    cmds = []
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda cmd, **kw: cmds.append(cmd))
    jobs = []
    both = threading.Barrier(2)  # alive together: two thread idents

    def worker():
        jobs.append(build._start_build("fused_norm"))
        both.wait()

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    tmps = [tmp for _, tmp, _ in jobs]
    assert len(set(tmps)) == 2
    assert all(f".{os.getpid()}." in tmp for tmp in tmps)
    assert sorted(c[c.index("-o") + 1] for c in cmds) == sorted(tmps)
