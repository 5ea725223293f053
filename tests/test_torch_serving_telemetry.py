"""The port's serving telemetry against the JAX package's.

A 2-layer model (block 64, vocab 96, 4 heads, D = 32) gets the same
weights in both packages (``torch_port_util.model_pair``); both engines
serve f32 pools on the CPU. Checked:

- the inventories: ``stats()``'s keys, in order, equal JAX's
  ``ENGINE_STATS_KEYS``, and ``EVENT_KINDS`` equals JAX's; the counter
  attributes are the registry's counters; ``metrics_snapshot`` and
  ``prometheus_text`` carry every counter with the same value;
- under a virtual clock that ticks a fixed amount at each read, the
  event sequence (``sequence_signature``: step, kind, request and data of
  every event, in order) and every request's derived metrics
  (``request_metrics``: queue delay, TTFT, the TBT series, eviction
  stall, tokens per dispatch, e2e) equal the JAX engine's, and so do the
  registry's histograms and the dispatch ring's spans: speculation off
  and ``speculate=3``, the cache on and off, ``prefill_chunk=8``,
  eviction and parking, a fault plan, cancels, a deadline shed, spill;
- tracing is inert: streams and the paged attention's calls are the
  same with tracing on and off, and with ``telemetry=False``;
- the engine-side cases of ``tests/test_telemetry.py``: the lifecycle
  order and derived metrics, the eviction stall of a parked request and
  the fault on the timeline, shed and deferred events, replay, the
  bounded rings, the flight dump, the Chrome trace's span structure (the
  JAX engine's, lane for lane) and its engine lane, the profiler window,
  the re-exported substrate.

Every comparison is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midgpt_tpu.serving.telemetry as jax_serving_tele
import midgpt_tpu_torch.models.gpt as gpt_mod
import midgpt_tpu_torch.serving.telemetry as serving_tele
import midgpt_tpu_torch.telemetry as core_tele
from midgpt_tpu.serving import FaultPlan as JaxFaultPlan
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving import VirtualClock as JaxVirtualClock
from midgpt_tpu.serving import chrome_trace as jax_chrome_trace
from midgpt_tpu_torch.serving import (
    ENGINE_STATS_KEYS,
    EVENT_KINDS,
    EngineTelemetry,
    FaultEvent,
    FaultPlan,
    ServingEngine,
    VirtualClock,
    chrome_trace,
)
from midgpt_tpu_torch.telemetry import prometheus_text

from torch_port_util import model_pair

torch.set_num_threads(2)

CFG = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)
VOCAB = CFG["vocab_size"]
KW = dict(slots=2, page_size=8, window=4)
TICK = 0.25  # virtual seconds a clock read


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


def _run(tm, telemetry=None, n=3, n_new=8, **kw):
    eng = ServingEngine(tm, device="cpu", telemetry=telemetry,
                        **{**KW, **kw})
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(_prompts(n))]
    fin = eng.run(400)
    return eng, [list(map(int, fin[r].tokens)) for r in rids]


# -- inventories ---------------------------------------------------------------


def test_stats_keys_and_event_kinds_equal_jax(models):
    assert ENGINE_STATS_KEYS == jax_serving_tele.ENGINE_STATS_KEYS
    assert EVENT_KINDS == jax_serving_tele.EVENT_KINDS
    eng, _ = _run(models[1])
    st = eng.stats()
    assert tuple(st) == ENGINE_STATS_KEYS
    assert st["tp"] == 1
    assert all(st[k] == 0 for k in ENGINE_STATS_KEYS
               if k.startswith("spill"))
    json.dumps(st)


def test_counter_attributes_are_registry_backed(models):
    eng, _ = _run(models[1])
    assert eng.decode_dispatches >= 1
    eng.decode_dispatches = 0  # a reset by assignment reaches the registry
    assert eng.metrics.counter("decode_dispatches").value == 0
    assert eng.stats()["decode_dispatches"] == 0
    eng.decode_dispatches += 5
    assert eng.metrics_snapshot()["counters"]["decode_dispatches"] == 5
    assert "decode_dispatches" not in vars(eng)


def test_snapshot_and_prometheus_text_agree(models):
    """Every registry counter, labeled family, gauge and histogram of the
    snapshot is in the exposition with the same value; the counters are
    JAX's, the always-on histograms populated."""
    jm, tm = models
    eng = ServingEngine(tm, device="cpu", max_queue=1,
                        overload_policy="shed", **KW)
    eng.submit(_prompts(1)[0], 4)
    with pytest.raises(Exception):
        eng.submit(_prompts(2)[1], 4)
    eng.run(100)
    snap = eng.metrics_snapshot()
    json.dumps(snap)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32, **KW)
    assert set(snap["counters"]) == set(
        jeng.metrics_snapshot()["counters"])
    assert set(snap["gauges"]) == set(jeng.metrics_snapshot()["gauges"])
    text = prometheus_text(snap)
    lines = set(text.splitlines())
    for name, v in snap["counters"].items():
        assert f"midgpt_{name}_total {v}" in lines, name
    for key, v in snap["labeled"]["reject_reasons"].items():
        assert f'midgpt_reject_reasons_total{{key="{key}"}} {v}' in lines
    for name, v in snap["gauges"].items():
        assert f"midgpt_{name} {v}" in lines, name
    for name, h in snap["histograms"].items():
        assert f"midgpt_{name}_count {h['count']}" in lines, name
    assert snap["histograms"]["queue_delay_s"]["count"] == 1
    assert snap["histograms"]["ttft_s"]["count"] == 1


# -- the event sequence and derived metrics against JAX -------------------------


def _prompt_set(case):
    if case == "evict":  # 4 requests of 6 tokens, 16 new: 3 pages each
        return _prompts(4, base_len=6, stride=0, seed0=200), 16
    if case == "spill":
        return _prompts(4, base_len=22, stride=0, seed0=300), 12
    if case == "cancel":
        return _prompts(4, base_len=5, stride=4), 16
    return _prompts(4, base_len=5, stride=4), 8


CASES = {
    "default": dict(),
    "spec3": dict(speculate=3),
    "nocache": dict(prefix_cache=False),
    "chunk8": dict(prefill_chunk=8),
    "evict": dict(num_pages=5),
    "fault": dict(slots=1, page_size=4, num_pages=4, prefix_cache=False,
                  plan="2:exhaust@0:all:2"),
    "cancel": dict(),
    "deadline": dict(slots=1),
    "spill": dict(num_pages=8, prefill_chunk=8, spill="on"),
}


def _traced_pair(models, case):
    """The case through the port's engine and JAX's, each with a virtual
    clock ticking ``TICK`` a read and tracing on; returns both engines and
    their streams."""
    jm, tm = models
    kw = dict(CASES[case])
    plan = kw.pop("plan", None)
    prompts, n_new = _prompt_set(case)
    out = []
    for port in (True, False):
        ekw = dict(KW, **kw)
        if plan is not None:
            ekw["fault_hook"] = (FaultPlan if port else JaxFaultPlan).parse(
                plan).hook(0)
        clock = (VirtualClock if port else JaxVirtualClock)(tick=TICK)
        if port:
            eng = ServingEngine(tm, device="cpu", clock=clock,
                                telemetry=True, **ekw)
        else:
            eng = JaxServingEngine(jm, cache_dtype=jnp.float32, clock=clock,
                                   telemetry=True, **ekw)
        if case == "fault":
            prompts, n_new = _prompts(1, base_len=3), 12
        rids = []
        for i, p in enumerate(prompts):
            dl = 2.0 if case == "deadline" and i == 2 else None
            rids.append(eng.submit(p, n_new, seed=i, deadline_s=dl))
        rounds = 2 if case == "spill" else 1
        for rnd in range(rounds):
            if rnd:
                rids += [eng.submit(p, n_new, seed=i)
                         for i, p in enumerate(prompts)]
            steps = 0
            while eng.has_work:
                eng.step()
                steps += 1
                assert steps < 400
                if case == "cancel" and steps == 2:
                    running = [r for r in eng.slot_req if r is not None]
                    assert eng.cancel(running[0].rid)
                    assert eng.cancel(eng.queue[-1].rid)
        streams = [list(map(int, eng.lookup(r).tokens)) for r in rids]
        out.append((eng, streams))
    return out


def _metrics_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and b[k] is not None:
            assert a[k] == float(b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", list(CASES))
def test_event_sequence_and_request_metrics_match_jax(models, case):
    (eng, got), (jeng, ref) = _traced_pair(models, case)
    assert got == ref
    tele, jtele = eng.telemetry, jeng.telemetry
    assert tele.sequence_signature() == jtele.sequence_signature()
    assert [ev.t for ev in tele.events] == [ev.t for ev in jtele.events]
    assert sorted(tele.request_log) == sorted(jtele.request_log)
    for rid in jtele.request_log:
        _metrics_equal(tele.request_metrics(rid), jtele.request_metrics(rid))
    assert [d.to_json() for d in tele.dispatches] == \
        [d.to_json() for d in jtele.dispatches]
    snap, jsnap = eng.metrics_snapshot(), jeng.metrics_snapshot()
    assert snap["histograms"] == jsnap["histograms"]
    assert snap["counters"] == jsnap["counters"]
    assert eng.stats() == jeng.stats()
    kinds = {ev.kind for ev in tele.events}
    want = {"evict": {"evicted"}, "fault": {"fault", "parked", "resumed"},
            "cancel": {"cancelled"}, "deadline": {"deadline_shed"},
            "spec3": {"verify_dispatch"}, "chunk8": {"prefill_chunk"}}
    assert want.get(case, {"decode_window"}) <= kinds
    if case == "spill":
        assert eng.stats()["spill_faultback_pages"] > 0
    assert tele.finished_request_metrics() and len(
        tele.finished_request_metrics()) == len(
        jtele.finished_request_metrics())


def test_chrome_trace_spans_match_jax(models):
    """The Chrome trace of the eviction case has JAX's structure: the same
    events in the same order, lane for lane, with the same names, phases,
    timestamps and arguments."""
    (eng, _), (jeng, _) = _traced_pair(models, "evict")
    ours, ref = chrome_trace(eng.telemetry), jax_chrome_trace(jeng.telemetry)
    json.dumps(ours)
    assert ours == json.loads(json.dumps(ref))
    evs = ours["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i", "M"}
    assert any(e["name"] == "requeued" for e in evs if e["ph"] == "X")


# -- tracing is inert -------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    pytest.param(dict(), id="default"),
    pytest.param(dict(speculate=4, prefill_chunk=4), id="spec-chunk"),
    pytest.param(dict(kv_quant="int8", prefill_chunk=8), id="kv8"),
])
def test_tracing_is_inert(models, monkeypatch, kw):
    """Streams and the paged attention's calls (decode and verify) are the
    same with tracing on, off and ``telemetry=False``."""
    tm = models[1]
    counts = {}
    for name in ("paged_decode_attention", "paged_verify_attention"):
        real = getattr(gpt_mod, name)

        def counting(*a, _r=real, _n=name, **k):
            counts[_n] = counts.get(_n, 0) + 1
            return _r(*a, **k)

        monkeypatch.setattr(gpt_mod, name, counting)
    runs = []
    for telemetry in (None, True, False):
        counts.clear()
        eng, streams = _run(tm, telemetry=telemetry, **kw)
        runs.append((streams, dict(counts)))
        assert (eng.telemetry is not None) == (telemetry is True)
    assert runs[0] == runs[1] == runs[2]
    assert sum(runs[0][1].values()) > 0


def test_bad_telemetry_refused(models):
    with pytest.raises(ValueError):
        ServingEngine(models[1], device="cpu", telemetry="yes", **KW)


# -- the engine-side cases of tests/test_telemetry.py -------------------------------


def test_lifecycle_order_and_derived_metrics(models):
    eng, streams = _run(models[1], telemetry=True,
                        clock=VirtualClock(tick=1.0), prefill_chunk=4)
    tele = eng.telemetry
    kinds = {ev.kind for ev in tele.events}
    assert kinds <= set(EVENT_KINDS)
    assert {"submit", "queued", "admitted", "prefill_chunk",
            "decode_window", "tokens", "finished"} <= kinds
    for rid, toks in enumerate(streams):
        order = [ev.kind for ev in tele.request_log[rid]]
        assert order[:2] == ["submit", "queued"]
        assert order.index("admitted") < order.index("tokens")
        assert order[-1] == "finished"
        m = tele.request_metrics(rid)
        assert m["finished"] and m["tokens"] == len(toks)
        assert m["queue_delay_s"] >= 0
        assert float(m["queue_delay_s"]).is_integer()
        assert m["ttft_s"] > 0 and len(m["tbt_s"]) == len(toks) - 1
        assert m["tokens_per_dispatch"] == m["tokens"] / m["dispatches"]
        assert m["eviction_stall_s"] == 0.0
    assert all(ev.step <= eng.fault_step for ev in tele.events)
    h = eng.metrics_snapshot()["histograms"]
    assert h["ttft_s"]["count"] == h["queue_delay_s"]["count"] == 3
    assert h["tbt_s"]["count"] == sum(len(s) - 1 for s in streams)
    assert h["dispatch_s"]["count"] == eng.decode_dispatches


def test_park_resume_stall_and_fault_event(models):
    plan = FaultPlan([FaultEvent(step=2, kind="exhaust", hold_steps=2)])
    eng = ServingEngine(models[1], device="cpu", slots=1, page_size=4,
                        num_pages=4, window=4, prefix_cache=False,
                        fault_hook=plan.hook(0), telemetry=True,
                        clock=VirtualClock(tick=0.5))
    rid = eng.submit(_prompts(1, base_len=3)[0], 12)
    eng.run(100)
    kinds = [ev.kind for ev in eng.telemetry.request_log[rid]]
    i = kinds.index("evicted")
    assert kinds[i + 1] == "parked" and "resumed" in kinds[i:]
    assert kinds.count("admitted") >= 2
    m = eng.telemetry.request_metrics(rid)
    assert m["eviction_stall_s"] > 0 and m["evictions"] >= 1
    faults = [ev for ev in eng.telemetry.events if ev.kind == "fault"]
    assert len(faults) == 1 and faults[0].data["fault"] == "exhaust"
    assert faults[0].data["spec"] == "2:exhaust@0:all:2"


def test_shed_and_deferred_events_and_engine_lane(models):
    for policy, kind in (("shed", "shed"), ("defer", "deferred")):
        eng = ServingEngine(models[1], device="cpu", max_queue=1,
                            overload_policy=policy, telemetry=True, **KW)
        eng.submit(_prompts(1)[0], 4)
        with pytest.raises(Exception):
            eng.submit(_prompts(2)[1], 4)
        assert [ev.kind for ev in eng.telemetry.events
                if ev.kind in ("shed", "deferred")] == [kind]
        eng.run(100)
        lane = [e for e in chrome_trace(eng.telemetry)["traceEvents"]
                if e.get("pid") == 3 and e["ph"] == "i"]
        assert [e["name"] for e in lane] == [kind]
        assert all(e["ts"] >= 0 for e in lane)


def test_replay_gives_the_same_sequence(models):
    """Two runs on the host clock: the same signature, other times."""
    a, _ = _run(models[1], telemetry=True, prefill_chunk=4)
    b, _ = _run(models[1], telemetry=True, prefill_chunk=4)
    assert a.telemetry.sequence_signature() == \
        b.telemetry.sequence_signature()
    assert [e.t for e in a.telemetry.events] != \
        [e.t for e in b.telemetry.events]


def test_flight_recorder_rings_bounded(models):
    tele = EngineTelemetry(ring=8, dispatch_ring=4)
    _run(models[1], telemetry=tele)
    assert len(tele.events) == 8 and len(tele.dispatches) <= 4
    assert tele.events[-1].kind == "finished"


def test_flight_dump(models, tmp_path):
    eng, streams = _run(models[1], telemetry=True)
    path = str(tmp_path / "flight.json")
    rec = eng.flight_dump("unit_test", path=path, extra={"replica": 7})
    on_disk = json.load(open(path))
    assert on_disk["reason"] == "unit_test" and on_disk["replica"] == 7
    assert on_disk["path"] == path
    assert on_disk["stats"]["tokens_generated"] == sum(map(len, streams))
    assert on_disk["metrics"]["counters"]["decode_dispatches"] >= 1
    evs = on_disk["telemetry"]["events"]
    assert evs and {"seq", "step", "kind", "t"} <= set(evs[0])
    assert on_disk["telemetry"]["dispatches"]
    assert rec["fault_step"] == eng.fault_step
    eng2, _ = _run(models[1])
    rec2 = eng2.flight_dump("no_trace")
    assert rec2["telemetry"] is None and rec2["stats"]["windows"] >= 1


def test_chrome_trace_structure(models):
    eng, streams = _run(models[1], telemetry=True, prefill_chunk=4)
    evs = chrome_trace(eng.telemetry)["traceEvents"]
    for ev in evs:
        assert ev["ph"] in ("X", "i", "M")
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
    req = [e for e in evs if e["ph"] == "X" and e["pid"] == 1]
    assert {e["tid"] for e in req} == set(range(len(streams)))
    assert any(e["name"] == "active" for e in req)
    disp = [e for e in evs if e["ph"] == "X" and e["pid"] == 2]
    assert len(disp) == len(eng.telemetry.dispatches)
    assert {e["name"] for e in disp} <= {"decode_window", "verify_dispatch",
                                         "prefill_chunk"}


def test_profiler_window(models, tmp_path, monkeypatch):
    """The profiler starts at the top of step ``start`` and stops at
    ``stop``, or when the engine drains first."""
    calls = []
    monkeypatch.setattr(core_tele, "start_profiler",
                        lambda: calls.append("start") or "prof")
    monkeypatch.setattr(core_tele, "stop_profiler",
                        lambda prof, d: calls.append(("stop", prof, d)))
    for steps in ((2, 3), (2, 10_000)):
        calls.clear()
        tele = EngineTelemetry(profile_dir=str(tmp_path), profile_steps=steps)
        _run(models[1], telemetry=tele)
        assert calls == ["start", ("stop", "prof", str(tmp_path))]
        assert tele._profiler is None


def test_serving_telemetry_reexports_the_substrate():
    for name in ("Counter", "Gauge", "Histogram", "MetricsRegistry", "Event",
                 "DispatchRecord", "percentile", "write_json",
                 "LATENCY_BUCKETS_S", "prometheus_text"):
        assert getattr(serving_tele, name) is getattr(core_tele, name), name
    assert issubclass(EngineTelemetry, core_tele.TelemetryLog)
    assert EngineTelemetry.event_kinds == EVENT_KINDS
    with pytest.raises(AssertionError):
        EngineTelemetry().emit("window_launch", step=0, t=0.0)
