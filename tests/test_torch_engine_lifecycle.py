"""The port's serving engine under load against the JAX package's: eviction
and parking on JAX's admission accounting, priorities, deadlines, cancel,
typed admission errors and the fault plan.

A 2-layer model gets the same weights in both packages
(``torch_port_util.model_pair``), f32 weights and pools; the JAX engine
runs as the JAX package's own serving tests run it on the CPU (the
default ``paged_kernel``). Most traces go through both engines in
lockstep (``_lockstep``): after every step each engine's allocator and
prefix index hold their invariants, and the two engines agree on which
request each slot holds (the admission order) and on every ``stats()``
key, the inventory being JAX's ``ENGINE_STATS_KEYS`` (``evictions``,
``livelock_parks``, ``overload_parks``, ``cold_reclaims``,
``faults_injected``, ``reject_reasons``, ``deadline_shed_requests``,
``cancelled_requests``, the page counts ...).
Greedy streams then equal JAX's token for token. Ported from
``tests/test_serving_faults.py`` (plan round trip, event validation,
quarantine invariants, typed and counted rejections, defer and shed, a
lone request that parks and recovers, the livelock guard at
``park_threshold`` 1 and 2), ``tests/test_serving.py`` (evicts and
recovers, repeated eviction without duplication, re-admission hits the
cache, speculation under eviction) and the engine-level parts of
``tests/test_frontdoor.py`` (cancel from a slot, mid-chunk, mid-verify,
queued and parked; priority order; the aging bound; deadline shed;
un-park shedding expired requests). Port against port, because JAX's
random bits cannot be matched or the feature is the port's to prove:
``kv_quant="int8"`` under eviction, sampled streams under eviction, and
``drain_requests`` then ``resubmit`` on a second engine; each equals the
uncontended run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import FaultPlan as JaxFaultPlan
from midgpt_tpu.serving import PageAllocator as JaxPageAllocator
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu_torch.serving import (
    ENGINE_STATS_KEYS,
    AdmissionRejected,
    FaultEvent,
    FaultPlan,
    PageAllocator,
    PoolOverloaded,
    ServingEngine,
    ServingFault,
)

from torch_port_util import MHA, assert_pages_home, model_pair

torch.set_num_threads(2)

VOCAB = MHA["vocab_size"]
KW = dict(slots=2, page_size=8, window=4)
# 4 requests of 6 tokens, 16 new: 3 pages each, 6 for two slots > 5
PRESSURE = dict(KW, num_pages=5)
MAX_WINDOWS = 400  # every trace here drains in far fewer steps


@pytest.fixture(autouse=True)
def _no_grad():
    """These paths serve: no gradients (the parameters are trainable)."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def models():
    jm, tm, _ = model_pair(MHA)
    return jm, tm


class Clock:
    """A virtual clock: time moves only when a test advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _prompts(n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=length).astype(np.int32)
            for _ in range(n)]


def _engines(models, plan=None, clock=False, **kw):
    """The port's engine and JAX's on the same knobs; ``plan`` installs a
    fault plan's hook in each (the same spec), ``clock=True`` a virtual
    clock in each."""
    jm, tm = models
    jkw, tkw = dict(kw), dict(kw)
    if plan is not None:
        tkw["fault_hook"] = FaultPlan.parse(plan).hook(0)
        jkw["fault_hook"] = JaxFaultPlan.parse(plan).hook(0)
    if clock:
        tkw["clock"], jkw["clock"] = Clock(), Clock()
    eng = ServingEngine(tm, device="cpu", **tkw)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32, **jkw)
    return eng, jeng


def _check(eng) -> None:
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc)


def _slot_rids(eng):
    return [None if r is None else r.rid for r in eng.slot_req]


def _shared_stats(eng, jeng):
    a, b = eng.stats(), jeng.stats()
    keys = sorted(set(a) & set(b))
    assert tuple(a) == tuple(b) == ENGINE_STATS_KEYS, keys  # every key
    return {k: a[k] for k in keys}, {k: b[k] for k in keys}


def _step_both(eng, jeng) -> None:
    eng.step()
    jeng.step()
    _check(eng)
    _check(jeng)
    assert _slot_rids(eng) == _slot_rids(jeng)
    assert [r.rid for r in eng.queue] == [r.rid for r in jeng.queue]
    assert [r.rid for r in eng.parked] == [r.rid for r in jeng.parked]
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref


def _lockstep(eng, jeng) -> None:
    """Step both engines until both drain, holding them equal after every
    step."""
    for _ in range(MAX_WINDOWS):
        if not (eng.has_work or jeng.has_work):
            return
        _step_both(eng, jeng)
    raise AssertionError(f"no drain in {MAX_WINDOWS} steps")


def _streams(eng, rids):
    return [list(map(int, eng.lookup(r).tokens)) for r in rids]


def _submit_both(eng, jeng, prompts, n_new, **kw):
    rids = [eng.submit(p, n_new, seed=i, **kw) for i, p in enumerate(prompts)]
    jrids = [jeng.submit(p, n_new, seed=i, **kw)
             for i, p in enumerate(prompts)]
    assert rids == jrids
    return rids


def _uncontended(tm, prompts, n_new, **kw):
    """Each request alone on a roomy engine: no eviction pressure."""
    out = []
    for i, p in enumerate(prompts):
        eng = ServingEngine(tm, device="cpu", **{**KW, **kw})
        rid = eng.submit(p, n_new, seed=i)
        out.append(list(map(int, eng.run(MAX_WINDOWS)[rid].tokens)))
        assert eng.evictions == 0
    return out


# -- the fault plan and the allocator's quarantine ---------------------------


def test_fault_plan_parse_spec_round_trip_matches_jax():
    spec = "6:crash@1;4:wedge@0:0.5;3:transient;2:exhaust@0:all:3;5:handoff"
    plan, ref = FaultPlan.parse(spec), JaxFaultPlan.parse(spec)
    assert len(plan) == 5 and plan.spec() == ref.spec()
    assert [ev.step for ev in plan] == [2, 3, 4, 5, 6]
    assert plan.replicas == {0, 1}
    assert FaultPlan.parse(plan.spec()).spec() == plan.spec()
    for (rep, step) in ((0, 2), (0, 3), (0, 4), (1, 6), (1, 2), (0, 5)):
        ours = plan.events_for(rep, step)
        theirs = ref.events_for(rep, step)
        assert [(e.kind, e.seconds, e.pages, e.hold_steps) for e in ours] \
            == [(e.kind, e.seconds, e.pages, e.hold_steps) for e in theirs]
    ex = plan.events_for(0, 2)[0]
    assert ex.kind == "exhaust" and ex.pages == -1 and ex.hold_steps == 3
    ev = FaultEvent(step=1, kind="exhaust", pages=2, hold_steps=2)
    assert FaultPlan.parse(FaultPlan([ev]).spec()).events[0].pages == 2


def test_plan_hook_raises_typed_faults_and_arms_handoff_as_jax(models):
    """The raising kinds raise their typed faults at the top of their step
    in both engines, before any work, so the engines stay drainable;
    ``handoff`` only arms the poison. Both then drain to the same streams
    and every request reads as done."""
    import midgpt_tpu.serving.faults as jax_faults
    import midgpt_tpu_torch.serving.faults as faults

    plan = "1:crash;2:transient;3:wedge@0:0.01;4:handoff"
    eng, jeng = _engines(models, plan=plan, **KW)
    rids = _submit_both(eng, jeng, _prompts(2, 6), 8)
    for kind in ("ReplicaCrash", "TransientDispatchError", "WedgedDispatch"):
        for e, mod in ((eng, faults), (jeng, jax_faults)):
            with pytest.raises(getattr(mod, kind)):
                e.step()
        assert issubclass(getattr(faults, kind), ServingFault)
        ours, ref = _shared_stats(eng, jeng)
        assert ours == ref and ours["windows"] == 0
        assert not any(eng.lookup(r).done for r in rids)
    assert not eng._handoff_poison and not jeng._handoff_poison
    _step_both(eng, jeng)
    assert eng._handoff_poison and jeng._handoff_poison
    _lockstep(eng, jeng)
    assert eng.faults_injected == jeng.faults_injected == 4
    assert _streams(eng, rids) == _streams(jeng, rids)
    assert all(eng.lookup(r).done and jeng.lookup(r).done for r in rids)


@pytest.mark.parametrize("kw", [
    dict(step=0, kind="crash"), dict(step=1, kind="meteor"),
    dict(step=1, kind="crash", replica=-1),
    dict(step=1, kind="exhaust", hold_steps=0)],
    ids=["step0", "kind", "replica", "hold"])
def test_fault_event_validation(kw):
    """The events JAX refuses (with AssertionError) the port refuses with
    ValueError."""
    from midgpt_tpu.serving import FaultEvent as JaxFaultEvent

    with pytest.raises(AssertionError):
        JaxFaultEvent(**kw)
    with pytest.raises(ValueError):
        FaultEvent(**kw)


def test_allocator_quarantine_follows_jax():
    """JAX's quarantine test, op for op through both allocators."""
    ours, ref = PageAllocator(8), JaxPageAllocator(8)

    def same():
        ours.check()
        ref.check()
        assert (ours.free_pages, ours.held_pages, ours.cached_pages,
                ours.quarantined_pages) == (
            ref.free_pages, ref.held_pages, ref.cached_pages,
            ref.quarantined_pages)

    held = ours.alloc(3)
    assert held == ref.alloc(3)
    assert ours.quarantine(2) == ref.quarantine(2) == 2
    same()
    assert ours.quarantine() == ref.quarantine() == 3  # the rest
    same()
    assert ours.free_pages == 0 and ours.quarantined_pages == 5
    with pytest.raises(MemoryError):
        ours.alloc(1)
    ours.free(held)
    ref.free(held)
    same()
    assert ours.free_pages == 3  # frees bypass the quarantine
    assert ours.release_quarantined() == ref.release_quarantined() == 5
    same()
    assert ours.alloc(8) == ref.alloc(8)
    ours.free(range(8))
    assert ours.quarantine(99) == 8  # capped at the free list
    ours._free.append(ours._quarantined[0])  # a page in two states
    with pytest.raises(AssertionError):
        ours.check()


# -- typed admission and the bounded queue -----------------------------------


def test_admission_rejections_typed_and_counted(models):
    eng, jeng = _engines(models, slots=1, page_size=4, num_pages=2,
                         window=2)
    block = MHA["block_size"]
    cases = [
        ("bad_budget", (np.zeros(4, np.int32), 0)),
        ("budget_exceeds_block", (np.zeros(4, np.int32), block)),
        ("empty_prompt", (np.zeros(0, np.int32), 4)),
        # 4 prompt + 8 new = 3 pages over a 2-page pool: never servable
        ("lifetime_exceeds_pool", (np.zeros(4, np.int32), 8)),
    ]
    for reason, args in cases:
        with pytest.raises(AdmissionRejected) as exc:
            eng.submit(*args)
        assert exc.value.reason == reason
        assert isinstance(exc.value, ServingFault)
        assert not isinstance(exc.value, ValueError)
        with pytest.raises(Exception) as jexc:
            jeng.submit(*args)
        assert jexc.value.reason == reason
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref
    assert ours["admission_rejected"] == 4
    assert ours["reject_reasons"] == {r: 1 for r, _ in cases}
    assert not eng.queue and not eng._live


def test_bounded_queue_defer_and_shed(models):
    jm, tm = models
    prompts = _prompts(3, 4)
    eng, jeng = _engines(models, slots=1, page_size=8, window=4,
                         max_queue=2, overload_policy="defer")
    rids = _submit_both(eng, jeng, prompts[:2], 4)
    for e in (eng, jeng):
        with pytest.raises(Exception) as exc:
            e.submit(prompts[2], 4)
        assert exc.value.reason == "queue_full"
    with pytest.raises(PoolOverloaded):
        eng.submit(prompts[2], 4)
    with pytest.raises(Exception):
        jeng.submit(prompts[2], 4)
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref
    assert ours["deferred_submits"] == 2 and ours["shed_requests"] == 0
    assert ours["admission_rejected"] == 0  # defer is not a rejection
    _lockstep(eng, jeng)
    assert sorted(eng.finished) == rids
    assert _streams(eng, rids) == _streams(jeng, rids)
    eng.submit(prompts[2], 4)  # the backpressure lifted

    eng, jeng = _engines(models, slots=1, page_size=8, window=4,
                         max_queue=1, overload_policy="shed")
    _submit_both(eng, jeng, prompts[:1], 4)
    for e in (eng, jeng):
        with pytest.raises(Exception) as exc:
            e.submit(prompts[1], 4)
        assert exc.value.reason == "queue_full"
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref
    assert ours["shed_requests"] == 1
    assert ours["reject_reasons"] == {"queue_full": 1}
    with pytest.raises(ValueError):
        ServingEngine(tm, device="cpu", overload_policy="drop")


# -- pool exhaustion: parking and the livelock guard -------------------------


def test_lone_request_parks_under_exhaustion_and_recovers(models):
    """A lone request whose growth meets an exhausted pool (every free
    page quarantined at step 2 for 2 steps) parks with its progress and
    resumes when the pages come back, with the uncontended stream and
    JAX's counters."""
    jm, tm = models
    kw = dict(slots=1, page_size=4, num_pages=4, window=4,
              prefix_cache=False)
    prompt = _prompts(1, 3)[0]
    eng, jeng = _engines(models, plan="2:exhaust@0:all:2", **kw)
    rids = _submit_both(eng, jeng, [prompt], 12)
    _lockstep(eng, jeng)
    assert _streams(eng, rids) == _streams(jeng, rids) == _uncontended(
        tm, [prompt], 12, **kw)
    st = eng.stats()
    assert st["faults_injected"] == 1 and st["overload_parks"] >= 1
    assert st["parked_requests"] == 0
    assert eng.alloc.held_pages == 0 and eng.alloc.quarantined_pages == 0


@pytest.mark.parametrize("park_threshold", [1, 2])
def test_eviction_thrash_livelock_guard(models, park_threshold):
    """Two requests whose growth trades the same pages: the first growth
    pass evicts the just-prefilled loser with no progress, and at
    ``park_threshold=1`` the guard parks it; at 2 every later eviction
    hits a request that progressed, so nothing parks. Both equal JAX and
    the uncontended streams."""
    jm, tm = models
    kw = dict(slots=2, page_size=4, num_pages=5, window=4,
              prefix_cache=False)
    prompts = _prompts(2, 8, seed=1)
    eng, jeng = _engines(models, park_threshold=park_threshold, **kw)
    rids = _submit_both(eng, jeng, prompts, 8)
    _lockstep(eng, jeng)
    assert _streams(eng, rids) == _streams(jeng, rids) == _uncontended(
        tm, prompts, 8, **kw)
    st = eng.stats()
    if park_threshold == 1:
        assert st["livelock_parks"] >= 1
    else:
        assert st["livelock_parks"] == 0 and st["evictions"] >= 2
    assert st["parked_requests"] == 0 and eng.alloc.held_pages == 0


# -- eviction under page pressure --------------------------------------------


@pytest.mark.parametrize("n_new", [16, 24])
def test_evicts_under_page_pressure_and_recovers(models, n_new):
    """A 5-page pool under two slots (``num_pages < slots * pmax``): the
    port evicts as JAX does, step for step, and every stream equals the
    uncontended one. At 24 new tokens some request is evicted twice, and
    its rebuilt prompt is ``prompt0`` plus a prefix of its own stream
    (nothing appended twice); its re-admissions hit its cold pages."""
    jm, tm = models
    prompts = _prompts(4, 6, seed=2)
    eng, jeng = _engines(models, **PRESSURE)
    assert eng.alloc.num_pages < eng.slots * eng.pmax
    rids = _submit_both(eng, jeng, prompts, n_new)
    _lockstep(eng, jeng)
    got = _streams(eng, rids)
    assert got == _streams(jeng, rids) == _uncontended(tm, prompts, n_new)
    assert eng.evictions > 0 and eng.prompt_tokens_cached > 0
    if n_new == 24:
        assert max(eng.finished[r].evictions for r in rids) >= 2
    for r, p in zip(rids, prompts):
        req = eng.finished[r]
        np.testing.assert_array_equal(req.prompt0, p)
        np.testing.assert_array_equal(req.prompt[: p.size], p)
        tail = req.prompt[p.size:]
        assert list(tail) == req.tokens[: tail.size]
        np.testing.assert_array_equal(req.prompt, jeng.finished[r].prompt)
        assert req.evictions == jeng.finished[r].evictions
    assert_pages_home(eng)


def test_speculation_under_eviction(models):
    """``speculate=4`` under the same pressure: evicted requests keep
    their draft state, re-admit through the cache and keep speculating,
    with JAX's streams and counters."""
    jm, tm = models
    prompts = _prompts(4, 6, seed=2)
    eng, jeng = _engines(models, speculate=4, **PRESSURE)
    rids = _submit_both(eng, jeng, prompts, 16)
    _lockstep(eng, jeng)
    assert _streams(eng, rids) == _streams(jeng, rids) == _uncontended(
        tm, prompts, 16)
    assert eng.evictions > 0 and eng.verify_dispatches > 0
    assert_pages_home(eng)


def test_int8_pool_under_eviction_equals_uncontended(models):
    """``kv_quant="int8"`` (port against port): an evicted request's
    re-admission copies and re-prefills pages with their scale rows, and
    the streams equal the uncontended int8 engine's."""
    jm, tm = models
    prompts = _prompts(4, 6, seed=2)
    eng = ServingEngine(tm, device="cpu", kv_quant="int8", **PRESSURE)
    rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
    for _ in range(MAX_WINDOWS):
        if not eng.has_work:
            break
        eng.step()
        _check(eng)
    assert not eng.has_work
    assert eng.evictions > 0 and eng.prompt_tokens_cached > 0
    assert _streams(eng, rids) == _uncontended(tm, prompts, 24,
                                               kv_quant="int8")
    assert_pages_home(eng)


def test_sampled_streams_under_eviction_equal_uncontended(models):
    """Sampled (T=0.8, top-k 12; port against port): a resumed request's
    noise is keyed by its emitted count, so eviction changes nothing."""
    jm, tm = models
    prompts = _prompts(4, 6, seed=2)
    kw = dict(temperature=0.8, top_k=12, seed=5)
    eng = ServingEngine(tm, device="cpu", **PRESSURE, **kw)
    rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
    eng.run(MAX_WINDOWS)
    assert eng.evictions > 0
    got = _streams(eng, rids)
    assert got == _uncontended(tm, prompts, 24, **kw)
    assert got != _uncontended(tm, prompts, 24)  # not the greedy streams


def test_drain_and_resubmit_continue_streams_on_another_engine(models):
    """Requests drained off one engine mid-run (running, queued and
    parked alike) and resubmitted to a second go on with their streams
    (port against port)."""
    jm, tm = models
    prompts = _prompts(4, 6, seed=2)
    ref = _uncontended(tm, prompts, 24)
    a = ServingEngine(tm, device="cpu", park_threshold=1, **PRESSURE)
    reqs = [a.lookup(a.submit(p, 24, seed=i)) for i, p in enumerate(prompts)]
    for _ in range(6):
        a.step()
    assert a.evictions > 0 and any(r.tokens for r in reqs)
    drained = a.drain_requests()
    assert sorted(map(id, drained)) == sorted(map(id, reqs))
    assert not a.has_work and a.alloc.held_pages == 0 and not a._live
    b = ServingEngine(tm, device="cpu", **PRESSURE)
    for req in drained:
        b.resubmit(req)
    b.run(MAX_WINDOWS)
    assert [r.tokens for r in reqs] == ref
    assert all(r.outcome == "finished" for r in reqs)
    assert_pages_home(b)


# -- cancel ------------------------------------------------------------------


def test_cancel_releases_slot_and_pages_cold(models):
    """Cancel mid-decode: the slot frees at once, the pages retire cold
    and serve the same prompt's next request; a second cancel is a
    no-op."""
    prompts = _prompts(1, 17, seed=3)
    eng, jeng = _engines(models, **KW)
    (rid,) = _submit_both(eng, jeng, prompts, 16)
    for _ in range(3):
        _step_both(eng, jeng)
    assert eng.lookup(rid).tokens
    assert eng.cancel(rid) and jeng.cancel(rid)
    assert not eng.cancel(rid) and not eng.cancel(12345)
    assert eng.lookup(rid).outcome == "cancelled"
    assert eng._active_slots() == [] and eng.alloc.held_pages == 0
    assert eng.alloc.cached_pages > 0
    rid2 = eng.submit(prompts[0], 8)
    assert rid2 == jeng.submit(prompts[0], 8)
    _lockstep(eng, jeng)
    assert eng.prompt_tokens_cached > 0
    assert _streams(eng, [rid2]) == _streams(jeng, [rid2])
    assert eng.stats()["cancelled_requests"] == 1


def test_cancel_during_prefill_chunk(models):
    """Cancel a request between its prefill chunks: the survivor's
    stream equals a run where the victim was never submitted."""
    jm, tm = models
    kw = dict(KW, prefill_chunk=4, prefill_budget=4)
    victim, survivor = _prompts(1, 24, seed=4)[0], _prompts(1, 7, seed=5)[0]
    eng, jeng = _engines(models, **kw)
    v = eng.submit(victim, 8, seed=0)
    s = eng.submit(survivor, 10, seed=1)
    assert (v, s) == (jeng.submit(victim, 8, seed=0),
                      jeng.submit(survivor, 10, seed=1))
    _step_both(eng, jeng)
    vs = [sl for sl in eng._active_slots() if eng.slot_req[sl].rid == v]
    assert vs and eng.prefilling[vs[0]], "the victim is mid-prefill"
    assert eng.cancel(v) and jeng.cancel(v)
    _lockstep(eng, jeng)
    assert eng.lookup(v).tokens == [] and eng.lookup(s).outcome == "finished"
    alone = ServingEngine(tm, device="cpu", **kw)
    alone.submit(np.zeros(1, np.int32), 1)  # rid 0, as the victim had
    alone.cancel(0)
    r = alone.submit(survivor, 10, seed=1)
    alone.run(MAX_WINDOWS)
    assert _streams(eng, [s]) == _streams(jeng, [s]) == _streams(alone, [r])
    assert_pages_home(eng)


def test_cancel_mid_verify(models):
    """Cancel a speculating request between verify dispatches: the
    invariants hold, the survivor equals JAX's, and the victim's partial
    stream is a prefix of its own uncontended stream."""
    jm, tm = models
    prompts = [_prompts(1, 9, seed=6)[0], _prompts(1, 11, seed=7)[0]]
    eng, jeng = _engines(models, speculate=4, **KW)
    v, s = _submit_both(eng, jeng, prompts, 12)
    for _ in range(MAX_WINDOWS):
        if eng.lookup(v).tokens:
            break
        _step_both(eng, jeng)
    assert eng.verify_dispatches >= 1
    assert eng.cancel(v) and jeng.cancel(v)
    _lockstep(eng, jeng)
    vt = eng.lookup(v).tokens
    assert _streams(eng, [s]) == _streams(jeng, [s])
    assert vt and vt == _uncontended(tm, prompts[:1], 12)[0][: len(vt)]
    assert_pages_home(eng)


def test_cancel_queued_and_parked(models):
    """A queued request leaves the queue; a parked one (a lone request
    parked by an exhausted pool) leaves the parking lot; both typed,
    counted and invariant-clean."""
    kw = dict(slots=1, page_size=4, num_pages=4, window=4,
              prefix_cache=False)
    eng, jeng = _engines(models, plan="2:exhaust@0:all:3", **kw)
    a, b = _submit_both(eng, jeng, _prompts(2, 3, seed=8), 12)
    for _ in range(8):
        _step_both(eng, jeng)
        if eng.parked:
            break
    assert [r.rid for r in eng.parked] == [a]
    assert [r.rid for r in eng.queue] == [b]
    for rid in (b, a):  # queued, then parked
        assert eng.cancel(rid) and jeng.cancel(rid)
        _check(eng)
    assert eng.lookup(a).outcome == eng.lookup(b).outcome == "cancelled"
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref and ours["cancelled_requests"] == 2
    assert not eng.has_work and eng.alloc.held_pages == 0
    _lockstep(eng, jeng)


# -- priorities and deadlines ------------------------------------------------


def test_priority_dispatch_order(models):
    """One slot: a priority-5 request submitted third is admitted first;
    the priority-0 ones follow first in first out."""
    eng, jeng = _engines(models, slots=1, page_size=8, window=4)
    ps = _prompts(4, 5, seed=9)
    rids = []
    for i, prio in enumerate((0, 0, 5, 0)):
        rids.append(eng.submit(ps[i], 8, seed=i, priority=prio))
        assert rids[-1] == jeng.submit(ps[i], 8, seed=i, priority=prio)
    order = []
    for _ in range(MAX_WINDOWS):
        if not eng.has_work:
            break
        _step_both(eng, jeng)
        for r in _slot_rids(eng):
            if r is not None and r not in order:
                order.append(r)
    assert order == [rids[2], rids[0], rids[1], rids[3]]
    assert _streams(eng, rids) == _streams(jeng, rids)


def test_aging_starvation_bound(models):
    """One slot, a fresh priority-10 request every step: with
    ``priority_aging=1.0`` a priority-0 request outranks every fresh
    arrival after 10 queued steps, so it runs within 16 steps, at the
    step JAX's engine admits it."""
    eng, jeng = _engines(models, slots=1, page_size=8, window=4,
                         priority_aging=1.0)
    flood = _prompts(6, 5, seed=10)
    low = eng.submit(_prompts(1, 5, seed=11)[0], 4, priority=0)
    jeng.submit(_prompts(1, 5, seed=11)[0], 4, priority=0)
    admitted_at = None
    for step in range(40):
        for e in (eng, jeng):
            e.submit(flood[step % 6], 4, seed=step + 1, priority=10)
        _step_both(eng, jeng)
        if low in _slot_rids(eng) or eng.lookup(low).tokens:
            admitted_at = step + 1
            break
    assert admitted_at is not None and admitted_at <= 16


def test_deadline_shed_before_dispatch(models):
    """A queued request whose deadline passes on the virtual clock is shed
    before any dispatch; a running one is never shed; a request submitted
    with a deadline already passed is shed at the next step."""
    eng, jeng = _engines(models, slots=1, page_size=8, window=4,
                         clock=True)
    clocks = (eng.clock, jeng.clock)
    ps = _prompts(3, 5, seed=12)
    a = eng.submit(ps[0], 8, seed=0, deadline_s=100.0)
    b = eng.submit(ps[1], 8, seed=1, deadline_s=5.0)
    c = eng.submit(ps[2], 8, seed=2, deadline_s=-1.0)
    for i, d in enumerate((100.0, 5.0, -1.0)):
        jeng.submit(ps[i], 8, seed=i, deadline_s=d)
    _step_both(eng, jeng)  # c shed, a admitted (one slot), b queued
    assert eng.lookup(c).outcome == "expired"
    for clk in clocks:
        clk.advance(10.0)  # b expires queued; a's deadline still holds
    _lockstep(eng, jeng)
    assert eng.lookup(a).outcome == "finished"
    assert eng.lookup(b).outcome == "expired" and eng.lookup(b).tokens == []
    assert b in eng.expired and c in eng.expired
    st = eng.stats()
    assert st["deadline_shed_requests"] == 2 and st["cancelled_requests"] == 0
    assert _streams(eng, [a]) == _streams(jeng, [a])


def test_unpark_sheds_expired_and_keeps_resumed_first(models):
    """A parked request past its deadline is shed when the parking lot is
    released; the survivor returns to the queue, where resumed work
    outranks a later priority-99 submission."""
    eng, jeng = _engines(models, slots=1, page_size=8, window=4,
                         clock=True)
    ps = _prompts(3, 5, seed=13)
    for e in (eng, jeng):
        expired = e.lookup(e.submit(ps[0], 8, deadline_s=5.0))
        alive = e.lookup(e.submit(ps[1], 8, deadline_s=100.0))
        e.queue.clear()
        expired.evictions = alive.evictions = 1
        e.parked.extend([expired, alive])
        e.clock.advance(10.0)
        e._unpark()
        assert [r.rid for r in e.queue] == [alive.rid]
        assert expired.outcome == "expired"
        assert e.stats()["deadline_shed_requests"] == 1
        fresh = e.submit(ps[2], 8, priority=99)
        assert e.queue[e._select_queued()].rid == alive.rid != fresh
    ours, ref = _shared_stats(eng, jeng)
    assert ours == ref
