"""The port's async front door against the JAX package's, over one engine.

A 2-layer model (block 64, vocab 96, 4 heads, D = 32) gets the same
weights in both packages (``torch_port_util.model_pair``); both engines
serve f32 pools on the CPU. Ported from the engine-backed tests of
``tests/test_frontdoor.py``:

- streams through the front door (pumped by hand and driven in the
  background, consumed with ``async for``) equal the synchronous
  ``run()``'s and the JAX front door's on the same traffic, over the
  cache, chunking, speculation and int8 knobs, with tracing on too;
- cancellation: mid-decode (the slot and its pages released, cold, and
  hit again), mid-prefill and mid-verify (the survivor equals a run
  without the victim, the victim's tokens a prefix of its solo stream),
  queued; idempotent; the allocator and the prefix index checked after
  every round;
- priorities (a later high priority goes first), the aging bound,
  deadlines (a queued request shed before dispatch, a parked one on
  release), backpressure (defer waits, raise and shed raise);
- a composite of a fault plan, a cancel and a deadline: the outcomes,
  streams and the event sequence equal the JAX front door's, and a
  replay gives them again;
- ``stats()``.

Every comparison is exact.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import AsyncFrontDoor as JaxAsyncFrontDoor
from midgpt_tpu.serving import FaultPlan as JaxFaultPlan
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving import VirtualClock as JaxVirtualClock
from midgpt_tpu_torch.serving import (
    AdmissionRejected,
    AsyncFrontDoor,
    Cancelled,
    DeadlineExceeded,
    FaultPlan,
    PoolOverloaded,
    ServingEngine,
    VirtualClock,
)

from torch_port_util import model_pair

torch.set_num_threads(2)

CFG = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)
VOCAB = CFG["vocab_size"]
KW = dict(slots=2, page_size=8, window=4)


@pytest.fixture(autouse=True)
def _no_grad():
    # this thread's; the background task's worker thread keeps its own
    # (grad on), as a server's would
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


def run(coro):
    return asyncio.run(coro)


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **{**KW, **kw})


def _jax_engine(jm, **kw):
    return JaxServingEngine(jm, cache_dtype=jnp.float32, **{**KW, **kw})


def _sync_refs(tm, prompts, n_new=8, seeds=None, **kw):
    eng = _engine(tm, **kw)
    seeds = seeds if seeds is not None else range(len(prompts))
    rids = [eng.submit(p, n_new, seed=s) for p, s in zip(prompts, seeds)]
    fin = eng.run(400)
    return [list(map(int, fin[r].tokens)) for r in rids]


async def _drain_all(fd):
    while await fd.pump():
        pass


async def _pumped(fd, prompts, n_new=8):
    streams = [await fd.submit(p, n_new, seed=i)
               for i, p in enumerate(prompts)]
    await _drain_all(fd)
    return streams


def test_virtual_clock_matches_jax():
    for ours, ref in ((VirtualClock(), JaxVirtualClock()),
                      (VirtualClock(1.0, 0.5), JaxVirtualClock(1.0, 0.5))):
        assert [ours(), ours(), ours.advance(2.5), ours()] == \
            [ref(), ref(), ref.advance(2.5), ref()]
    with pytest.raises(ValueError):
        VirtualClock().advance(-1.0)


MATRIX = [
    pytest.param(dict(), id="default"),
    pytest.param(dict(prefix_cache=False, prefill_chunk=8), id="nocache-chunk"),
    pytest.param(dict(prefill_chunk=8, speculate=3), id="chunk-spec"),
    pytest.param(dict(kv_quant="int8"), id="kv8"),
    pytest.param(dict(telemetry=True, prefill_chunk=4), id="traced"),
]


@pytest.mark.parametrize("kw", MATRIX)
def test_pumped_streams_match_sync_loop_and_jax(models, kw):
    """Pumped by hand with the invariants checked every round: streams
    equal ``run()``'s and the JAX front door's."""
    jm, tm = models
    prompts = _prompts(4)
    refs = _sync_refs(tm, prompts, **kw)
    streams = run(_pumped(AsyncFrontDoor(_engine(tm, **kw),
                                         check_invariants=True), prompts))
    jstreams = run(_pumped(JaxAsyncFrontDoor(_jax_engine(jm, **kw),
                                             check_invariants=True), prompts))
    assert [s.tokens for s in streams] == refs == \
        [list(map(int, s.tokens)) for s in jstreams]
    assert [s.outcome for s in streams] == ["finished"] * 4


def test_background_driver_streams_match_sync_loop(models):
    """The background task (step in a worker thread), tokens consumed
    with ``async for``: the same streams."""
    tm = models[1]
    prompts = _prompts(4)
    refs = _sync_refs(tm, prompts)

    async def go():
        async with AsyncFrontDoor(_engine(tm)) as fd:
            streams = [await fd.submit(p, 8, seed=i)
                       for i, p in enumerate(prompts)]

            async def consume(st):
                return [t async for t in st]

            return await asyncio.gather(*(consume(s) for s in streams))

    assert run(go()) == refs


def test_cancel_releases_slot_and_pages_cold(models):
    tm = models[1]
    prompt = _prompts(1, base_len=17, stride=0)[0]

    async def go():
        eng = _engine(tm)
        fd = AsyncFrontDoor(eng, check_invariants=True)
        st = await fd.submit(prompt, 16, seed=0)
        for _ in range(3):
            await fd.pump()
        assert st.tokens
        st.cancel()
        await fd.pump()
        assert st.outcome == "cancelled"
        assert eng._active_slots() == [] and eng.alloc.held_pages == 0
        assert eng.alloc.cached_pages > 0
        with pytest.raises(Cancelled):
            await st.result()
        st2 = await fd.submit(prompt, 8, seed=0)
        await _drain_all(fd)
        assert st2.outcome == "finished" and eng.prompt_tokens_cached > 0
        st3 = await fd.submit(prompt, 8, seed=0)
        st3.cancel()
        st3.cancel()
        await _drain_all(fd)
        assert eng.stats()["cancelled_requests"] == 2
        return True

    assert run(go())


def _never_submitted(tm, survivor, n_new, **kw):
    return _sync_refs(tm, [survivor], n_new, seeds=[1], **kw)[0]


def test_cancel_during_prefill_chunk(models):
    tm = models[1]
    kw = dict(prefill_chunk=4, prefill_budget=4)
    victim = _prompts(1, base_len=24, stride=0)[0]
    survivor = _prompts(2, base_len=7, stride=0)[1]
    ref = _never_submitted(tm, survivor, 10, **kw)

    async def go():
        eng = _engine(tm, **kw)
        fd = AsyncFrontDoor(eng, check_invariants=True)
        v = await fd.submit(victim, 8, seed=0)
        s = await fd.submit(survivor, 10, seed=1)
        await fd.pump()
        vs = [sl for sl in eng._active_slots()
              if eng.slot_req[sl].rid == v.rid]
        assert vs and eng.prefilling[vs[0]]
        v.cancel()
        await _drain_all(fd)
        assert v.outcome == "cancelled" and v.tokens == []
        assert s.outcome == "finished" and eng.alloc.held_pages == 0
        return s.tokens

    assert run(go()) == ref


def test_cancel_mid_verify_dispatch(models):
    tm = models[1]
    kw = dict(speculate=4)
    prompts = _prompts(2, base_len=9, stride=2)
    ref = _never_submitted(tm, prompts[1], 12, **kw)
    solo = _sync_refs(tm, [prompts[0]], 12, seeds=[0], **kw)[0]

    async def go():
        eng = _engine(tm, **kw)
        fd = AsyncFrontDoor(eng, check_invariants=True)
        v = await fd.submit(prompts[0], 12, seed=0)
        s = await fd.submit(prompts[1], 12, seed=1)
        while not v.tokens:
            await fd.pump()
        assert eng.verify_dispatches >= 1
        v.cancel()
        await _drain_all(fd)
        assert v.outcome == "cancelled" and s.outcome == "finished"
        assert eng.alloc.held_pages == 0
        return v.tokens, s.tokens

    v_toks, s_toks = run(go())
    assert s_toks == ref
    assert v_toks and v_toks == solo[: len(v_toks)]


def test_cancel_queued(models):
    tm = models[1]

    async def go():
        eng = _engine(tm)
        fd = AsyncFrontDoor(eng, check_invariants=True)
        a = await fd.submit(_prompts(1)[0], 8, seed=0)
        b = await fd.submit(_prompts(2)[1], 8, seed=1)
        c = await fd.submit(_prompts(3)[2], 8, seed=2)
        c.cancel()  # nothing stepped: applied at once
        assert c.outcome == "cancelled"
        assert not any(r.rid == c.rid for r in eng.queue)
        await _drain_all(fd)
        assert a.outcome == b.outcome == "finished"
        assert eng.stats()["cancelled_requests"] == 1
        return True

    assert run(go())


def test_priority_dispatch_order(models):
    """One slot: a later priority-5 request goes before an earlier
    priority-0 one (background task)."""
    tm = models[1]

    async def go():
        fd = AsyncFrontDoor(_engine(tm, slots=1))
        filler = await fd.submit(_prompts(1)[0], 4, seed=0)
        lo = await fd.submit(_prompts(2)[1], 4, seed=1, priority=0)
        hi = await fd.submit(_prompts(3)[2], 4, seed=2, priority=5)
        order = []

        async def consume(name, st):
            async for _ in st:
                pass
            order.append(name)

        fd.start()
        await asyncio.gather(consume("filler", filler), consume("lo", lo),
                             consume("hi", hi))
        await fd.close()
        return order

    order = run(go())
    assert order.index("hi") < order.index("lo"), order


def test_aging_starvation_bound(models):
    """A fresh priority-10 request every step, one slot: the priority-0
    one is admitted within (10 - 0) / aging steps plus slack."""
    tm = models[1]

    async def go():
        eng = _engine(tm, slots=1, priority_aging=1.0)
        fd = AsyncFrontDoor(eng)
        flood = _prompts(6, base_len=5, stride=0)
        low = await fd.submit(_prompts(1)[0], 4, seed=0, priority=0)
        for step in range(40):
            await fd.submit(flood[step % 6], 4, seed=step + 1, priority=10)
            await fd.pump()
            if low.tokens or any(eng.slot_req[s].rid == low.rid
                                 for s in eng._active_slots()):
                return step + 1
        return None

    admitted_at = run(go())
    assert admitted_at is not None and admitted_at <= 16, admitted_at


def test_deadline_shed_before_dispatch(models):
    tm = models[1]

    async def go():
        clk = VirtualClock()
        eng = _engine(tm, slots=1, clock=clk, telemetry=True)
        fd = AsyncFrontDoor(eng, check_invariants=True)
        a = await fd.submit(_prompts(1)[0], 8, seed=0, deadline_s=100.0)
        b = await fd.submit(_prompts(2)[1], 8, seed=1, deadline_s=5.0)
        await fd.pump()
        clk.advance(10.0)
        await _drain_all(fd)
        assert a.outcome == "finished"
        assert b.outcome == "expired" and b.tokens == []
        with pytest.raises(DeadlineExceeded):
            await b.result()
        st = eng.stats()
        assert st["deadline_shed_requests"] == 1
        assert st["cancelled_requests"] == 0
        assert "deadline_shed" in [ev.kind for ev in eng.telemetry.events]
        assert b.rid in eng.expired
        return True

    assert run(go())


def test_unpark_sheds_expired_and_keeps_priority_order(models):
    tm = models[1]
    clk = VirtualClock()
    eng = _engine(tm, slots=1, clock=clk, telemetry=True)
    expired = eng.lookup(eng.submit(_prompts(1)[0], 8, deadline_s=5.0))
    alive = eng.lookup(eng.submit(_prompts(2)[1], 8, deadline_s=100.0))
    eng.queue.clear()
    expired.evictions = alive.evictions = 1
    eng.parked.extend([expired, alive])
    clk.advance(10.0)
    eng._unpark()
    assert [r.rid for r in eng.queue] == [alive.rid]
    assert expired.outcome == "expired"
    assert eng.stats()["deadline_shed_requests"] == 1
    ev = [e for e in eng.telemetry.events if e.kind == "deadline_shed"]
    assert ev and ev[0].data.get("where") == "parked"
    eng.submit(_prompts(3)[2], 8, priority=99)
    assert eng.queue[eng._select_queued()].rid == alive.rid


def test_backpressure_defer_waits_raise_and_shed_raise(models):
    tm = models[1]
    bounded = dict(slots=1, max_queue=1)

    async def go():
        eng = _engine(tm, overload_policy="defer", **bounded)
        fd = AsyncFrontDoor(eng)
        s1 = await fd.submit(_prompts(1)[0], 4, seed=0)
        await fd.pump()
        t2 = asyncio.create_task(fd.submit(_prompts(2)[1], 4, seed=1))
        await asyncio.sleep(0)
        t3 = asyncio.create_task(fd.submit(_prompts(3)[2], 4, seed=2))
        await asyncio.sleep(0)
        assert t2.done() and not t3.done()
        assert eng.stats()["deferred_submits"] >= 1
        for _ in range(60):
            await fd.pump()
            if t3.done():
                break
        s3 = await t3
        await _drain_all(fd)
        assert [s1.outcome, (await t2).outcome, s3.outcome] == \
            ["finished"] * 3
        fd2 = AsyncFrontDoor(_engine(tm, overload_policy="defer", **bounded),
                             backpressure="raise")
        await fd2.submit(_prompts(1)[0], 4, seed=0)
        await fd2.pump()
        await fd2.submit(_prompts(2)[1], 4, seed=1)
        with pytest.raises(PoolOverloaded):
            await fd2.submit(_prompts(3)[2], 4, seed=2)
        fd3 = AsyncFrontDoor(_engine(tm, overload_policy="shed", **bounded))
        await fd3.submit(_prompts(1)[0], 4, seed=0)
        await fd3.pump()
        await fd3.submit(_prompts(2)[1], 4, seed=1)
        with pytest.raises(AdmissionRejected):
            await fd3.submit(_prompts(3)[2], 4, seed=2)
        await _drain_all(fd2)
        await _drain_all(fd3)
        return True

    assert run(go())


def _chaos(models, port: bool):
    """One deterministic drive: six submissions (one with a deadline),
    an exhaust fault at step 2, stream 1 cancelled after 2 tokens, the
    virtual clock advanced a unit a pump."""
    jm, tm = models
    prompts = _prompts(6, base_len=5, stride=2)
    plan = "2:exhaust@0:all:3"

    async def go():
        clk = (VirtualClock if port else JaxVirtualClock)()
        if port:
            eng = _engine(tm, clock=clk, telemetry=True, num_pages=6,
                          fault_hook=FaultPlan.parse(plan).hook(0))
            fd = AsyncFrontDoor(eng, check_invariants=True)
        else:
            eng = _jax_engine(jm, clock=clk, telemetry=True, num_pages=6,
                              fault_hook=JaxFaultPlan.parse(plan).hook(0))
            fd = JaxAsyncFrontDoor(eng, check_invariants=True)
        streams = [await fd.submit(p, 8, seed=i, priority=i % 2,
                                   deadline_s=3.0 if i == 4 else None)
                   for i, p in enumerate(prompts)]
        cancelled = False
        for _ in range(200):
            alive = await fd.pump()
            clk.advance(1.0)
            if not cancelled and len(streams[1].tokens) >= 2:
                streams[1].cancel()
                cancelled = True
            if not alive:
                break
        return ([s.outcome for s in streams],
                [list(map(int, s.tokens)) for s in streams],
                eng.telemetry.sequence_signature(), eng.stats())

    return run(go())


def test_chaos_fault_cancel_deadline_matches_jax_and_replays(models):
    ours = _chaos(models, port=True)
    ref = _chaos(models, port=False)
    outcomes, streams, sig, st = ours
    assert outcomes[1] == "cancelled" and outcomes[4] == "expired"
    refs = _sync_refs(models[1], _prompts(6, base_len=5, stride=2))
    for i, (o, toks) in enumerate(zip(outcomes, streams)):
        if o == "finished":
            assert toks == refs[i], i
        else:
            assert toks == refs[i][: len(toks)], i
    assert st["faults_injected"] == 1 and st["cancelled_requests"] == 1
    assert ours[:3] == ref[:3]
    assert st == ref[3]
    assert _chaos(models, port=True)[:3] == ours[:3]


def test_frontdoor_stats(models):
    async def go():
        fd = AsyncFrontDoor(_engine(models[1]))
        await fd.submit(_prompts(1)[0], 4, seed=0)
        await _drain_all(fd)
        st = fd.stats()
        assert st["frontdoor_steps"] == fd.steps >= 1
        assert st["frontdoor_live_streams"] == 0
        assert st["cancelled_requests"] == st["deadline_shed_requests"] == 0
        return True

    assert run(go())
