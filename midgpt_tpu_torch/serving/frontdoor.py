"""The async streaming front door over a serving engine or cluster
(counterpart of ``midgpt_tpu.serving.frontdoor``).

A :class:`~midgpt_tpu_torch.serving.engine.ServingEngine` or a
:class:`~midgpt_tpu_torch.serving.cluster.ServingCluster` is a library
driven by a loop: ``submit()``, then ``step()`` until it drains. The front
door gives its users what that loop does not, and touches no dispatch:

1. **Token streams** (:class:`TokenStream`): tokens reach ``async for``
   consumers at every harvest (a window of tokens a dispatch), read from
   the host-side ``Request.tokens`` the scheduler already holds through
   the engine's ``lookup``: no device read of its own.
2. **Cancellation** (``TokenStream.cancel``): the slot and its pages are
   released at the next step boundary, the only consistent point of the
   engine. Indexed pages retire cold, as at a finish, so prefix hits
   survive; with ``check_invariants=True`` the allocator and the prefix
   index are checked after every round.
3. **Priorities, deadlines, backpressure**: ``submit(priority=,
   deadline_s=)`` feeds the engine's aged admission and its deadline shed;
   a full bounded queue under ``overload_policy="defer"`` suspends the
   submitter until a later boundary admits it (``backpressure="wait"``)
   or raises :class:`~midgpt_tpu_torch.serving.faults.PoolOverloaded`
   (``"raise"``); a shed raises
   :class:`~midgpt_tpu_torch.serving.faults.AdmissionRejected`.
4. **Determinism**: scheduling stays keyed to engine steps and deadlines
   to the engine's clock (:class:`VirtualClock` in tests), and the front
   door keeps no decision state of its own, so its streams equal the
   synchronous loop's for the same admission order. :meth:`AsyncFrontDoor.
   pump` drives one round by hand; the background task (``async with
   fd:``) runs the same round with the blocking ``step()`` in a worker
   thread, on the engine's CUDA stream, so the event loop stays free
   during a dispatch.

The engine is not thread-safe: submissions and cancels that arrive while
a step runs wait for the step boundary; everything else runs on the event
loop. Over a cluster, request ids are the cluster's: a cancel follows
the route to the replica that holds the request, and after a cold
failover a stream's cursor skips the regrown prefix (the same tokens).
"""

from __future__ import annotations

import asyncio
import collections
import typing as tp

import numpy as np

from midgpt_tpu_torch.serving.cluster import ServingCluster
from midgpt_tpu_torch.serving.engine import Request, ServingEngine
from midgpt_tpu_torch.serving.faults import (
    Cancelled,
    DeadlineExceeded,
    PoolOverloaded,
)

__all__ = ["AsyncFrontDoor", "Backend", "TokenStream", "VirtualClock"]

Backend = tp.Union[ServingEngine, ServingCluster]

_DONE = object()  # a stream's end


class VirtualClock:
    """A clock that moves only as told: pass it as the engine's
    ``clock=`` and advance it from the test, and every deadline decision
    follows the drive schedule. ``tick`` advances it by a fixed amount at
    each read (still deterministic: the engine's reads are)."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        if tick < 0.0:
            raise ValueError(f"tick must be >= 0, got {tick}")
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"a clock does not go back: {dt}")
        self.t += dt
        return self.t


class TokenStream:
    """One request's tokens as they are harvested (``async for tok in
    stream``). Iteration ends at any terminal outcome: ``stream.outcome``
    is ``"finished"``, ``"cancelled"``, ``"expired"`` or ``"error"``, and
    :meth:`result` returns the tokens or raises
    :class:`~midgpt_tpu_torch.serving.faults.Cancelled` /
    :class:`~midgpt_tpu_torch.serving.faults.DeadlineExceeded`.
    ``tokens`` holds everything streamed so far."""

    def __init__(self, fd: "AsyncFrontDoor", rid: int, *, priority: int,
                 deadline_s: tp.Optional[float]):
        self._fd = fd
        self.rid = rid
        self.priority = priority
        self.deadline_s = deadline_s
        self.tokens: tp.List[int] = []
        self.outcome: tp.Optional[str] = None
        self.request: tp.Optional[Request] = None  # set at the end
        self._cursor = 0  # engine-side tokens already streamed
        self._q: asyncio.Queue = asyncio.Queue()
        self._buf: tp.Deque[int] = collections.deque()
        self._ended = False

    def cancel(self) -> None:
        """Tear the request down at the next step boundary; idempotent."""
        if self.outcome is None:
            self._fd.cancel(self.rid)

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while not self._buf:
            if self._ended:
                raise StopAsyncIteration
            item = await self._q.get()
            if item is _DONE:
                self._ended = True
                raise StopAsyncIteration
            self._buf.extend(item)
        return self._buf.popleft()

    async def result(self) -> tp.List[int]:
        """Drain the stream and return its tokens; raises the typed
        outcome of a cancelled, expired or failed request."""
        async for _ in self:
            pass
        if self.outcome == "cancelled":
            raise Cancelled(self.rid, len(self.tokens))
        if self.outcome == "expired":
            raise DeadlineExceeded(self.rid, len(self.tokens))
        if self.outcome == "error":
            exc = self._fd.error
            raise exc if exc is not None else RuntimeError(
                f"request {self.rid} ended without an outcome")
        return list(self.tokens)

    # the event loop's side

    def _push(self, new: tp.Sequence[int]) -> None:
        self.tokens.extend(int(t) for t in new)
        self._q.put_nowait([int(t) for t in new])

    def _finish(self, outcome: str, req: tp.Optional[Request]) -> None:
        self.outcome = outcome
        self.request = req
        self._q.put_nowait(_DONE)


class AsyncFrontDoor:
    """The asyncio front door over one :class:`ServingEngine` or
    :class:`ServingCluster`.

    Two ways to drive the same round (cancels, one ``step()``, harvest):

    - the **background task** (``async with AsyncFrontDoor(engine) as
      fd:`` or ``fd.start()``): a task loops over rounds, with ``step()``
      in a worker thread (``asyncio.to_thread``) that makes the engine's
      device and stream current (a cluster enters each replica's), so
      submitters, cancels and consumers run during a dispatch;
    - the **manual pump** (never ``start()``; ``await fd.pump()`` a
      round): one task, the engine stepped inline, every decision a
      function of the pump, submit and cancel schedule.

    Submissions run at once when no step is in flight (admission order is
    call order) and otherwise wait for the boundary. ``check_invariants``
    checks the allocator and the prefix index (with the spill store) of
    every live engine after every round."""

    def __init__(self, backend: Backend, *, backpressure: str = "wait",
                 check_invariants: bool = False):
        if backpressure not in ("wait", "raise"):
            raise ValueError(f"unknown backpressure {backpressure!r}")
        self.backend = backend
        self.backpressure = backpressure
        self.check_invariants = check_invariants
        self.steps = 0
        self.error: tp.Optional[BaseException] = None
        self._streams: tp.Dict[int, TokenStream] = {}
        self._cancels: tp.Deque[int] = collections.deque()
        self._stepping = False
        self._closed = False
        self._task: tp.Optional[asyncio.Task] = None
        self._boundary: asyncio.Event = asyncio.Event()
        self._wake: asyncio.Event = asyncio.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start the background task (idempotent)."""
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._drive(), name="serving-frontdoor")

    async def __aenter__(self) -> "AsyncFrontDoor":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Stop the background task once the round in flight settles. Live streams
        are not cancelled: :meth:`drain` first to finish them."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        # a submitter waiting on a boundary sees the close and raises
        self._flip_boundary()

    # -- submission ---------------------------------------------------------

    def _engines(self) -> tp.List[ServingEngine]:
        """The live engines: a cluster's live replicas."""
        if isinstance(self.backend, ServingCluster):
            cl = self.backend
            return [cl.engines[i] for i in cl._alive()]
        return [self.backend]

    @property
    def live_streams(self) -> int:
        return len(self._streams)

    async def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
                     eos_id: tp.Optional[int] = None, seed: int = 0,
                     priority: int = 0,
                     deadline_s: tp.Optional[float] = None,
                     deadline: tp.Optional[float] = None,
                     backpressure: tp.Optional[str] = None) -> TokenStream:
        """Admit a request and return its :class:`TokenStream`. A full
        bounded queue under the defer policy makes this coroutine wait
        and retry at each boundary (``backpressure="wait"``, the default)
        or raise ``PoolOverloaded`` (``"raise"``); a shed or a permanent
        rejection raises ``AdmissionRejected``. ``deadline`` is an
        absolute instant on the engine's clock (it wins over
        ``deadline_s``), for an SLO counted from arrival while
        backpressure delays the admission."""
        bp = backpressure if backpressure is not None else self.backpressure
        if bp not in ("wait", "raise"):
            raise ValueError(f"unknown backpressure {bp!r}")
        while True:
            if self.error is not None:
                raise self.error
            if self._closed:
                raise RuntimeError("front door is closed")
            if self._stepping:
                await self._next_boundary()
                continue
            try:
                rid = self.backend.submit(
                    prompt, max_new_tokens, eos_id=eos_id, seed=seed,
                    priority=priority, deadline_s=deadline_s,
                    deadline=deadline)
            except PoolOverloaded:
                if bp == "raise":
                    raise
                # the queue is full now; the next boundary is the earliest
                # it can drain
                await self._next_boundary()
                continue
            stream = TokenStream(self, rid, priority=priority,
                                 deadline_s=deadline_s)
            self._streams[rid] = stream
            self._wake.set()
            return stream

    def cancel(self, rid: int) -> None:
        """Cancel at the next step boundary (at once when driven by hand
        and no step runs)."""
        self._cancels.append(rid)
        self._wake.set()
        if not self._stepping and self._task is None:
            self._process_cancels()
            self._harvest()

    # -- the scheduler round ------------------------------------------------

    def _process_cancels(self) -> None:
        while self._cancels:
            rid = self._cancels.popleft()
            if rid in self._streams:
                self.backend.cancel(rid)

    def _flip_boundary(self) -> None:
        ev, self._boundary = self._boundary, asyncio.Event()
        ev.set()

    async def _next_boundary(self) -> None:
        await self._boundary.wait()

    def _check(self) -> None:
        for e in self._engines():
            e.alloc.check()
            if e.index is not None:
                e.index.check(e.alloc, e._spill_store)

    def _harvest(self) -> None:
        """Push each live stream's new tokens and end the streams whose
        request ended: host reads through ``lookup`` only."""
        done: tp.List[int] = []
        for rid, stream in self._streams.items():
            req = self.backend.lookup(rid)
            if req is not None and len(req.tokens) > stream._cursor:
                stream._push(req.tokens[stream._cursor:])
                stream._cursor = len(req.tokens)
            if req is not None and req.outcome != "pending":
                stream._finish(req.outcome, req)
                done.append(rid)
            elif req is None and self.error is not None:
                stream._finish("error", None)
                done.append(rid)
        for rid in done:
            del self._streams[rid]

    def _step_on_stream(self) -> None:
        """``step()`` in a worker thread: the current device and stream
        are per thread, so make the engine's current there (a cluster
        does so for each replica itself)."""
        if isinstance(self.backend, ServingCluster):
            self.backend.step()
            return
        with self.backend.on_stream():
            self.backend.step()

    async def pump(self) -> bool:
        """One round by hand: pending cancels, one step inline, harvest
        (and the invariant check), boundary. True while streams or engine
        work remain. Not for use beside the background task."""
        if self._task is not None:
            raise RuntimeError("pump() drives by hand; the background "
                               "task is running")
        await self._round(threaded=False)
        return bool(self._streams) or self.backend.has_work

    async def _round(self, threaded: bool) -> None:
        self._process_cancels()
        if self.backend.has_work:
            self._stepping = True
            try:
                if threaded:
                    await asyncio.to_thread(self._step_on_stream)
                else:
                    self.backend.step()
            except BaseException as exc:  # noqa: BLE001
                # a fault ends the streams instead of stranding their
                # consumers; result() raises it
                self.error = exc
            finally:
                self._stepping = False
            self.steps += 1
        self._harvest()
        if self.error is not None:
            for rid, stream in list(self._streams.items()):
                stream._finish("error", None)
                del self._streams[rid]
        if self.check_invariants:
            self._check()
        self._flip_boundary()

    async def _drive(self) -> None:
        while not self._closed:
            if self.backend.has_work or self._cancels:
                await self._round(threaded=True)
                if self.error is not None:
                    return
                # let consumers and submitters run between rounds
                await asyncio.sleep(0)
            else:
                self._harvest()  # e.g. cancels applied while idle
                self._wake.clear()
                if self._closed:
                    return
                await self._wake.wait()

    # -- draining and reporting ---------------------------------------------

    async def drain(self) -> None:
        """Wait until every accepted stream has ended (background task: on
        boundaries; by hand: pumping)."""
        while self._streams or self.backend.has_work:
            if self.error is not None and not self._streams:
                return
            if self._task is not None:
                await self._next_boundary()
            else:
                await self.pump()

    def stats(self) -> tp.Dict[str, tp.Any]:
        """The engine's stats and the front door's own counters."""
        st = dict(self.backend.stats())
        st["frontdoor_steps"] = self.steps
        st["frontdoor_live_streams"] = len(self._streams)
        return st
