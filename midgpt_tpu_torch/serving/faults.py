"""The serving stack's typed failures and its scripted fault plan
(counterpart of ``midgpt_tpu.serving.faults``, which is pure Python; the
port keeps its own copy).

1. **Typed exceptions.** Admission failures are :class:`AdmissionRejected`
   (permanent: this engine can never serve the request; ``reason`` is
   machine-readable) or :class:`PoolOverloaded` (transient backpressure:
   retry later). Replica failures a cluster recovers from are
   :class:`ReplicaCrash`, :class:`WedgedDispatch` and
   :class:`TransientDispatchError`; :class:`ClusterUnavailable` is the end
   of the line. :class:`Cancelled` and :class:`DeadlineExceeded` are the
   exception forms of the two outcomes after admission that are not a
   finish: the engine records them as ``Request.outcome`` (``"cancelled"``,
   ``"expired"``) and counters, and never raises them itself.

2. **A scripted fault plan.** A :class:`FaultPlan` is an ordered list of
   :class:`FaultEvent` s keyed to an engine's scheduler-step counter, not
   to the wall clock, so a run is a function of (trace, plan). Events fire
   at the top of ``ServingEngine.step`` through its ``fault_hook``, before
   any dispatch changes engine or pool state.

Event kinds:

- ``crash``     -- :class:`ReplicaCrash` on the spot.
- ``wedge``     -- ``seconds`` of stall, then :class:`WedgedDispatch`.
- ``transient`` -- one retriable :class:`TransientDispatchError`.
- ``exhaust``   -- quarantine ``pages`` free pages (-1 = all) for
                   ``hold_steps`` scheduler steps, then release them and
                   un-park: eviction and parking without a device fault.
- ``handoff``   -- arm ``engine._handoff_poison`` for the next page
                   handoff off this engine.

Spec grammar::

    STEP:KIND[@REPLICA][:ARG[:ARG2]] [; ...]

    "6:crash@1"            replica 1 crashes at its 6th step
    "4:wedge@0:0.5"        replica 0 stalls 0.5 s
    "3:transient"          replica 0, one retriable failure at step 3
    "2:exhaust@0:all:3"    quarantine all free pages for 3 steps
    "2:handoff@0"          replica 0's next page export fails
"""

from __future__ import annotations

import dataclasses
import time
import typing as tp

__all__ = [
    "AdmissionRejected",
    "Cancelled",
    "ClusterUnavailable",
    "DeadlineExceeded",
    "FaultEvent",
    "FaultPlan",
    "HandoffFailed",
    "PoolOverloaded",
    "ReplicaCrash",
    "ServingFault",
    "TransientDispatchError",
    "WedgedDispatch",
]


class ServingFault(Exception):
    """Base of every typed serving failure (injected or organic)."""


class ReplicaCrash(ServingFault):
    """The replica is gone; its engine must not be stepped again."""


class WedgedDispatch(ServingFault):
    """A dispatch stalled past any useful deadline."""


class TransientDispatchError(ServingFault):
    """A retriable dispatch failure: the same replica may succeed."""


class _ReasonedFault(ServingFault):
    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(f"[{reason}] {message}")


class AdmissionRejected(_ReasonedFault):
    """Permanent admission failure: this engine can never serve the
    request. ``reason``: ``bad_budget``, ``budget_exceeds_block``,
    ``empty_prompt``, ``lifetime_exceeds_pool``, or ``queue_full`` under
    the shed policy. Counted in ``stats()``."""


class PoolOverloaded(_ReasonedFault):
    """Transient backpressure: the request was not accepted and may be
    submitted again later (``reason="queue_full"`` under the defer
    policy)."""


class Cancelled(ServingFault):
    """The request was cancelled by its submitter after admission. The
    engine records the outcome (``Request.outcome == "cancelled"``, the
    ``cancelled_requests`` counter) and does not raise this."""

    def __init__(self, rid: int, tokens_emitted: int = 0):
        self.rid = rid
        self.tokens_emitted = tokens_emitted
        super().__init__(
            f"request {rid} cancelled after {tokens_emitted} tokens")


class DeadlineExceeded(ServingFault):
    """The request's deadline passed while it still waited for dispatch
    (queued or parked), so the scheduler shed it. Recorded as
    ``Request.outcome == "expired"`` and the ``deadline_shed_requests``
    counter; a request in a slot is never shed."""

    def __init__(self, rid: int, tokens_emitted: int = 0):
        self.rid = rid
        self.tokens_emitted = tokens_emitted
        super().__init__(
            f"request {rid} shed: deadline passed before dispatch "
            f"({tokens_emitted} tokens emitted)")


class HandoffFailed(ServingFault):
    """A page handoff between engines failed before the exported state
    left the source engine."""


class ClusterUnavailable(ServingFault):
    """Every replica is dead and requests are still pending."""


_KINDS = ("crash", "wedge", "transient", "exhaust", "handoff")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted fault, keyed to a replica's scheduler-step counter:
    it fires at the top of that replica's ``step()`` call number ``step``
    (1-based)."""

    step: int
    kind: str
    replica: int = 0
    seconds: float = 0.25  # wedge: simulated stall before the raise
    pages: int = -1  # exhaust: free pages to quarantine (-1 = all)
    hold_steps: int = 1  # exhaust: scheduler steps until the release

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step < 1:
            raise ValueError(f"steps are 1-based, got {self.step}")
        if self.replica < 0:
            raise ValueError(f"replica must be >= 0, got {self.replica}")
        if self.hold_steps < 1:
            raise ValueError(f"hold_steps must be >= 1, got "
                             f"{self.hold_steps}")

    def spec(self) -> str:
        base = f"{self.step}:{self.kind}@{self.replica}"
        if self.kind == "wedge":
            return f"{base}:{self.seconds:g}"
        if self.kind == "exhaust":
            pages = "all" if self.pages < 0 else str(self.pages)
            return f"{base}:{pages}:{self.hold_steps}"
        return base


class FaultPlan:
    """An ordered, replayable fault script. Build it from events or
    :meth:`parse` a spec string; install one per engine with
    ``ServingEngine(fault_hook=plan.hook(i))``."""

    def __init__(self, events: tp.Iterable[FaultEvent]):
        # by step, then authoring order (sorted() is stable)
        self.events: tp.Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self._by_key: tp.Dict[tp.Tuple[int, int], tp.List[FaultEvent]] = {}
        for ev in self.events:
            self._by_key.setdefault((ev.replica, ev.step), []).append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def replicas(self) -> tp.Set[int]:
        return {ev.replica for ev in self.events}

    def events_for(self, replica: int, step: int) -> tp.List[FaultEvent]:
        return self._by_key.get((replica, step), [])

    def spec(self) -> str:
        """The spec string; ``FaultPlan.parse(plan.spec())`` gives the
        plan back."""
        return ";".join(ev.spec() for ev in self.events)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(f"malformed fault event {part!r}")
            head = fields[1]
            if "@" in head:
                kind, rep = head.split("@", 1)
                replica = int(rep)
            else:
                kind, replica = head, 0
            kw: tp.Dict[str, tp.Any] = {}
            if kind == "wedge" and len(fields) > 2:
                kw["seconds"] = float(fields[2])
            if kind == "exhaust":
                if len(fields) > 2:
                    kw["pages"] = -1 if fields[2] == "all" else int(fields[2])
                if len(fields) > 3:
                    kw["hold_steps"] = int(fields[3])
            events.append(FaultEvent(step=int(fields[0]), kind=kind,
                                     replica=replica, **kw))
        return cls(events)

    def hook(self, replica: int = 0) -> "_EngineFaultHook":
        """The injection callable for ``replica``. It keeps state (the
        pending quarantine release), so take a fresh hook per engine."""
        return _EngineFaultHook(self, replica)


class _EngineFaultHook:
    """Called at the top of every ``step()`` with the engine, after
    ``engine.fault_step`` was incremented. Raises the scripted faults and
    changes only the host-side allocator (quarantine), never device
    state, so the engine stays resumable and drainable."""

    def __init__(self, plan: FaultPlan, replica: int):
        self._plan = plan
        self._replica = replica
        self._release_at: tp.Optional[int] = None

    def __call__(self, engine) -> None:
        step = engine.fault_step
        if self._release_at is not None and step >= self._release_at:
            engine.alloc.release_quarantined()
            self._release_at = None
            engine._unpark()  # quarantine-parked requests may fit again
        for ev in self._plan.events_for(self._replica, step):
            engine.faults_injected += 1
            if engine.telemetry is not None:
                # what fired goes on the timeline before it goes quiet;
                # spec() is deterministic, so replays keep their events
                engine.telemetry.emit("fault", step=step, t=engine.clock(),
                                      fault=ev.kind, spec=ev.spec())
            if ev.kind == "exhaust":
                engine.alloc.quarantine(ev.pages)
                due = step + ev.hold_steps
                self._release_at = (due if self._release_at is None
                                    else max(self._release_at, due))
            elif ev.kind == "handoff":
                # armed, not raised: it fires in the next page export
                engine._handoff_poison = True
            elif ev.kind == "crash":
                raise ReplicaCrash(f"scripted crash at step {step}")
            elif ev.kind == "transient":
                raise TransientDispatchError(
                    f"scripted transient dispatch error at step {step}")
            elif ev.kind == "wedge":
                time.sleep(ev.seconds)
                raise WedgedDispatch(
                    f"scripted {ev.seconds:g}s wedge at step {step}")
