"""Serving telemetry (counterpart of ``midgpt_tpu.serving.telemetry``):
per-request lifecycle tracing, the pinned ``stats()`` inventory, and the
Chrome trace export. The registry, the event log with its flight-recorder
rings and the Prometheus exporter are the shared substrate of
:mod:`midgpt_tpu_torch.telemetry`, re-exported here.

- :data:`ENGINE_STATS_KEYS`: the exact key inventory of
  ``ServingEngine.stats()``, a view of the engine's
  :class:`MetricsRegistry` (its counter attributes are properties over
  the registry's counters).
- :data:`EVENT_KINDS` and :class:`EngineTelemetry`: typed lifecycle
  events (``submit``, ``queued``, ``admitted``, ``prefill_chunk``,
  ``decode_window``, ``verify_dispatch``, ``tokens``, ``evicted``,
  ``parked``, ``resumed``, ``finished``, ``shed``, ``deferred``,
  ``fault``, ``cancelled``, ``deadline_shed``) keyed to the engine's
  scheduler step, with the engine clock's reading in ``t`` only, so
  :meth:`~midgpt_tpu_torch.telemetry.TelemetryLog.sequence_signature` is
  exact across replays; derived per-request metrics
  (:meth:`EngineTelemetry.request_metrics`: queue delay, TTFT, the
  per-token TBT series, eviction stall, tokens per dispatch).
- :func:`chrome_trace`: request lanes and dispatch lanes in Chrome
  trace-event format (Perfetto, chrome://tracing).

Tracing does not touch the dispatches: every emission reads host state
the scheduler already holds, and a dispatch's duration runs to the
harvest's existing device-to-host read, so tracing adds no
synchronization. With tracing off each site costs one ``is None`` check.

Granularity: the engine emits tokens a window at a time, so the
per-token TBT is the gap between harvest timestamps: 0 within a window,
the window's wall time across windows, the cadence a streaming client
sees.

- :data:`CLUSTER_STATS_KEYS`: the key inventory of
  ``ServingCluster.stats()``: the summed engine keys and the cluster's
  own. A cluster's engines emit ``handoff`` (an export on the prefill
  replica, an import on the decode one; the pump also records a
  ``handoff`` dispatch span on the prefill replica, which
  :func:`chrome_trace` draws in its own lane), ``routed_affinity`` and
  ``routed_fallback`` (the admission's routing, on the chosen replica).
  ``prometheus_text`` of ``ServingCluster.metrics_snapshot()`` labels
  each replica's series and gives the cluster's numbers as
  ``scope="cluster"`` gauges.
"""

from __future__ import annotations

import typing as tp

from midgpt_tpu_torch.telemetry import (  # noqa: F401 (re-exported)
    Counter,
    DispatchRecord,
    Event,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    TelemetryLog,
    percentile,
    prometheus_text,
    write_json,
)

__all__ = [
    "CLUSTER_STATS_KEYS",
    "Counter",
    "DispatchRecord",
    "ENGINE_STATS_KEYS",
    "EngineTelemetry",
    "Event",
    "EVENT_KINDS",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "chrome_trace",
    "percentile",
    "prometheus_text",
    "write_json",
]


#: The exact key inventory of ``ServingEngine.stats()``, in its order.
ENGINE_STATS_KEYS: tp.Tuple[str, ...] = (
    "tp",
    "decode_dispatches",
    "prefill_dispatches",
    "copy_dispatches",
    "tokens_generated",
    "windows",
    "slot_occupancy",
    "evictions",
    "free_pages",
    "cached_pages",
    "cold_reclaims",
    "spilled_pages",
    "spill_faultback_pages",
    "spill_prefetch_pages",
    "spill_readmissions",
    "spill_discards",
    "spill_resident_pages",
    "prompt_tokens_total",
    "prefill_tokens_saved",
    "prefill_tokens_computed",
    "prefix_hit_rate",
    "tokens_per_dispatch",
    "verify_dispatches",
    "spec_drafted_tokens",
    "spec_accepted_tokens",
    "spec_acceptance_rate",
    "admission_rejected",
    "reject_reasons",
    "shed_requests",
    "deferred_submits",
    "livelock_parks",
    "overload_parks",
    "parked_requests",
    "cancelled_requests",
    "deadline_shed_requests",
    "faults_injected",
)

#: ``ServingCluster.stats()``: the summed engine inventory, then the
#: cluster's keys, in its order.
CLUSTER_STATS_KEYS: tp.Tuple[str, ...] = ENGINE_STATS_KEYS + (
    "dp_replicas",
    "prefill_replicas",
    "decode_replicas",
    "watchdog_trips",
    "retries",
    "failovers",
    "requeued_requests",
    "handoffs",
    "handoff_pages_moved",
    "handoff_bytes",
    "handoff_failures",
    "prefix_affinity_hits",
    "routed_fallback",
    "dead_replicas",
    "replica_health",
    "replica_health_reason",
    "per_replica",
)

#: The lifecycle taxonomy. ``submit``: accepted by admission control;
#: ``queued``: entered the wait queue (also on ``resubmit``);
#: ``admitted``: took a slot; ``prefill_chunk`` / ``decode_window`` /
#: ``verify_dispatch``: one dispatch (the dispatch lanes); ``tokens``: one
#: slot's harvest from one dispatch; ``evicted`` / ``parked`` /
#: ``resumed``: preemption and overload; ``finished``; ``shed`` /
#: ``deferred``: a full bounded queue; ``fault``: a scripted fault
#: firing; ``cancelled``: the submitter tore the request down;
#: ``deadline_shed``: a queued or parked request dropped at its deadline;
#: ``handoff``: a page handoff (``direction`` "export" on the source
#: engine, "import" on the destination); ``routed_affinity`` /
#: ``routed_fallback``: the cluster's admission by resident prefix or by
#: load, on the chosen replica.
EVENT_KINDS: tp.Tuple[str, ...] = (
    "submit",
    "queued",
    "admitted",
    "prefill_chunk",
    "decode_window",
    "verify_dispatch",
    "tokens",
    "evicted",
    "parked",
    "resumed",
    "finished",
    "shed",
    "deferred",
    "fault",
    "cancelled",
    "deadline_shed",
    "handoff",
    "routed_affinity",
    "routed_fallback",
)


class EngineTelemetry(TelemetryLog):
    """An engine's event log and flight-recorder rings: the serving
    taxonomy over :class:`~midgpt_tpu_torch.telemetry.TelemetryLog`, with
    derived per-request metrics.

    ``request_log`` keeps every event by request id (bounded per
    request), ``events`` the most recent ``ring`` events, ``dispatches``
    the most recent ``dispatch_ring`` dispatches. ``profile_dir`` with
    ``profile_steps=(start, stop)`` runs a ``torch.profiler`` trace from
    the top of scheduler step ``start`` to the top of ``stop``."""

    event_kinds = EVENT_KINDS

    def token_times(self, rid: int) -> tp.List[float]:
        """Each emitted token's harvest timestamp (a ``tokens`` event of
        ``n`` tokens gives ``n`` copies of its ``t``)."""
        out: tp.List[float] = []
        for ev in self.request_log.get(rid, ()):
            if ev.kind == "tokens":
                out.extend([ev.t] * ev.data.get("n", 0))
        return out

    def request_metrics(self, rid: int) -> tp.Optional[tp.Dict[str, tp.Any]]:
        """Derived metrics of one request (None for an unseen id): queue
        delay (submit to first admission), TTFT (submit to first token),
        the TBT series (consecutive harvest gaps), eviction stall
        (eviction or park to re-admission, summed), evictions, tokens,
        dispatches (harvests that included it), tokens per dispatch, e2e
        (submit to finish) and whether it finished."""
        evs = self.request_log.get(rid)
        if not evs:
            return None
        submit_t: tp.Optional[float] = None
        first_admit_t: tp.Optional[float] = None
        finish_t: tp.Optional[float] = None
        stall = 0.0
        stall_since: tp.Optional[float] = None
        dispatches = 0
        evictions = 0
        for ev in evs:
            if ev.kind in ("submit", "queued") and submit_t is None:
                submit_t = ev.t
            elif ev.kind == "admitted":
                if first_admit_t is None:
                    first_admit_t = ev.t
                if stall_since is not None:
                    stall += ev.t - stall_since
                    stall_since = None
            elif ev.kind in ("evicted", "parked"):
                if ev.kind == "evicted":
                    evictions += 1
                if stall_since is None:
                    stall_since = ev.t
            elif ev.kind == "tokens":
                dispatches += 1
            elif ev.kind == "finished":
                finish_t = ev.t
        tok_ts = self.token_times(rid)
        tbt = [b - a for a, b in zip(tok_ts, tok_ts[1:])]
        return {
            "rid": rid,
            "queue_delay_s": (first_admit_t - submit_t
                              if submit_t is not None
                              and first_admit_t is not None else None),
            "ttft_s": (tok_ts[0] - submit_t
                       if submit_t is not None and tok_ts else None),
            "tbt_s": tbt,
            "eviction_stall_s": stall,
            "evictions": evictions,
            "tokens": len(tok_ts),
            "dispatches": dispatches,
            "tokens_per_dispatch": (len(tok_ts) / dispatches
                                    if dispatches else None),
            "e2e_s": (finish_t - submit_t
                      if submit_t is not None and finish_t is not None
                      else None),
            "finished": finish_t is not None,
        }

    def finished_request_metrics(self) -> tp.List[tp.Dict[str, tp.Any]]:
        """:meth:`request_metrics` of every request whose log ends in
        ``finished``."""
        out = []
        for rid in self.request_log:
            m = self.request_metrics(rid)
            if m is not None and m["finished"]:
                out.append(m)
        return out


_REQ_PID = 1
_DISPATCH_PID = 2
_ENGINE_PID = 3
# the state a request enters at this event, the span the next transition
# closes
_SPAN_FOR = {
    "queued": "queued",
    "admitted": "active",
    "evicted": "requeued",
    "parked": "parked",
    "resumed": "queued",
}
# transitions: each closes the open span; the terminal ones (absent from
# _SPAN_FOR) open none
_CLOSERS = ("queued", "admitted", "evicted", "parked", "resumed", "finished",
            "cancelled", "deadline_shed")


def _span(name: str, t0: float, t1: float, tid: int, base: float, **args):
    return {"name": name, "ph": "X", "pid": _REQ_PID, "tid": tid,
            "ts": (t0 - base) * 1e6, "dur": max(0.0, (t1 - t0)) * 1e6,
            "args": args}


def chrome_trace(tele: EngineTelemetry) -> tp.Dict[str, tp.Any]:
    """A telemetry log as a Chrome trace-event object (``json.dump`` it
    and open it in Perfetto): one process of request lanes (tid = request
    id; spans for the queued, active, requeued and parked phases, instants
    for submit, tokens and the terminal events), one of dispatch lanes
    (one lane per dispatch kind, spans from the dispatch ring), and an
    engine lane for the events no request owns (shed, deferred, fault).
    Timestamps are microseconds from the earliest recorded event."""
    events: tp.List[tp.Dict[str, tp.Any]] = []
    all_ts = [ev.t for evs in tele.request_log.values() for ev in evs]
    all_ts += [d.t for d in tele.dispatches]
    all_ts += [ev.t for ev in tele.events if ev.rid is None]
    base = min(all_ts) if all_ts else 0.0

    events.append({"ph": "M", "pid": _REQ_PID, "name": "process_name",
                   "args": {"name": "requests"}})
    events.append({"ph": "M", "pid": _DISPATCH_PID, "name": "process_name",
                   "args": {"name": "dispatches"}})

    for rid, evs in sorted(tele.request_log.items()):
        events.append({"ph": "M", "pid": _REQ_PID, "tid": rid,
                       "name": "thread_name",
                       "args": {"name": f"request {rid}"}})
        open_name: tp.Optional[str] = None
        open_t = 0.0
        last_t = evs[-1].t if evs else 0.0
        for ev in evs:
            if ev.kind in _CLOSERS:
                if open_name is not None:
                    events.append(_span(open_name, open_t, ev.t, rid, base))
                open_name = _SPAN_FOR.get(ev.kind)
                open_t = ev.t
            if ev.kind in ("tokens", "submit", "finished", "cancelled",
                           "deadline_shed"):
                events.append({"name": ev.kind, "ph": "i", "s": "t",
                               "pid": _REQ_PID, "tid": rid,
                               "ts": (ev.t - base) * 1e6,
                               "args": dict(ev.data, step=ev.step)})
        if open_name is not None:
            events.append(_span(open_name, open_t, last_t, rid, base))

    # events no request owns (a shed or deferred submit never got an id;
    # faults are the engine's) live on the recency ring only; dispatch
    # summaries are rid-less too but render as dispatch spans
    ridless = [ev for ev in tele.events
               if ev.rid is None and ev.kind in ("shed", "deferred", "fault")]
    if ridless:
        events.append({"ph": "M", "pid": _ENGINE_PID, "name": "process_name",
                       "args": {"name": "engine"}})
        for ev in ridless:
            events.append({"name": ev.kind, "ph": "i", "s": "p",
                           "pid": _ENGINE_PID, "tid": 0,
                           "ts": (ev.t - base) * 1e6,
                           "args": dict(ev.data, step=ev.step)})

    lanes = {"decode_window": 0, "verify_dispatch": 1, "prefill_chunk": 2,
             "handoff": 3}
    for kind, tid in lanes.items():
        events.append({"ph": "M", "pid": _DISPATCH_PID, "tid": tid,
                       "name": "thread_name", "args": {"name": kind}})
    for d in tele.dispatches:
        events.append({"name": d.kind, "ph": "X", "pid": _DISPATCH_PID,
                       "tid": lanes.get(d.kind, 4),
                       "ts": (d.t - base) * 1e6,
                       "dur": max(0.0, d.dur) * 1e6,
                       "args": dict(d.data, step=d.step, tokens=d.tokens,
                                    rids=list(d.rids))})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
