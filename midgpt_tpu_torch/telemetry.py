"""Shared telemetry substrate (counterpart of ``midgpt_tpu.telemetry``):
metrics registry, typed event log with flight-recorder rings, and a
Prometheus text-exposition exporter.

- :class:`Counter`, :class:`Gauge`, :class:`Histogram`,
  :class:`MetricsRegistry`, :func:`percentile`;
- the :class:`Event` / :class:`DispatchRecord` record types and the
  :class:`TelemetryLog` base (bounded recency ring, timed-span ring,
  per-key event log, replay signature, an optional ``torch.profiler``
  window);
- :func:`write_json` and :func:`prometheus_text`.

The training loop builds on it (``midgpt_tpu_torch.train_telemetry``).
Every emission reads host-side state the caller already holds, and wall
clock lives only in the ``t``/``dur`` fields: ``data`` stays
deterministic, so :meth:`TelemetryLog.sequence_signature` is exact
across replays.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import typing as tp

__all__ = [
    "Counter",
    "DispatchRecord",
    "Event",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "MetricsRegistry",
    "TelemetryLog",
    "percentile",
    "prometheus_text",
    "start_profiler",
    "stop_profiler",
    "write_json",
]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

#: Fixed latency buckets (seconds) shared by every latency histogram:
#: sub-ms through 10 s, roughly x2.5 per step. Fixed (not adaptive) so
#: snapshots from different runs/replicas merge bucket-for-bucket.
LATENCY_BUCKETS_S: tp.Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """A monotone-by-convention integer metric. ``value`` is plainly
    assignable (a warm-up reset zeroes it)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """A point-in-time reading: either ``set()`` explicitly or backed by
    a zero-arg callback evaluated at snapshot time (the registry's way
    of exporting live engine state — pool occupancy, queue depth —
    without mirroring writes into the hot path)."""

    __slots__ = ("name", "fn", "value")

    def __init__(self, name: str, fn: tp.Optional[tp.Callable[[], float]] = None):
        self.name = name
        self.fn = fn
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def read(self) -> float:
        return self.fn() if self.fn is not None else self.value


class Histogram:
    """A fixed-bucket histogram: ``counts[i]`` counts observations
    ``<= bounds[i]``, with one overflow bucket at the end. Bounds are
    immutable after construction so snapshots merge across replicas."""

    __slots__ = ("name", "bounds", "counts", "total", "count")

    def __init__(self, name: str, bounds: tp.Sequence[float] = LATENCY_BUCKETS_S):
        assert list(bounds) == sorted(bounds), "bucket bounds must ascend"
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0.0
        self.count = 0

    def to_dict(self) -> tp.Dict[str, tp.Any]:
        return {
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.total,
        }


class MetricsRegistry:
    """Counters + gauges + histograms under get-or-create names, with a
    JSON-exportable :meth:`snapshot`. ``attach_labels`` registers a
    labeled counter family *by reference* (e.g. the engine's
    ``reject_reasons`` dict) so the owner keeps mutating its own dict
    and the snapshot sees it live."""

    def __init__(self) -> None:
        self.counters: tp.Dict[str, Counter] = {}
        self.gauges: tp.Dict[str, Gauge] = {}
        self.histograms: tp.Dict[str, Histogram] = {}
        self._labels: tp.Dict[str, tp.Dict[str, int]] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(
        self, name: str, fn: tp.Optional[tp.Callable[[], float]] = None
    ) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name, fn)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(
        self, name: str, bounds: tp.Sequence[float] = LATENCY_BUCKETS_S
    ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        return h

    def attach_labels(self, name: str, labels: tp.Dict[str, int]) -> None:
        self._labels[name] = labels

    def reset_histograms(self) -> None:
        """Zero every histogram in place (bounds kept): a post-warm-up
        reset, next to the counter zeroing."""
        for h in self.histograms.values():
            h.reset()

    def snapshot(self) -> tp.Dict[str, tp.Any]:
        """One JSON-able view of everything: counters by value, gauges
        evaluated now, histograms with bucket arrays, labeled families
        copied. This is the superset ``stats()`` selects its façade
        from."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "labeled": {k: dict(v) for k, v in sorted(self._labels.items())},
            "gauges": {k: g.read() for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: h.to_dict() for k, h in sorted(self.histograms.items())
            },
        }


def percentile(sorted_vals: tp.Sequence[float], q: float) -> tp.Optional[float]:
    """Nearest-rank percentile over an ascending list (None when empty)
    (the JAX package's serving benchmark's convention)."""
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(q * len(sorted_vals)))]


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Event:
    """One lifecycle event. ``step`` is the owner's deterministic step
    counter (scheduler step for serving, optimizer-step window index for
    training) and ``seq`` the per-log emission index; both are
    replay-deterministic. ``t`` is the owner clock's monotonic reading
    and is the ONLY wall-clock field — ``data`` carries deterministic
    values (slots, counts, reasons) exclusively, which is what makes
    :meth:`TelemetryLog.sequence_signature` exact across replays."""

    seq: int
    step: int
    kind: str
    rid: tp.Optional[int]
    t: float
    data: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)

    def signature(self) -> tp.Tuple:
        return (
            self.seq, self.step, self.kind, self.rid,
            tuple(sorted(self.data.items())),
        )

    def to_json(self) -> tp.Dict[str, tp.Any]:
        return {
            "seq": self.seq,
            "step": self.step,
            "kind": self.kind,
            "rid": self.rid,
            "t": self.t,
            **self.data,
        }


@dataclasses.dataclass
class DispatchRecord:
    """One timed span, as the host saw it: for serving, a
    compiled-program launch with ``dur`` running to the window's
    existing device->host harvest read; for training, a loop phase
    (prefetch wait, fused window launch->harvest, eval pause,
    checkpoint save) bounded by host reads the loop already performs.
    No syncs are added either way."""

    seq: int
    step: int
    kind: str
    t: float
    dur: float
    rids: tp.Tuple[int, ...]
    tokens: int
    data: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> tp.Dict[str, tp.Any]:
        return {
            "seq": self.seq,
            "step": self.step,
            "kind": self.kind,
            "t": self.t,
            "dur": self.dur,
            "rids": list(self.rids),
            "tokens": self.tokens,
            **self.data,
        }


# ---------------------------------------------------------------------------
# TelemetryLog — the shared event-log / flight-recorder core
# ---------------------------------------------------------------------------


class TelemetryLog:
    """Typed event log + flight-recorder rings, taxonomy-parameterized.

    Two views of one stream: ``request_log`` keeps every event per key
    (request id for serving, anything the owner chooses; bounded per
    key), while ``events`` is the bounded *recency* ring the flight
    recorder dumps (``ring`` events). ``dispatches`` is the companion
    ring of the last ``dispatch_ring`` timed spans.

    ``profile_dir`` + ``profile_steps=(start, stop)`` arm the optional
    ``torch.profiler`` hooks: the owner calls :meth:`maybe_profile` at the
    top of each step so a profiler trace starts at step ``start`` and
    stops at the top of ``stop`` — a bounded window around exactly the
    steps under investigation, host-driven, with no effect on any
    compiled program.
    """

    #: Subclasses pin their taxonomy here; ``emit`` asserts membership.
    event_kinds: tp.Tuple[str, ...] = ()

    def __init__(
        self,
        *,
        ring: int = 4096,
        dispatch_ring: int = 512,
        per_request_cap: int = 4096,
        profile_dir: tp.Optional[str] = None,
        profile_steps: tp.Optional[tp.Tuple[int, int]] = None,
    ):
        assert ring >= 1 and dispatch_ring >= 1 and per_request_cap >= 1
        if profile_steps is not None:
            assert profile_dir is not None, "profile_steps needs profile_dir"
            assert profile_steps[0] < profile_steps[1], profile_steps
        self.ring_capacity = ring
        self.dispatch_ring_capacity = dispatch_ring
        self.per_request_cap = per_request_cap
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiler: tp.Any = None
        self.events: tp.Deque[Event] = collections.deque(maxlen=ring)
        self.dispatches: tp.Deque[DispatchRecord] = collections.deque(
            maxlen=dispatch_ring
        )
        self.request_log: tp.Dict[int, tp.List[Event]] = {}
        self._seq = 0

    # -- recording ---------------------------------------------------------

    def emit(
        self,
        kind: str,
        *,
        step: int,
        t: float,
        rid: tp.Optional[int] = None,
        **data,
    ) -> Event:
        assert kind in self.event_kinds, kind
        ev = Event(self._seq, step, kind, rid, t, data)
        self._seq += 1
        self.events.append(ev)
        if rid is not None:
            log = self.request_log.setdefault(rid, [])
            if len(log) < self.per_request_cap:
                log.append(ev)
        return ev

    def record_dispatch(
        self,
        kind: str,
        *,
        step: int,
        t: float,
        dur: float,
        rids: tp.Sequence[int],
        tokens: int,
        **data,
    ) -> DispatchRecord:
        rec = DispatchRecord(
            self._seq, step, kind, t, dur, tuple(rids), tokens, data
        )
        # dispatch records share the event seq space so the flight dump
        # interleaves them unambiguously
        self._seq += 1
        self.dispatches.append(rec)
        return rec

    def reset(self) -> None:
        """Drop everything recorded so far (after a warm-up, so the
        measured trace's events start at seq 0)."""
        self.events.clear()
        self.dispatches.clear()
        self.request_log.clear()
        self._seq = 0

    # -- optional torch.profiler window ------------------------------------

    def maybe_profile(self, step: int) -> None:
        """Called by the owner at the top of each step (only when
        telemetry is attached). Starts a ``torch.profiler`` trace at step
        ``start`` and stops it at the top of step ``stop``, writing a
        Chrome trace into ``profile_dir``; no-op without
        ``profile_steps``."""
        if self.profile_steps is None:
            return
        start, stop = self.profile_steps
        if self._profiler is None and step == start:
            self._profiler = start_profiler()
        elif self._profiler is not None and step >= stop:
            self.stop_profiling()

    def stop_profiling(self) -> None:
        """Stop an in-flight trace and write it (idempotent). The owner
        calls this when it drains, so a run ending before the configured
        ``stop`` step still writes its trace."""
        if self._profiler is None:
            return
        stop_profiler(self._profiler, self.profile_dir)
        self._profiler = None

    # -- replay determinism -------------------------------------------------

    def sequence_signature(self) -> tp.Tuple[tp.Tuple, ...]:
        """The event stream minus wall-clock: what a replay must
        reproduce exactly (events are keyed to the owner's deterministic
        step counter, and every ``data`` field is deterministic under
        the owner's replay contract). Ring-bounded: compare runs whose
        event count fits ``ring``."""
        return tuple(ev.signature() for ev in self.events)

    # -- flight recorder ----------------------------------------------------

    def flight_payload(self) -> tp.Dict[str, tp.Any]:
        """The ring contents as JSON-able structures. Snapshot-copies
        under the GIL, so it is safe to call from another thread
        best-effort (a watchdog: a wedged step thread may still append,
        and a dump that misses its last event beats no dump)."""
        return {
            "ring_capacity": self.ring_capacity,
            "events": [ev.to_json() for ev in list(self.events)],
            "dispatches": [d.to_json() for d in list(self.dispatches)],
        }


def start_profiler() -> tp.Any:
    """A running ``torch.profiler`` over the host and, where there is
    one, the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof: tp.Any, profile_dir: str) -> str:
    """Stop ``prof`` (after the card's queued work) and write its Chrome
    trace into ``profile_dir``; returns the trace's path."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(profile_dir), "trace.json")
    prof.export_chrome_trace(path)
    return path


def write_json(path: str, payload: tp.Dict[str, tp.Any]) -> str:
    """Write a JSON artifact, creating parent directories; returns the
    absolute path (what watchdog rows and flight dumps record
    in-band)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition (the pull-scrape view of metrics_snapshot)
# ---------------------------------------------------------------------------

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(prefix: str, name: str, suffix: str = "") -> str:
    return _PROM_NAME_RE.sub("_", f"{prefix}_{name}{suffix}")


def _prom_labels(labels: tp.Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


def _is_registry_snapshot(snap: tp.Mapping[str, tp.Any]) -> bool:
    return {"counters", "gauges", "histograms"} <= set(snap)


def _expand(
    snap: tp.Mapping[str, tp.Any], labels: tp.Mapping[str, str]
) -> tp.List[tp.Tuple[tp.Dict[str, str], tp.Mapping[str, tp.Any]]]:
    """Normalize one snapshot into (labels, registry_snapshot) pairs.
    A cluster-shaped snapshot (``{"cluster": ..., "replicas": [...]}``,
    see ``ServingCluster.metrics_snapshot``) expands to one pair per
    replica plus a synthesized gauge-only pair for the cluster-level
    numeric scalars."""
    if _is_registry_snapshot(snap):
        return [(dict(labels), snap)]
    if "replicas" in snap and "cluster" in snap:
        out = []
        gauges = {
            k: float(v)
            for k, v in snap["cluster"].items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        out.append((
            dict(labels, scope="cluster"),
            {"counters": {}, "labeled": {}, "gauges": gauges,
             "histograms": {}},
        ))
        for i, rep in enumerate(snap["replicas"]):
            out.extend(_expand(rep, dict(labels, replica=str(i))))
        return out
    raise ValueError(
        f"not a registry or cluster metrics snapshot: {sorted(snap)[:6]}"
    )


def prometheus_text(
    snapshots: tp.Union[
        tp.Mapping[str, tp.Any],
        tp.Sequence[tp.Tuple[tp.Mapping[str, str], tp.Mapping[str, tp.Any]]],
    ],
    prefix: str = "midgpt",
) -> str:
    """Render metrics snapshots in Prometheus text exposition format.

    Accepts a single ``MetricsRegistry.snapshot()`` dict, a
    cluster-shaped snapshot (``{"cluster": ..., "replicas": [...]}``), or
    an explicit sequence of ``(labels, snapshot)`` pairs (one per
    replica). Conventions: counters get a
    ``_total`` suffix, labeled families render as one labeled series
    per key, histograms render cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count``. ``# TYPE`` headers are emitted once per
    family, so concatenated replica snapshots stay parseable."""
    if isinstance(snapshots, tp.Mapping):
        pairs = _expand(snapshots, {})
    else:
        pairs = []
        for labels, snap in snapshots:
            pairs.extend(_expand(snap, labels))

    # family name -> (type, [lines])
    families: tp.Dict[str, tp.Tuple[str, tp.List[str]]] = {}

    def fam(name: str, typ: str) -> tp.List[str]:
        if name not in families:
            families[name] = (typ, [])
        return families[name][1]

    for labels, snap in pairs:
        for name, v in snap.get("counters", {}).items():
            n = _prom_name(prefix, name, "_total")
            fam(n, "counter").append(f"{n}{_prom_labels(labels)} {v}")
        for name, series in snap.get("labeled", {}).items():
            n = _prom_name(prefix, name, "_total")
            lines = fam(n, "counter")
            for key, v in sorted(series.items()):
                lines.append(
                    f"{n}{_prom_labels(dict(labels, key=str(key)))} {v}"
                )
        for name, v in snap.get("gauges", {}).items():
            n = _prom_name(prefix, name)
            fam(n, "gauge").append(f"{n}{_prom_labels(labels)} {v}")
        for name, h in snap.get("histograms", {}).items():
            n = _prom_name(prefix, name)
            lines = fam(n, "histogram")
            cum = 0
            for bound, cnt in zip(h["buckets"], h["counts"]):
                cum += cnt
                lines.append(
                    f"{n}_bucket"
                    f"{_prom_labels(dict(labels, le=repr(float(bound))))} "
                    f"{cum}"
                )
            lines.append(
                f"{n}_bucket{_prom_labels(dict(labels, le='+Inf'))} "
                f"{h['count']}"
            )
            lines.append(f"{n}_sum{_prom_labels(labels)} {h['sum']}")
            lines.append(f"{n}_count{_prom_labels(labels)} {h['count']}")

    out: tp.List[str] = []
    for name in sorted(families):
        typ, lines = families[name]
        out.append(f"# TYPE {name} {typ}")
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")
