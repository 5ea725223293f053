"""Training-loop telemetry (counterpart of ``midgpt_tpu.train_telemetry``):
lifecycle tracing, prefetch-starvation accounting, and deterministic
step-keyed anomaly monitors, on the shared substrate
(:mod:`midgpt_tpu_torch.telemetry`).

1. **Lifecycle tracing** (:class:`TrainTelemetry`,
   ``ExperimentConfig(train_telemetry=True)``): typed events keyed to the
   optimizer step (``window_launch`` / ``window_harvest`` around each
   step, ``prefetch_wait`` spans with a starvation counter when the loop
   blocked on the loader, ``eval_pause``, ``ckpt_save`` / ``ckpt_wait``,
   ``resume``, ``interrupt``), with wall clock stamped only at host reads
   the loop already performs. Tracing is loop-side only: the step is the
   same call either way, so the losses are the same with it on or off.

2. **Timeline export**: :func:`chrome_trace_train` renders the loop as
   Perfetto-loadable lanes (prefetch / train step / eval / checkpoint
   spans, and anomaly and starvation instants).

3. **Anomaly monitors** (:class:`AnomalyMonitors`, always on; they only
   read scalars the logging path already brought to the host): a NaN
   sentinel, EWMA loss-spike and grad-norm-spike detectors, and a
   throughput-drop detector. The loss, grad and NaN monitors are a pure
   function of the (step, value) series, so a replayed run trips at the
   same step; the throughput monitor reads a wall-clock rate. A trip
   dumps a flight record (recent values and the telemetry rings) into the
   rundir.

The event kinds, counters, thresholds and defaults are the JAX
package's, so both loops' records read alike.
"""

from __future__ import annotations

import math
import os
import typing as tp

from midgpt_tpu_torch.telemetry import (
    MetricsRegistry,
    TelemetryLog,
    write_json,
)

__all__ = [
    "AnomalyMonitors",
    "TRAIN_EVENT_KINDS",
    "TRAIN_SPAN_KINDS",
    "TrainTelemetry",
    "chrome_trace_train",
]


#: Point events (``TrainTelemetry.emit``). ``window_launch`` fires when
#: a fused dispatch is enqueued (host-side clock read, no sync);
#: ``window_harvest`` fires at the logging window's existing
#: device->host read; ``prefetch_starved`` marks a prefetch wait above
#: the starvation threshold; ``anomaly`` is a monitor trip.
TRAIN_EVENT_KINDS: tp.Tuple[str, ...] = (
    "run_start",
    "resume",
    "window_launch",
    "window_harvest",
    "prefetch_starved",
    "anomaly",
    "interrupt",
    "run_end",
    # a benchmark's rung ladder (the JAX package's bench.py records its
    # rungs here: a wedged round dumps the rung it died in)
    "rung_start",
    "rung_ok",
    "rung_error",
)

#: Span records (``TrainTelemetry.span`` -> the dispatch ring).
TRAIN_SPAN_KINDS: tp.Tuple[str, ...] = (
    "prefetch_wait",
    "train_window",
    "eval_pause",
    "ckpt_save",
    "ckpt_wait",
)

#: Registry counters every TrainTelemetry carries (the train analogue of
#: the engine's ``_ENGINE_COUNTERS`` — pinned by test so the Prometheus
#: exporter and the ledger can rely on the inventory).
TRAIN_COUNTERS: tp.Tuple[str, ...] = (
    "windows_dispatched",
    "steps_completed",
    "prefetch_waits",
    "prefetch_starved",
    "evals",
    "ckpt_saves",
    "anomalies_tripped",
)


class TrainTelemetry(TelemetryLog):
    """Event log + metrics registry for one training run.

    ``step`` on every event/span is the absolute optimizer step (the
    port runs one step a launch window, K = 1), fully deterministic. ``starvation_s`` sets the prefetch-wait
    threshold above which the loop counts itself loader-starved (the
    queue get is a host block either way; the threshold only
    classifies it)."""

    event_kinds = TRAIN_EVENT_KINDS

    def __init__(self, *, starvation_s: float = 0.05, **kw):
        super().__init__(**kw)
        self.starvation_s = starvation_s
        self.metrics = MetricsRegistry()
        for name in TRAIN_COUNTERS:
            self.metrics.counter(name)
        self.metrics.histogram("prefetch_wait_s")
        self.metrics.histogram("train_window_s")
        self.metrics.histogram("eval_pause_s")
        self.metrics.histogram("ckpt_save_s")

    # -- recording ---------------------------------------------------------

    def span(
        self, kind: str, *, step: int, t: float, dur: float, **data
    ) -> None:
        """One timed loop phase onto the dispatch ring (+ its latency
        histogram). ``data`` must stay deterministic — wall clock rides
        only in ``t``/``dur``."""
        assert kind in TRAIN_SPAN_KINDS, kind
        self.record_dispatch(
            kind, step=step, t=t, dur=dur, rids=(), tokens=0, **data
        )
        h = self.metrics.histograms.get(f"{kind}_s")
        if h is not None:
            h.observe(dur)

    def prefetch_wait(self, *, step: int, t: float, dur: float) -> None:
        """The loop blocked ``dur`` seconds on ``prefetch.next()``.
        Above ``starvation_s`` the wait counts as loader starvation —
        the input pipeline, not the device, owned the critical path."""
        self.metrics.counter("prefetch_waits").inc()
        self.span("prefetch_wait", step=step, t=t, dur=dur)
        if dur > self.starvation_s:
            self.metrics.counter("prefetch_starved").inc()
            self.emit("prefetch_starved", step=step, t=t + dur)

    def metrics_snapshot(self) -> tp.Dict[str, tp.Any]:
        """The registry view (counters + histograms), which
        :func:`midgpt_tpu_torch.telemetry.prometheus_text` exports
        directly."""
        return self.metrics.snapshot()

    def flight_dump(
        self,
        reason: str,
        path: tp.Optional[str] = None,
        extra: tp.Optional[tp.Dict[str, tp.Any]] = None,
    ) -> tp.Dict[str, tp.Any]:
        """The flight-recorder artifact: metrics snapshot + the bounded
        event/span rings, as one JSON-able record (written to ``path``
        when given). Reads host-side state only — safe best-effort from
        a watchdog thread, like the serving twin."""
        rec: tp.Dict[str, tp.Any] = {
            "reason": reason,
            "metrics": self.metrics_snapshot(),
            "telemetry": self.flight_payload(),
        }
        if extra:
            rec.update(extra)
        if path is not None:
            rec["path"] = os.path.abspath(path)
            write_json(path, rec)
        return rec


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

_TRAIN_PID = 1
_TRAIN_LANES = {
    "prefetch_wait": 0,
    "train_window": 1,
    "eval_pause": 2,
    "ckpt_save": 3,
    "ckpt_wait": 4,
}
_TRAIN_INSTANTS = (
    "run_start", "resume", "prefetch_starved", "anomaly", "interrupt",
    "run_end",
)


def chrome_trace_train(tele: TrainTelemetry) -> tp.Dict[str, tp.Any]:
    """Export a training telemetry log as a Chrome trace-event JSON
    object: one process with a lane per loop phase (spans from the
    dispatch ring) plus an events lane (anomalies, starvation, resume
    markers as instants). Timestamps are microseconds relative to the
    earliest recorded event."""
    all_ts = [d.t for d in tele.dispatches] + [ev.t for ev in tele.events]
    base = min(all_ts) if all_ts else 0.0
    events: tp.List[tp.Dict[str, tp.Any]] = [{
        "ph": "M", "pid": _TRAIN_PID, "name": "process_name",
        "args": {"name": "train-loop"},
    }]
    for kind, tid in _TRAIN_LANES.items():
        events.append({
            "ph": "M", "pid": _TRAIN_PID, "tid": tid,
            "name": "thread_name", "args": {"name": kind},
        })
    ev_lane = len(_TRAIN_LANES)
    events.append({
        "ph": "M", "pid": _TRAIN_PID, "tid": ev_lane,
        "name": "thread_name", "args": {"name": "events"},
    })
    for d in tele.dispatches:
        events.append({
            "name": d.kind,
            "ph": "X",
            "pid": _TRAIN_PID,
            "tid": _TRAIN_LANES.get(d.kind, ev_lane),
            "ts": (d.t - base) * 1e6,
            "dur": max(0.0, d.dur) * 1e6,
            "args": dict(d.data, step=d.step),
        })
    for ev in tele.events:
        if ev.kind not in _TRAIN_INSTANTS:
            continue
        events.append({
            "name": ev.kind,
            "ph": "i",
            "s": "p",
            "pid": _TRAIN_PID,
            "tid": ev_lane,
            "ts": (ev.t - base) * 1e6,
            "args": dict(ev.data, step=ev.step),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Anomaly monitors
# ---------------------------------------------------------------------------


class _EwmaSpike:
    """Deterministic EWMA mean/variance spike detector: trips when an
    observation exceeds the running mean by ``z`` standard deviations
    (with a relative floor so a flat series doesn't trip on noise).
    Statistics update AFTER the check, so a spike cannot absorb
    itself."""

    def __init__(
        self, *, alpha: float = 0.05, z: float = 8.0, warmup: int = 20,
        rel_floor: float = 0.25,
    ):
        self.alpha = alpha
        self.z = z
        self.warmup = warmup
        self.rel_floor = rel_floor
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, x: float) -> tp.Optional[tp.Dict[str, float]]:
        if self.n == 0:
            # seed from the first observation: starting the mean at 0
            # would make the whole warmup period one giant "spike" that
            # inflates the variance estimate for hundreds of steps
            self.mean = x
            self.n = 1
            return None
        trip = None
        if self.n >= self.warmup:
            threshold = self.mean + max(
                self.z * math.sqrt(max(self.var, 0.0)),
                self.rel_floor * abs(self.mean),
            )
            if x > threshold:
                trip = {"value": x, "threshold": threshold,
                        "ewma": self.mean}
        delta = x - self.mean
        self.mean += self.alpha * delta
        self.var = (1.0 - self.alpha) * (
            self.var + self.alpha * delta * delta
        )
        self.n += 1
        return trip


class AnomalyMonitors:
    """Step-keyed training-health monitors with flight-record dumps.

    ``observe_step(step, loss, grad_norm)`` runs the deterministic
    monitors (NaN sentinel first — a non-finite value trips regardless
    of warmup — then the EWMA loss and grad-norm spike detectors);
    ``observe_throughput(step, tokens_per_sec)`` runs the wall-informed
    throughput-drop detector (trips when the rate falls below
    ``tps_drop_frac`` of its EWMA). Every trip increments the attached
    telemetry's ``anomalies_tripped`` counter, emits an ``anomaly``
    event, and (up to ``max_dumps`` times) writes a flight record to
    ``flight_dir`` carrying the recent value history and the telemetry
    rings — so a diverging or wedging run leaves a timeline, not just a
    broken loss curve. Trips never raise: the monitors observe, the
    operator decides. With a ``rank`` (a mesh's ranks, each with its own
    monitors) a dump's name ends in ``_rank<r>``.
    """

    def __init__(
        self,
        *,
        telemetry: tp.Optional[TrainTelemetry] = None,
        flight_dir: tp.Optional[str] = None,
        loss_z: float = 8.0,
        grad_z: float = 10.0,
        warmup: int = 20,
        tps_drop_frac: float = 0.5,
        tps_warmup: int = 3,
        max_dumps: int = 4,
        history: int = 256,
        rank: tp.Optional[int] = None,
    ):
        self.telemetry = telemetry
        self.flight_dir = flight_dir
        self.rank = rank
        self._loss = _EwmaSpike(z=loss_z, warmup=warmup)
        self._grad = _EwmaSpike(z=grad_z, warmup=warmup)
        self._tps_ewma = 0.0
        self._tps_n = 0
        self._tps_drop_frac = tps_drop_frac
        self._tps_warmup = tps_warmup
        self.max_dumps = max_dumps
        self.trips: tp.List[tp.Dict[str, tp.Any]] = []
        self.dump_paths: tp.List[str] = []
        import collections

        self._history: tp.Deque[tp.Tuple[int, float, float]] = (
            collections.deque(maxlen=history)
        )

    # -- observation -------------------------------------------------------

    def observe_step(
        self, step: int, loss: float,
        grad_norm: tp.Optional[float] = None, *, t: float = 0.0,
    ) -> tp.List[tp.Dict[str, tp.Any]]:
        """Feed one optimizer step's host-read scalars; returns the
        trips (possibly empty). Deterministic: same (step, loss,
        grad_norm) series -> same trips at the same steps.
        ``grad_norm=None`` (the K=1 loop, which logs no grad norm)
        skips the grad-norm detectors."""
        gn = float(grad_norm) if grad_norm is not None else 0.0
        self._history.append((step, float(loss), gn))
        out = []
        if not math.isfinite(loss) or (
            grad_norm is not None and not math.isfinite(grad_norm)
        ):
            out.append(self._trip(
                "nan", step, t=t,
                detail={"loss": float(loss), "grad_norm": gn},
            ))
            return out  # non-finite values must not poison the EWMAs
        d = self._loss.observe(float(loss))
        if d is not None:
            out.append(self._trip("loss_spike", step, t=t, detail=d))
        if grad_norm is not None:
            d = self._grad.observe(float(grad_norm))
            if d is not None:
                out.append(
                    self._trip("grad_norm_spike", step, t=t, detail=d)
                )
        return out

    def observe_throughput(
        self, step: int, tokens_per_sec: float, *, t: float = 0.0
    ) -> tp.List[tp.Dict[str, tp.Any]]:
        """Feed one logging window's host-clocked rate. Wall-informed by
        construction (it catches a run that silently slows down)."""
        out = []
        if self._tps_n >= self._tps_warmup and tokens_per_sec < (
            self._tps_drop_frac * self._tps_ewma
        ):
            out.append(self._trip(
                "throughput_drop", step, t=t,
                detail={"tokens_per_sec": tokens_per_sec,
                        "ewma": self._tps_ewma},
            ))
        alpha = 0.3
        self._tps_ewma = (
            tokens_per_sec if self._tps_n == 0
            else (1 - alpha) * self._tps_ewma + alpha * tokens_per_sec
        )
        self._tps_n += 1
        return out

    # -- trip handling -----------------------------------------------------

    def _trip(
        self, kind: str, step: int, *, t: float,
        detail: tp.Dict[str, float],
    ) -> tp.Dict[str, tp.Any]:
        trip = {"kind": kind, "step": step, "detail": detail}
        self.trips.append(trip)
        tele = self.telemetry
        if tele is not None:
            tele.metrics.counter("anomalies_tripped").inc()
            # detail values are step-keyed scalars (the throughput rate
            # being the documented wall-informed exception), so they may
            # ride the deterministic data fields
            tele.emit("anomaly", step=step, t=t, kind_detail=kind)
        if self.flight_dir is not None and len(
            self.dump_paths
        ) < self.max_dumps:
            suffix = "" if self.rank is None else f"_rank{self.rank}"
            path = os.path.join(
                self.flight_dir, f"anomaly_{kind}_step{step}{suffix}.json"
            )
            payload = {
                "reason": f"anomaly:{kind}",
                "step": step,
                "detail": detail,
                "history": [
                    {"step": s, "loss": lo, "grad_norm": gn}
                    for s, lo, gn in list(self._history)
                ],
                "telemetry": (
                    tele.flight_payload() if tele is not None else None
                ),
            }
            try:
                trip["flight_dump"] = write_json(path, payload)
                self.dump_paths.append(trip["flight_dump"])
            except OSError:  # a dump must never kill the training loop
                pass
        return trip
