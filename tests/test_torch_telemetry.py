"""The port's telemetry against the JAX package's, fed the same series.

- ``AnomalyMonitors``: a loss series with a spike and a NaN, a grad-norm
  spike and a throughput drop trip the same monitors at the same steps
  in both packages, with the same details and the same flight-dump
  files and keys;
- ``TrainTelemetry``: the same events and spans give the same counters,
  histograms, ``prometheus_text``, Chrome trace and flight dump;
- the registry and ``prometheus_text`` on a labelled and a cluster-shaped
  snapshot, and ``percentile``;
- ``train()`` end to end on the CPU (f32): the losses are the same with
  ``train_telemetry`` on and off, and the timeline and telemetry files
  are written; ``debug`` runs one eval batch, saves nothing in the loop
  and writes a profile.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from midgpt_tpu import telemetry as jax_tele
from midgpt_tpu import train_telemetry as jax_train_tele
from midgpt_tpu_torch import telemetry as tele
from midgpt_tpu_torch import train_telemetry as train_tele

torch.set_num_threads(2)


def _series():
    """(step, loss, grad_norm, tokens/s): a falling loss with a spike at
    step 30 and a NaN at 45, a grad-norm spike at 38, a throughput drop
    at 50."""
    rng = np.random.default_rng(0)
    out = []
    for s in range(1, 61):
        loss = 6.0 * math.exp(-s / 40) + 0.01 * rng.standard_normal()
        gn = 1.0 + 0.05 * rng.standard_normal()
        tps = 1e5 * (1 + 0.02 * rng.standard_normal())
        if s == 30:
            loss *= 10
        if s == 45:
            loss = float("nan")
        if s == 38:
            gn = 40.0
        if s == 50:
            tps = 2e4
        out.append((s, loss, gn, tps))
    return out


def _feed(mod, flight_dir):
    t = mod.TrainTelemetry()
    mon = mod.AnomalyMonitors(telemetry=t, flight_dir=flight_dir)
    t.emit("run_start", step=0, t=0.0)
    for s, loss, gn, tps in _series():
        clock = float(s)
        t.prefetch_wait(step=s, t=clock, dur=0.001 if s % 7 else 0.2)
        t.emit("window_launch", step=s, t=clock + 0.2, k=1)
        t.metrics.counter("windows_dispatched").inc()
        t.metrics.counter("steps_completed").inc()
        t.emit("window_harvest", step=s, t=clock + 0.5, k=1)
        t.span("train_window", step=s, t=clock + 0.2, dur=0.3, k=1)
        mon.observe_step(s, loss, gn, t=clock + 0.5)
        mon.observe_throughput(s, tps, t=clock + 0.5)
        if s % 20 == 0:
            t.span("eval_pause", step=s, t=clock + 0.6, dur=0.05, batches=2)
            t.metrics.counter("evals").inc()
            t.span("ckpt_wait", step=s, t=clock + 0.7, dur=0.01)
            t.span("ckpt_save", step=s, t=clock + 0.71, dur=0.02)
            t.metrics.counter("ckpt_saves").inc()
    t.emit("interrupt", step=60, t=61.0)
    t.emit("run_end", step=61, t=62.0)
    return t, mon


def test_monitors_and_telemetry_match_jax(tmp_path):
    ours, mon = _feed(train_tele, str(tmp_path / "port"))
    ref, jmon = _feed(jax_train_tele, str(tmp_path / "jax"))
    assert [(tr["kind"], tr["step"]) for tr in mon.trips] == [
        (tr["kind"], tr["step"]) for tr in jmon.trips]
    kinds = {tr["kind"] for tr in mon.trips}
    assert {"loss_spike", "nan", "grad_norm_spike",
            "throughput_drop"} <= kinds
    for a, b in zip(mon.trips, jmon.trips):
        assert a["detail"] == pytest.approx(b["detail"], nan_ok=True)
    assert ([os.path.basename(p) for p in mon.dump_paths]
            == [os.path.basename(p) for p in jmon.dump_paths])
    for a, b in zip(mon.dump_paths, jmon.dump_paths):
        with open(a) as fa, open(b) as fb:
            da, db = json.load(fa), json.load(fb)
        assert da.keys() == db.keys()
        assert da["history"] == db["history"]
    assert ours.metrics_snapshot() == ref.metrics_snapshot()
    assert (tele.prometheus_text(ours.metrics_snapshot())
            == jax_tele.prometheus_text(ref.metrics_snapshot()))
    assert (train_tele.chrome_trace_train(ours)
            == jax_train_tele.chrome_trace_train(ref))
    assert ours.sequence_signature() == ref.sequence_signature()
    dump = ours.flight_dump("run_end", path=str(tmp_path / "p.json"))
    jdump = ref.flight_dump("run_end", path=str(tmp_path / "j.json"))
    assert dump.keys() == jdump.keys()
    assert dump["metrics"] == jdump["metrics"]
    assert dump["telemetry"] == jdump["telemetry"]
    assert train_tele.TRAIN_COUNTERS == jax_train_tele.TRAIN_COUNTERS
    assert train_tele.TRAIN_EVENT_KINDS == jax_train_tele.TRAIN_EVENT_KINDS
    assert train_tele.TRAIN_SPAN_KINDS == jax_train_tele.TRAIN_SPAN_KINDS


def test_registry_and_prometheus_text_match_jax():
    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("steps").inc(3)
        reg.gauge("depth", lambda: 2.5)
        reg.attach_labels("rejects", {"full": 2, "deadline": 1})
        h = reg.histogram("wait_s")
        for v in (0.0005, 0.003, 0.2, 20.0):
            h.observe(v)
        return reg.snapshot()

    ours, ref = fill(tele), fill(jax_tele)
    assert ours == ref
    assert tele.prometheus_text(ours) == jax_tele.prometheus_text(ref)
    pairs = [({"replica": "0"}, ours), ({"replica": "1"}, ours)]
    assert tele.prometheus_text(pairs) == jax_tele.prometheus_text(pairs)
    cluster = {"cluster": {"replicas": 2, "ok": True},
               "replicas": [ours, ours]}
    assert tele.prometheus_text(cluster) == jax_tele.prometheus_text(cluster)
    with pytest.raises(ValueError, match="snapshot"):
        tele.prometheus_text({"nothing": 1})
    vals = sorted([3.0, 1.0, 2.0, 5.0])
    for q in (0.0, 0.5, 0.99):
        assert tele.percentile(vals, q) == jax_tele.percentile(vals, q)
    assert tele.percentile([], 0.5) is None


def _data(tmp_path):
    from midgpt_tpu_torch.data import write_tokens

    data = tmp_path / "data"
    if not (data / "val.bin").exists():
        rng = np.random.default_rng(0)
        write_tokens(str(data / "train.bin"), np.tile(np.arange(64), 400))
        write_tokens(str(data / "val.bin"), rng.integers(0, 64, 5000))
    return str(data)


def _cfg(tmp_path, name, **kw):
    from midgpt_tpu_torch.config import get_config

    return get_config(
        "tiny", rundir=str(tmp_path / name), data_dir=_data(tmp_path),
        device="cpu", eval_interval=3, eval_batches=2, log_interval=1,
        ckpt_interval=2, max_steps=5, compute_dtype="float32", **kw)


def test_train_telemetry_is_loop_side_only(tmp_path):
    from midgpt_tpu_torch.train import train

    off = train(_cfg(tmp_path, "off"))
    on = train(_cfg(tmp_path, "on", train_telemetry=True))
    assert on["losses"] == off["losses"]
    run = tmp_path / "on"
    assert not (tmp_path / "off" / "train_timeline.json").exists()
    with open(run / "train_timeline.json") as f:
        trace = json.load(f)
    with open(run / "train_telemetry.json") as f:
        flight = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"prefetch_wait", "train_window", "eval_pause", "ckpt_save",
            "ckpt_wait", "run_start", "run_end"} <= names
    counters = flight["metrics"]["counters"]
    assert counters["steps_completed"] == counters["windows_dispatched"] == 5
    assert counters["prefetch_waits"] == 5
    assert counters["evals"] == 2  # steps 0 and 3
    assert counters["ckpt_saves"] == 3  # steps 0, 2 and the last, 4
    kinds = [e["kind"] for e in flight["telemetry"]["events"]]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    # the throughput monitor reads the host's clock: whatever it tripped
    # is counted once in the result and once in the event ring
    assert on["anomalies"] == kinds.count("anomaly")
    assert counters["anomalies_tripped"] == on["anomalies"]
    assert kinds.count("window_launch") == 5
    # logging steps 1..4 harvest (step 0 logs nothing, as in JAX)
    assert kinds.count("window_harvest") == 4


def test_debug_mode(tmp_path, monkeypatch):
    import midgpt_tpu_torch.train as tr

    batches = []
    real_eval = tr.evaluate

    def counting(shadow, loader, n_batches, *a, **kw):
        batches.append(n_batches)
        return real_eval(shadow, loader, n_batches, *a, **kw)

    monkeypatch.setattr(tr, "evaluate", counting)
    saves = []
    real_save = tr.Checkpointer.save

    def recording(self, step, *a, **kw):
        saves.append((step, self.async_save))
        return real_save(self, step, *a, **kw)

    monkeypatch.setattr(tr.Checkpointer, "save", recording)
    final = tr.train(_cfg(tmp_path, "debug", debug=True, ckpt_keep=10))
    assert set(batches) == {1}  # one eval batch at every eval
    assert saves == [(4, False)]  # no save in the loop; one, synchronous
    run = tmp_path / "debug"
    assert os.listdir(run / "checkpoints") == ["step_00000004.pt"]
    assert os.path.exists(run / "profile" / "trace.json")
    assert len(final["losses"]) == 5
