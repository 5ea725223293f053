"""The trainer's dispatch programs (``steps_per_dispatch``, the step
program and the window) against the JAX package's, on the CPU.

- ``window_plan`` and ``resolve_dispatch_intervals`` equal JAX's on a grid
  of (first step, max steps, K) and in their errors (messages equal);
- ``train()`` at K=4 (on the grid and off it) logs K=1's per-step loss,
  lr and grad norm bit for bit, reaches the same final val loss, and
  runs ``ceil(steps / K)`` dispatches; K=1 never touches the window
  cache; misaligned intervals raise before any data is read;
- the port's K=4 window (the step program over static buffers) against
  JAX's ``make_train_window`` on the same batches (f32, the trajectory
  tolerance of ``test_torch_train``);
- a K=4 run resumed mid-run from a K=1 or a K=4 checkpoint equals the
  uninterrupted K=1 run (JAX's ``test_train_k4_resume_mid_run_stays_
  bitexact``);
- ``PrefetchLoader``'s window mode against JAX's, batch for batch
  (stacking, a partial first and last window with the sentinel, the
  state replay mid-window);
- ``get_train_window`` is the same object under observability-only
  variants and another for K, the optimizer or the model;
- the step body holds nothing a CUDA graph cannot (no host read, no host
  data, no cross-device copy);
- the device-keyed dropout: the site-key table equals the host
  ``fold_in``/``split`` chain site by site; the residual mask is the
  counter hash (checked against Python integers), a function of its key
  alone, keeping within 0.01 of ``1 - rate``; its backward is the same
  mask; a key row on the device draws what its int key draws; remat
  "full" and "none" agree bit for bit through the program with dropout;
  the flash kernels' plain versions take a seed tensor as its int.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import midgpt_tpu_torch.train as tr
import midgpt_tpu_torch.train_programs as tp_
from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.config import resolve_dispatch_intervals as jax_resolve
from midgpt_tpu.data import Loader as JaxLoader
from midgpt_tpu.data import PrefetchLoader as JaxPrefetch
from midgpt_tpu.data import load_shard as jax_load_shard
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu.train import window_plan as jax_window_plan
from midgpt_tpu_torch.config import (
    ExperimentConfig,
    ModelConfig,
    get_config,
    resolve_dispatch_intervals,
    window_plan,
)
from midgpt_tpu_torch.convert import jax_params_from_gpt
from midgpt_tpu_torch.data import (
    Loader,
    PrefetchLoader,
    device_transform,
    load_shard,
    write_tokens,
)
from midgpt_tpu_torch.models.layers import (
    dropout,
    dropout_key_table,
    dropout_site_keys,
    fold_in,
    site_row,
    split,
)
from midgpt_tpu_torch.ops import dropout as kd
from midgpt_tpu_torch.ops import flash as tf
from midgpt_tpu_torch.train_programs import StepProgram, get_train_window
from midgpt_tpu_torch.utils.metrics import read_metrics

from torch_port_util import model_pair

torch.set_num_threads(2)

M32 = 0xFFFFFFFF


# -- window_plan and the interval resolver ------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_window_plan_equals_jax(k):
    for first in range(0, 13):
        for last in range(first, 19):
            plan = window_plan(first, last, k)
            assert plan == jax_window_plan(first, last, k)
            assert sum(plan) == last - first
    assert window_plan(0, 10, 4) == [4, 4, 2]
    assert window_plan(6, 16, 4) == [2, 4, 4]


def test_window_plan_refuses_k0():
    # JAX asserts; the port raises ValueError naming the length
    with pytest.raises(AssertionError):
        jax_window_plan(0, 4, 0)
    with pytest.raises(ValueError, match="got 0"):
        window_plan(0, 4, 0)


def _jax_base(**kw):
    return JaxExperimentConfig(
        model=JaxModelConfig(block_size=32, vocab_size=64, n_layer=2,
                             n_head=2, n_embd=64), **kw)


@pytest.mark.parametrize("intervals", [
    dict(eval_interval=8), dict(eval_interval=10), dict(eval_interval=2),
    dict(eval_interval=8, ckpt_interval=6), dict(eval_interval=8,
                                                  ckpt_interval=12),
    dict(eval_interval=3, ckpt_interval=3)],
    ids=["aligned", "eval10", "eval2", "ckpt6", "ckpt12", "both3"])
@pytest.mark.parametrize("k", [0, 1, 2, 4])
def test_resolve_dispatch_intervals_equals_jax(intervals, k):
    """The same verdict, the same object at K=1, the same message."""
    jcfg = _jax_base(steps_per_dispatch=k, **intervals)
    pcfg = get_config("tiny", steps_per_dispatch=k, **intervals)
    try:
        want = jax_resolve(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_dispatch_intervals(pcfg)
        assert str(got.value) == str(e)
        return
    assert resolve_dispatch_intervals(pcfg) is pcfg
    assert want is jcfg


def test_train_refuses_misaligned_intervals_before_reading_data(tmp_path):
    cfg = get_config("tiny", rundir=str(tmp_path / "run"),
                     data_dir=str(tmp_path / "missing"), device="cpu",
                     eval_interval=10, steps_per_dispatch=4)
    with pytest.raises(ValueError, match="eval_interval=10"):
        tr.train(cfg)
    assert not (tmp_path / "run").exists()


# -- train() at K=4 against K=1 ----------------------------------------------

def _data(tmp_path):
    data = tmp_path / "data"
    if not (data / "val.bin").exists():
        rng = np.random.default_rng(0)
        write_tokens(str(data / "train.bin"), np.tile(np.arange(64), 400))
        write_tokens(str(data / "val.bin"), rng.integers(0, 64, 5000))
    return str(data)


def _cfg(tmp_path, name, k, max_steps, dropout_rate=0.2, **kw):
    cfg = get_config(
        "tiny", rundir=str(tmp_path / name), data_dir=_data(tmp_path),
        device="cpu", compute_dtype="float32", eval_interval=8,
        eval_batches=1, log_interval=1, ckpt_interval=8,
        max_steps=max_steps, lr_decay_steps=12, steps_per_dispatch=k, **kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=dropout_rate))


def _logged(rundir):
    """{step: (loss/optimized, lr, grad_norm)} of every logged step."""
    return {r["step"]: (r["loss/optimized"], r["lr"], r["grad_norm"])
            for r in read_metrics(rundir) if "loss/optimized" in r}


@pytest.mark.parametrize("max_steps", [8, 10], ids=["on_grid", "off_grid"])
def test_train_k4_logs_k1_steps_bit_for_bit(tmp_path, monkeypatch,
                                            max_steps):
    def boom(*a, **kw):
        raise AssertionError("the window cache was called at K=1")

    monkeypatch.setattr(tr, "get_train_window", boom)
    monkeypatch.setattr(tp_, "get_train_window", boom)
    k1 = tr.train(_cfg(tmp_path, "k1", 1, max_steps))
    monkeypatch.undo()
    calls = []
    real = tr.get_train_window

    def counting(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(tr, "get_train_window", counting)
    k4 = tr.train(_cfg(tmp_path, "k4", 4, max_steps))
    assert set(calls) == {4}
    assert k1["train_dispatches"] == max_steps
    assert k4["train_dispatches"] == -(-max_steps // 4)
    l1, l4 = _logged(str(tmp_path / "k1")), _logged(str(tmp_path / "k4"))
    assert sorted(l1) == sorted(l4) == list(range(1, max_steps))
    assert l1 == l4
    assert k1["losses"] == k4["losses"] and len(k4["losses"]) == max_steps
    assert k1["val_loss"] == k4["val_loss"]
    # the window rule: the first window of a fresh run, then window ends
    # on the interval; the last step at the end
    ck = sorted(os.listdir(tmp_path / "k4" / "checkpoints"))
    assert ck == [f"step_{max_steps - 1:08d}.pt"]


@pytest.mark.parametrize("first_k", [1, 4], ids=["from_k1", "from_k4"])
def test_k4_resume_mid_run_equals_the_uninterrupted_run(tmp_path, first_k):
    full = tr.train(_cfg(tmp_path, "full", 1, 12))
    part = tr.train(_cfg(tmp_path, "cut", first_k, 6))
    assert part["train_dispatches"] == (6 if first_k == 1 else 2)
    rest = tr.train(_cfg(tmp_path, "cut", 4, 12))
    assert rest["first_step"] == 6
    # steps 6..11 in a short first window, then one on the grid
    assert rest["train_dispatches"] == 2
    assert part["losses"] + rest["losses"] == full["losses"]
    assert _logged(str(tmp_path / "cut")) == _logged(str(tmp_path / "full"))
    assert rest["val_loss"] == full["val_loss"]


def test_k4_window_telemetry_and_saves(tmp_path):
    """Window-granular lifecycle telemetry (JAX's window loop): one
    launch and one harvest a window with its k, steps counted by k; saves
    after the first window of a fresh run, at window ends on the interval
    and at the end."""
    final = tr.train(_cfg(tmp_path, "tele", 4, 10, train_telemetry=True,
                          ckpt_keep=10))
    with open(tmp_path / "tele" / "train_telemetry.json") as f:
        flight = json.load(f)
    counters = flight["metrics"]["counters"]
    assert counters["steps_completed"] == 10
    assert counters["windows_dispatched"] == final["train_dispatches"] == 3
    assert counters["ckpt_saves"] == 3
    events = flight["telemetry"]["events"]
    launch = [(e["step"], e["k"]) for e in events
              if e["kind"] == "window_launch"]
    harvest = [(e["step"], e["k"]) for e in events
               if e["kind"] == "window_harvest"]
    assert launch == [(0, 4), (4, 4), (8, 2)]
    assert harvest == [(3, 4), (7, 4), (9, 2)]
    assert sorted(os.listdir(tmp_path / "tele" / "checkpoints")) == [
        "step_00000003.pt", "step_00000007.pt", "step_00000009.pt"]


def test_k4_debug_profiles_the_second_window(tmp_path, monkeypatch):
    saves = []
    real = tr.Checkpointer.save

    def recording(self, step, *a, **kw):
        saves.append((step, self.async_save))
        return real(self, step, *a, **kw)

    monkeypatch.setattr(tr.Checkpointer, "save", recording)
    final = tr.train(_cfg(tmp_path, "debug", 4, 10, debug=True))
    assert saves == [(9, False)]  # no save in the loop; one, synchronous
    assert os.path.exists(tmp_path / "debug" / "profile" / "trace.json")
    assert final["train_dispatches"] == 3 and len(final["losses"]) == 10


# -- the window against JAX's make_train_window -------------------------------

TINY = dict(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64,
            attn_impl="naive", remat="none")
FLASH = dict(block_size=128, vocab_size=65, n_layer=2, n_head=2, n_embd=128,
             attn_impl="flash", remat="none")
TRAIN = dict(learning_rate=1e-3, min_lr=1e-4, warmup_steps=2,
             lr_decay_steps=10, beta2=0.99, weight_decay=1e-4,
             grad_clip=1.0, batch_size=8, g_accum_iters=2)


def _drive(prog, state, shadow, cfg, xs, ys, first_step, chunk=None):
    """One window of ``len(xs)`` steps through ``prog``: the loaded
    inputs, a run a step; ``[k, 3]`` (loss, grad norm, lr)."""
    k = len(xs)
    sched = tr.make_lr_schedule(cfg)
    prog.load(tr.step_scalars(cfg, sched, first_step, state.step, k),
              tr.step_keys(cfg, first_step, k), xs, ys)
    for _ in range(k):
        prog.run(lambda: tr.step_body(prog, state, shadow, cfg, chunk))
    state.step += k
    return prog.read(k)


@pytest.mark.parametrize("model_kw", [TINY, FLASH], ids=["tiny", "flash"])
def test_window_trajectory_matches_jax(pallas_interpret, model_kw):
    """Two K=4 windows: per-step losses within 1e-4 relative of JAX's
    window, the lr equal, and the parameters after 8 steps held as
    ``test_loss_trajectory_matches_jax`` holds them."""
    from midgpt_tpu.parallel.mesh import create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_window

    jcfg = JaxExperimentConfig(model=JaxModelConfig(**model_kw),
                               compute_dtype="float32",
                               mesh=MeshConfig(fsdp=1), **TRAIN)
    pcfg = ExperimentConfig(model=ModelConfig(**model_kw),
                            compute_dtype="float32", device="cpu", **TRAIN)
    jm, tm, _ = model_pair(model_kw, gain=1.0)
    mesh = create_mesh(jcfg.mesh, devices=jax.devices()[:1])
    tx, _ = make_optimizer(jcfg)
    window = make_train_window(jcfg, tx, mesh, 4)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    state = tr.state_from_model(tm)
    shadow = tr.make_shadow(tm, torch.float32)
    prog = StepProgram(pcfg, "cpu", 4)
    rng = np.random.default_rng(7)
    vocab, tt = model_kw["vocab_size"], model_kw["block_size"]
    for w in range(2):
        toks = rng.integers(0, vocab, (4, 2, 4, tt + 1)).astype(np.int32)
        x, y = toks[..., :-1], toks[..., 1:]
        jstate, jout = window(jstate, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(0))
        rows = _drive(prog, state, shadow, pcfg, torch.from_numpy(x).long(),
                      torch.from_numpy(y).long(), 4 * w)
        np.testing.assert_allclose(rows[:, 0], np.asarray(jout["loss"]),
                                   rtol=1e-4, err_msg=f"window {w}")
        np.testing.assert_allclose(rows[:, 2], np.asarray(jout["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(rows[:, 1], np.asarray(jout["grad_norm"]),
                                   rtol=1e-3)
    ref = dict(tree_paths(jstate.params))
    got = jax_params_from_gpt(state.model)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=2e-6, err_msg=k)


# -- the prefetch's window mode -----------------------------------------------

def _pair(tmp_path):
    path = str(tmp_path / "tokens.bin")
    if not os.path.exists(path):
        write_tokens(path, np.random.default_rng(3).integers(0, 50304,
                                                             20_000))
    return (Loader(load_shard(path), 16, (2,), seed=9),
            JaxLoader(jax_load_shard(path), 16, (2,), seed=9))


@pytest.mark.parametrize("plan", [None, [2, 3, 1], [1, 3, 3, 2]],
                         ids=["window3", "plan231", "plan1332"])
def test_prefetch_windows_equal_jax(tmp_path, plan):
    ours, ref = _pair(tmp_path)
    pre = PrefetchLoader(ours, *device_transform("cpu"), window=3,
                         window_plan=plan).start()
    jpre = JaxPrefetch(ref, window=3, window_plan=plan).start()
    sizes = plan or [3, 3]
    try:
        for w in sizes:
            x, y = pre.next()
            jx, jy = jpre.next()
            assert x.dtype == torch.int64 and tuple(x.shape) == (w, 2, 16)
            np.testing.assert_array_equal(x.numpy(), jx)
            np.testing.assert_array_equal(y.numpy(), jy)
        assert pre.state_dict() == jpre.state_dict()
        if plan is not None:
            for p in (pre, jpre):
                with pytest.raises(RuntimeError,
                                   match="window_plan exhausted"):
                    p.next()
    finally:
        pre.stop()
        jpre.stop()


def test_prefetch_window_state_replays_unconsumed_batches(tmp_path):
    ours, ref = _pair(tmp_path)
    pre = PrefetchLoader(ours, depth=3, window=2).start()
    try:
        first = [pre.next() for _ in range(2)]
        # let the worker queue more windows than were taken
        while pre._queue.qsize() < 3:
            pre._thread.join(timeout=0.01)
        state = pre.state_dict()
        assert state == {"step": 4, "seed": 9}
    finally:
        pre.stop()
    sync = Loader(ours.tokens, 16, (2,), seed=9)
    want = [sync.next() for _ in range(6)]
    for i in range(2):
        np.testing.assert_array_equal(first[i][0][1], want[2 * i + 1][0])
    again = PrefetchLoader(Loader(ours.tokens, 16, (2,), seed=9), window=2)
    again.load_state_dict(state)
    jagain = JaxPrefetch(ref, window=2)
    jagain.load_state_dict(state)
    try:
        x, _ = again.next()
        np.testing.assert_array_equal(x[0], want[4][0])
        np.testing.assert_array_equal(x[1], want[5][0])
        np.testing.assert_array_equal(x, jagain.next()[0])
    finally:
        again.stop()
        jagain.stop()


# -- the window cache ----------------------------------------------------------

@pytest.mark.parametrize("variant", [
    dict(rundir="/elsewhere", train_telemetry=True),
    dict(log_interval=7, max_steps=99, eval_interval=32),
    dict(seed=5, data_seed=77, debug=True, ckpt_keep=3, ckpt_interval=64),
    dict(device="cuda", data_dir="/data", eval_batches=9, eval_fixed=True)],
    ids=["telemetry", "cadence", "seeds", "paths"])
def test_window_cache_ignores_observability_knobs(variant):
    cfg = get_config("tiny", device="cpu")
    w1 = get_train_window(cfg, "cpu", 4)
    assert get_train_window(dataclasses.replace(cfg, **variant), "cpu",
                            4) is w1
    assert w1.depth == 4


@pytest.mark.parametrize("change", [
    dict(k=2), dict(learning_rate=5e-3), dict(model_n_layer=1),
    dict(model_remat="none"), dict(g_accum_iters=1)],
    ids=["k", "lr", "layers", "remat", "accumulation"])
def test_window_cache_separates_programs(change):
    cfg = get_config("tiny", device="cpu")
    w1 = get_train_window(cfg, "cpu", 4)
    change = dict(change)
    k = change.pop("k", 4)
    model = {n[len("model_"):]: v for n, v in change.items()
             if n.startswith("model_")}
    rest = {n: v for n, v in change.items() if not n.startswith("model_")}
    other = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model), **rest)
    assert get_train_window(other, "cpu", k) is not w1


# -- the step body holds nothing a graph cannot ---------------------------------

class _Refuse(TorchDispatchMode):
    """Refuses host reads of device values, host data and cross-device
    copies (what a CUDA graph cannot hold)."""

    REFUSED = {"aten::nonzero", "aten::_local_scalar_dense",
               "aten::is_nonzero", "aten::masked_select", "aten::_unique",
               "aten::_unique2", "aten::unique_dim", "aten::lift_fresh",
               "aten::lift_fresh_copy"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in self.REFUSED:
            raise AssertionError(f"{name} inside the step body")
        if name == "aten::copy_" and args[0].device != args[1].device:
            raise AssertionError(f"copy from {args[1].device}")
        return func(*args, **kwargs)


@pytest.mark.parametrize("model_kw", [
    dict(TINY, remat="full"), dict(FLASH, remat="dots", mlp="moe",
                                   moe_experts=4)],
    ids=["tiny_full", "flash_dots_moe"])
def test_step_body_needs_no_host(model_kw):
    cfg = ExperimentConfig(model=ModelConfig(**model_kw, dropout=0.2),
                           compute_dtype="float32", device="cpu",
                           loss_chunk=32, **TRAIN)
    state = tr.init_state(cfg, "cpu")
    shadow = tr.make_shadow(state.model, torch.float32)
    prog = StepProgram(cfg, "cpu", 2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, model_kw["vocab_size"], (2, 2, 4, model_kw["block_size"] + 1)))
    sched = tr.make_lr_schedule(cfg)
    prog.load(tr.step_scalars(cfg, sched, 0, 0, 2), tr.step_keys(cfg, 0, 2),
              toks[..., :-1], toks[..., 1:])
    # the first step is the program's warm-up (it builds the rope tables);
    # the second is what a capture records
    tr.step_body(prog, state, shadow, cfg, 32)
    with _Refuse():
        tr.step_body(prog, state, shadow, cfg, 32)
    assert prog.idx.item() == 2
    assert np.isfinite(prog.read(2)).all()


# -- the device-keyed dropout ---------------------------------------------------

@pytest.mark.parametrize("step_key", [0, 12345, fold_in(7, 3), (1 << 63) - 1])
def test_key_table_follows_the_host_chain(step_key):
    g, nl = 3, 4
    table = dropout_key_table(step_key, g, nl)
    layout = site_row(nl)
    assert table.shape == (g, layout["size"]) and table.dtype == np.int64
    for i, mb in enumerate(split(step_key, g)):
        embed, blocks = split(mb, 2)
        assert table[i, layout["embed"]] == embed
        for layer, bkey in enumerate(split(blocks, nl)):
            attn, mlp = split(bkey, 2)
            probs, out = split(attn, 2)
            row = table[i, layout["layers"][layer]].tolist()
            # the flash kernels read the probabilities' key's low 32 bits,
            # the seed they took by value before
            assert row == [probs, out, mlp]
    assert table[0].tolist() == dropout_site_keys(split(step_key, g)[0], nl)


def test_step_keys_and_scalars_reach_the_program_rows():
    cfg = get_config("tiny", device="cpu", g_accum_iters=2, batch_size=4)
    cfg = dataclasses.replace(cfg, seed=11, model=dataclasses.replace(
        cfg.model, dropout=0.1))
    keys = tr.step_keys(cfg, 5, 3)
    for i in range(3):
        np.testing.assert_array_equal(
            keys[i], dropout_key_table(fold_in(11, 5 + i), 2, 2))
    sched = tr.make_lr_schedule(cfg)
    sc = tr.step_scalars(cfg, sched, 5, 9, 3)
    assert sc.dtype == np.float32 and sc[:, 0].tolist() == [
        sched(5), sched(6), sched(7)]
    assert sc[1, 1:].tolist() == list(tr.bias_corrections(cfg, 11))
    prog = StepProgram(cfg, "cpu", 4)
    xs = torch.zeros(3, 2, 2, 64, dtype=torch.long)
    prog.load(sc, keys, xs, xs, start=1)
    assert prog.idx.tolist() == [1]
    np.testing.assert_array_equal(prog.keys[:3].numpy(), keys)
    np.testing.assert_array_equal(prog.scalars[:3].numpy(), sc)


def _hash_py(key: int, i: int) -> int:
    """The residual mask's hash in Python integers."""
    s = ((key & M32) + (key >> 32 & M32) * 0xC2B2AE35) & M32
    x = ((i * 0x9E3779B1) & M32) ^ s
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return (x ^ (x >> 16)) & 0x00FFFFFF


@pytest.mark.parametrize("key", [1, fold_in(0, 11), (1 << 63) - 1,
                                 0x123456789ABCDEF])
def test_residual_mask_is_the_counter_hash(key):
    keep = 0.8
    got = kd.keep_mask_reference(torch.tensor(key), 3000, keep)
    idx = list(range(1000)) + list(range(2000, 3000))
    want = [_hash_py(key, i) < int(keep * (1 << 24)) for i in idx]
    assert got[idx].tolist() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_dropout_is_a_function_of_its_key(dtype):
    x = torch.randn(64, 40, 50, generator=torch.Generator().manual_seed(0))
    x = x.to(dtype)
    a = torch.tensor(fold_in(3, 1))
    out = dropout(x, 0.2, a)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    assert torch.equal(out[kept], (x * (1 / 0.8))[kept])
    assert torch.equal(out, dropout(x, 0.2, torch.tensor(fold_in(3, 1))))
    assert torch.equal(out, dropout(x, 0.2, fold_in(3, 1)))  # an int key
    other = dropout(x, 0.2, torch.tensor(fold_in(3, 2))) != 0
    assert (other != kept).float().mean().item() > 0.2
    # the backward redraws the mask: dx = mask * dy / keep
    xg = x.float().requires_grad_()
    dy = torch.randn(xg.shape, generator=torch.Generator().manual_seed(1))
    kd.dropout(xg, a, 0.2).backward(dy)
    assert torch.equal(xg.grad, torch.where(kept, dy * (1 / 0.8), 0.0))


def test_a_device_key_row_draws_what_its_int_key_draws():
    cfg = ModelConfig(block_size=64, vocab_size=65, n_layer=2, n_head=2,
                      n_embd=64, dropout=0.2, attn_impl="flash",
                      remat="none")
    model = tr.init_state(ExperimentConfig(model=cfg, device="cpu"),
                          "cpu").model
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 65,
                                                              (2, 64)))
    key = fold_in(0, 9)
    row = torch.tensor(dropout_site_keys(key, 2))
    with torch.no_grad():
        a = model(toks, key=key, deterministic=False)
        b = model(toks, key=row, deterministic=False)
        c = model(toks, key=fold_in(0, 10), deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="site keys"):
        model(toks, key=row[:3], deterministic=False)


@pytest.fixture
def deterministic():
    """Deterministic algorithms (the CPU's embedding backward sums in a
    thread-dependent order otherwise)."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_program_remat_full_equals_none_with_dropout(deterministic, impl):
    outs, params = {}, {}
    for remat in ("none", "full"):
        kw = dict(FLASH if impl == "flash" else TINY, remat=remat)
        cfg = ExperimentConfig(model=ModelConfig(**kw, dropout=0.2),
                               compute_dtype="float32", device="cpu",
                               seed=4, **TRAIN)
        state = tr.init_state(cfg, "cpu")
        shadow = tr.make_shadow(state.model, torch.float32)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, kw["vocab_size"], (3, 2, 4, kw["block_size"] + 1)))
        prog = StepProgram(cfg, "cpu", 3)
        outs[remat] = _drive(prog, state, shadow, cfg, toks[..., :-1],
                             toks[..., 1:], 0)
        params[remat] = [p.detach().clone() for p in state.model.parameters()]
    np.testing.assert_array_equal(outs["full"], outs["none"])
    for a, b in zip(params["full"], params["none"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [5, -12345, (1 << 40) + 7])
def test_flash_plain_takes_a_seed_tensor(seed):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 64, 64)))
               .float().requires_grad_() for _ in range(3))
    out_i = tf.flash_attention_dropout(q, k, v, seed, 0.2)
    for dtype in (torch.int64, torch.int32):
        st = torch.tensor(seed & M32, dtype=torch.int64).to(dtype)
        out_t = tf.flash_attention_dropout(q, k, v, st, 0.2)
        assert torch.equal(out_i, out_t)
    assert torch.equal(tf.dropout_mask_reference(seed, 1, 2, 64, 0.2),
                       tf.dropout_mask_reference(torch.tensor(seed), 1, 2,
                                                 64, 0.2))
    with pytest.raises(ValueError, match="one int32/int64"):
        tf.seed_tensor(torch.tensor([1, 2]), "cpu")
