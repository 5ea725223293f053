"""The port's training slice against the JAX package's, on the same
NumPy inputs (f32 compute on the CPU).

- the lr schedule at every step from 0 to ``lr_decay_steps + 5``;
- optimizer updates against ``make_optimizer``'s optax chain, with the
  gradient norm above ``grad_clip``;
- ``Loader`` batches bit for bit;
- ``chunked_softmax_xent`` and its gradients;
- 5-step loss trajectories with ``g_accum_iters=2`` from a converted
  init, on ``tiny`` (naive attention), on a fused-eligible config
  (T=128, 2 heads of 64, 2 layers, ``attn_impl="fused"``) and on a
  shakespeare-shaped flash config (the same with vocab 65 and
  ``attn_impl="flash"``), and on the fused config at T=256 with
  ``norm_impl="fused"`` and the attention backward on the split route,
  JAX's Pallas kernels in interpret mode, the port's plain versions; and
  the parameters after the last step;
- a checkpoint resume (save at step 2, resume, run to step 4) giving the
  uninterrupted run's losses exactly;
- dropout 0.2 on the CPU (JAX's random streams cannot be matched, so
  these are the port's own contracts): remat "full" and "none" give the
  same losses and gradients bit for bit, on the naive and the flash
  path, and so does remat "dots"; the same key gives the same loss and
  another key another; a resume from a step-2 checkpoint reproduces the
  uninterrupted losses;
  evals are deterministic; the residual keep fraction is within 0.01 of
  0.8, its mask a function of the site's key.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig, get_config
from midgpt_tpu_torch.convert import gpt_from_jax_params, jax_params_from_gpt
from midgpt_tpu_torch.data import Loader, load_shard, write_tokens
from midgpt_tpu_torch.models.layers import dropout, fold_in
from midgpt_tpu_torch.ops.loss import chunked_softmax_xent
from midgpt_tpu_torch.train import (
    init_state,
    loss_fn,
    make_lr_schedule,
    make_shadow,
    optimizer_update,
    state_from_model,
    train,
    train_step,
)

from torch_port_util import model_pair, t

torch.set_num_threads(2)

TRAIN = dict(learning_rate=1e-3, min_lr=1e-4, warmup_steps=2,
             lr_decay_steps=10, beta2=0.99, weight_decay=1e-4,
             grad_clip=1.0)


def _configs(model_kw, **kw):
    """The same experiment in both packages, f32 compute."""
    kw = {**TRAIN, **kw}
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(**model_kw), compute_dtype="float32",
        mesh=MeshConfig(fsdp=1), **kw)
    pcfg = ExperimentConfig(model=ModelConfig(**model_kw),
                            compute_dtype="float32", device="cpu", **kw)
    return jcfg, pcfg


def test_lr_schedule_matches_optax():
    from midgpt_tpu.train import make_lr_schedule as jax_schedule

    for kw in (dict(learning_rate=1e-3, min_lr=1e-5, warmup_steps=10,
                    lr_decay_steps=100),
               dict(learning_rate=6e-4, min_lr=6e-5, warmup_steps=0,
                    lr_decay_steps=37)):
        jcfg, pcfg = _configs(dict(block_size=8, vocab_size=8, n_layer=1,
                                   n_head=1, n_embd=8), **{**TRAIN, **kw})
        steps = np.arange(kw["lr_decay_steps"] + 6)
        ref = np.asarray(jax.jit(jax_schedule(jcfg))(jnp.asarray(steps)))
        got = make_lr_schedule(pcfg)
        assert got(0) == float(ref[0]) == 0.0 or kw["warmup_steps"] == 0
        # 4e-6: near the end of the cosine, 1 + cos(x) cancels and one f32
        # ulp of cos (numpy's against XLA's) grows to a few ulps of the lr
        for step in steps:
            np.testing.assert_allclose(got(int(step)), ref[step], rtol=4e-6,
                                       atol=0, err_msg=str(step))


def test_optimizer_update_matches_optax_chain():
    """Three updates with gradients of global norm ~30 (clip 1.0), from
    zero moments; the moments, bias corrections, decoupled decay and the
    schedule all enter. Each parameter's change is held to the optax
    chain's within 1e-5 of itself (one f32 chain evaluated in another
    order) plus two f32 ulps of the parameter (each package rounds p + u
    to f32, and the two parameter sets may already differ by an ulp)."""
    import optax

    from midgpt_tpu.train import make_optimizer

    _, tm, params = model_pair(dict(block_size=16, vocab_size=32, n_layer=2,
                                    n_head=2, n_embd=32))
    jcfg, pcfg = _configs({**dict(block_size=16, vocab_size=32, n_layer=2,
                                  n_head=2, n_embd=32)})
    tx, _ = make_optimizer(jcfg)
    update = jax.jit(tx.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jparams)
    state = state_from_model(tm)
    sched = make_lr_schedule(pcfg)
    rng = np.random.default_rng(5)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in params.items()}
        assert np.sqrt(sum((a ** 2).sum() for a in g.values())) > 10
        updates, opt = update({k: jnp.asarray(v) for k, v in g.items()},
                               opt, jparams)
        new = optax.apply_updates(jparams, updates)
        gmodel = gpt_from_jax_params(g, pcfg.model, device="cpu")
        before = jax_params_from_gpt(state.model)
        optimizer_update(state, [p.detach() for p in gmodel.parameters()],
                         pcfg, sched(step))
        after = jax_params_from_gpt(state.model)
        for k in params:
            got = after[k].astype(np.float64) - before[k]
            ref = np.asarray(new[k], np.float64) - np.asarray(jparams[k])
            tol = 1e-5 * np.abs(ref) + 2 * np.spacing(np.abs(after[k]))
            assert np.all(np.abs(got - ref) <= tol), (k, step)
            assert step == 0 or np.abs(ref).max() > 0  # lr(0) is 0
        jparams = new


def test_loader_batches_are_bit_identical(tmp_path):
    from midgpt_tpu.data import Loader as JaxLoader
    from midgpt_tpu.data import load_shard as jax_load_shard

    path = str(tmp_path / "train.bin")
    toks = np.random.default_rng(0).integers(0, 50304, 30_000)
    write_tokens(path, toks)
    np.testing.assert_array_equal(np.fromfile(path, np.uint16), toks)
    for stream in (0, 2):
        ours = Loader(load_shard(path), 64, (2, 3), seed=1234, stream=stream)
        ref = JaxLoader(jax_load_shard(path), 64, (2, 3), seed=1234,
                        stream=stream)
        for _ in range(3):
            for a, b in zip(ours.next(), ref.next()):
                assert a.dtype == b.dtype and a.shape == b.shape == (2, 3, 64)
                np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.peek(10_000_007), ref.peek(10_000_007)):
            np.testing.assert_array_equal(a, b)
        assert ours.state_dict() == ref.state_dict()


def test_chunked_xent_and_grads_match_jax():
    from midgpt_tpu.ops.loss import chunked_softmax_xent as jax_xent

    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 64, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 97)) / 4).astype(np.float32)
    y = rng.integers(0, 97, (2, 64)).astype(np.int32)
    ref, (gh, gw) = jax.value_and_grad(
        lambda a, b: jax_xent(a, b, jnp.asarray(y), chunk_t=16),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = t(h).requires_grad_(), t(w).requires_grad_()
    got = chunked_softmax_xent(th, tw, t(y), chunk_t=16)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-7)


TINY = dict(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64,
            attn_impl="naive", remat="none")
FUSED = dict(block_size=128, vocab_size=96, n_layer=2, n_head=2, n_embd=128,
             attn_impl="fused", remat="none")
FLASH = dict(FUSED, vocab_size=65, attn_impl="flash")
FUSED_LONG = dict(FUSED, block_size=256, norm_impl="fused")


@pytest.mark.parametrize("model_kw", [TINY, FUSED, FLASH],
                         ids=["tiny", "fused", "flash"])
def test_loss_trajectory_matches_jax(pallas_interpret, model_kw):
    """Per-step losses within 1e-4 relative. Parameters after 5 steps
    within 2e-6 absolute (2e-3 of one full-lr step) plus 1e-5 relative:
    Adam divides each element's first moment by the root of its second,
    so an element whose gradient is near zero turns the two frameworks'
    f32 rounding differences into a visible share of its (lr-sized)
    update."""
    _trajectory_vs_jax(model_kw)


def test_fused_norm_split_route_trajectory_matches_jax(pallas_interpret,
                                                       monkeypatch):
    """``norm_impl="fused"`` (the port's plain norm kernels; JAX's RMSNorm
    runs its jnp chain off the TPU, the same math) with the attention
    backward on the split route: the port's cap is lowered so that T=256
    takes the split plain dq and dk/dv, which JAX, below its own cap,
    computes with its combined kernel. Held as the test above."""
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.ops import fused_norm as fn

    calls = {"dq": 0, "dkv": 0, "norm": 0}
    for name, mod, attr in (("dq", fa, "fused_attention_bwd_dq"),
                            ("dkv", fa, "fused_attention_bwd_dkv"),
                            ("norm", fn, "fused_rms_norm")):
        def counting(*a, _real=getattr(mod, attr), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, attr, counting)
    monkeypatch.setattr(fa, "BWD_CAP", {2: 128, 1: 128})
    _trajectory_vs_jax(FUSED_LONG)
    # 5 steps x 2 microbatches x 2 layers; norms: 2 per block + ln_f
    assert calls == {"dq": 20, "dkv": 20, "norm": 50}


def _trajectory_vs_jax(model_kw):
    from midgpt_tpu.parallel.mesh import create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_step

    jcfg, pcfg = _configs(model_kw, batch_size=8, g_accum_iters=2,
                          loss_chunk=None)
    jm, tm, _ = model_pair(model_kw, gain=1.0)
    mesh = create_mesh(jcfg.mesh, devices=jax.devices()[:1])
    tx, _ = make_optimizer(jcfg)
    step_fn = make_train_step(jcfg, tx, mesh)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    state = state_from_model(tm)
    shadow = make_shadow(tm, torch.float32)
    sched = make_lr_schedule(pcfg)
    rng = np.random.default_rng(7)
    vocab, tt = model_kw["vocab_size"], model_kw["block_size"]
    for step in range(5):
        toks = rng.integers(0, vocab, (2, 4, tt + 1)).astype(np.int32)
        x, y = toks[..., :-1], toks[..., 1:]
        jstate, jloss = step_fn(jstate, jnp.asarray(x), jnp.asarray(y),
                                jax.random.PRNGKey(0))
        loss, _ = train_step(state, shadow, t(x).long(), t(y).long(), pcfg,
                             sched(step))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   err_msg=f"step {step}")
    ref = dict(tree_paths(jstate.params))
    got = jax_params_from_gpt(state.model)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=2e-6, err_msg=k)


def _resume_cfg(tmp_path, name, **kw):
    data = tmp_path / "data"
    if not (data / "val.bin").exists():
        rng = np.random.default_rng(0)
        base = np.tile(np.arange(64), 400)
        write_tokens(str(data / "train.bin"), base)
        write_tokens(str(data / "val.bin"), rng.integers(0, 64, 5000))
    return get_config(
        "tiny", rundir=str(tmp_path / name), data_dir=str(data),
        device="cpu", eval_interval=100, eval_batches=1, log_interval=1,
        ckpt_interval=100, **kw)


def test_checkpoint_resume_gives_identical_losses(tmp_path):
    full = train(_resume_cfg(tmp_path, "full", max_steps=5))
    assert len(full["losses"]) == 5 and np.isfinite(full["losses"]).all()
    # the end-to-end rate counts every trained token over the whole loop
    assert full["loop_s"] > full["eval_s"] + full["ckpt_s"] > 0
    assert full["tokens_per_sec"] == pytest.approx(5 * 8 * 64 / full["loop_s"])
    part = train(_resume_cfg(tmp_path, "part", max_steps=3))
    assert part["losses"] == full["losses"][:3]
    ckpt_dir = tmp_path / "part" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000002.pt"]
    rest = train(_resume_cfg(tmp_path, "part", max_steps=5))
    assert rest["first_step"] == 3
    assert rest["losses"] == full["losses"][3:]
    # a checkpoint of another model refuses to resume
    other = _resume_cfg(tmp_path, "part", max_steps=6)
    other = dataclasses.replace(
        other, model=dataclasses.replace(other.model, n_embd=32))
    with pytest.raises(ValueError, match="different model"):
        train(other)


@pytest.mark.parametrize("name,micro", [("openwebtext", 8), ("openwebtext", 64),
                                        ("openwebtext_moe", 8),
                                        ("openwebtext_moe", 64),
                                        ("llama_7b", 1), ("tiny", 4)])
def test_hbm_fill_and_remat_resolution_match_jax(name, micro):
    """The memory-fit estimate equals the JAX package's on one device;
    "auto" resolves as JAX's does off the card ("dots" included)."""
    from midgpt_tpu.config import get_config as jax_get_config
    from midgpt_tpu.train import estimate_hbm_fill as jax_fill
    from midgpt_tpu.train import resolve_auto_knobs as jax_resolve
    from midgpt_tpu_torch.config import MODEL_CONFIGS
    from midgpt_tpu_torch.train import estimate_hbm_fill, resolve_auto_knobs

    jcfg = dataclasses.replace(jax_get_config(name), batch_size=micro,
                               g_accum_iters=1, mesh=MeshConfig(fsdp=1))
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, remat="auto"))
    pcfg = ExperimentConfig(
        model=dataclasses.replace(MODEL_CONFIGS[name], remat="auto"),
        batch_size=micro)
    for hbm in (16e9, 80e9):
        assert estimate_hbm_fill(pcfg, hbm) == pytest.approx(
            jax_fill(jcfg, 1, hbm), rel=1e-12)
        want = jax_resolve(jcfg, 1, hbm).model.remat
        assert resolve_auto_knobs(pcfg, hbm).model.remat == want


def test_launch_cli_trains_on_the_cpu(tmp_path):
    from midgpt_tpu_torch.launch import apply_overrides, main

    cfg = apply_overrides(get_config("tiny"),
                          ["model.n_layer=1", "loss_chunk=16", "device=cpu"])
    assert (cfg.model.n_layer, cfg.loss_chunk, cfg.device) == (1, 16, "cpu")
    with pytest.raises(ValueError, match="key=value"):
        apply_overrides(cfg, ["max_steps"])
    data = _resume_cfg(tmp_path, "unused").data_dir
    run = str(tmp_path / "cli")
    final = main(["--config", "tiny", "--rundir", run, "--set",
                  f"data_dir={data}", "device=cpu", "max_steps=3",
                  "eval_batches=1", "model.n_layer=1", "loss_chunk=16"])
    assert len(final["losses"]) == 3
    import json

    with open(os.path.join(run, "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["n_layer"] == 1 and saved["loss_chunk"] == 16
    assert os.listdir(os.path.join(run, "checkpoints")) == [
        "step_00000002.pt"]


DROP = dict(block_size=64, vocab_size=65, n_layer=2, n_head=2, n_embd=64,
            dropout=0.2)


def _drop_step(impl, remat, step_key, seed=0):
    """One optimizer step (2 microbatches, f32) of the dropout config from
    a fixed init: ``(loss, [gradients])``."""
    cfg = ExperimentConfig(
        model=ModelConfig(**DROP, attn_impl=impl, remat=remat), batch_size=4,
        g_accum_iters=2, warmup_steps=0, compute_dtype="float32",
        device="cpu", seed=seed)
    state = init_state(cfg, "cpu")
    shadow = make_shadow(state.model, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 65, (2, 2, 65))).long()
    loss, _ = train_step(state, shadow, toks[..., :-1], toks[..., 1:], cfg,
                         1e-3, step_key=step_key)
    return loss.item(), [p.grad.clone() for p in shadow.parameters()]


@pytest.mark.parametrize("impl,remat", [
    pytest.param("naive", "full", id="naive"),
    pytest.param("flash", "full", id="flash"),
    pytest.param("naive", "dots", id="dots-naive"),
    pytest.param("flash", "dots", id="dots-flash")])
def test_dropout_remat_full_and_none_agree_exactly(impl, remat):
    """A checkpointed block ("full", or "dots", which keeps the products)
    redraws the masks it drew: every mask is a function of its
    per-(layer, site) key, not of a generator's state."""
    key = fold_in(0, 3)
    full = _drop_step(impl, remat, key)
    none = _drop_step(impl, "none", key)
    assert full[0] == none[0]
    for a, b in zip(full[1], none[1]):
        assert torch.equal(a, b)
    again = _drop_step(impl, remat, key)
    assert again[0] == full[0]
    other = _drop_step(impl, remat, fold_in(0, 4))
    assert other[0] != full[0]
    with pytest.raises(ValueError, match="step key"):
        _drop_step(impl, "none", None)


def test_eval_is_deterministic_and_training_drops():
    cfg = ModelConfig(**DROP, attn_impl="naive", remat="none")
    model = init_state(ExperimentConfig(model=cfg, device="cpu"), "cpu").model
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 65, (2, 65))).long()
    x, y = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        evals = [loss_fn(model, x, y).item() for _ in range(2)]
        drawn = [loss_fn(model, x, y, key=k).item() for k in (7, 7, 8)]
        # a key with deterministic=True draws nothing, as in JAX
        det = model(x, key=7, deterministic=True)
        assert torch.equal(det, model(x))
    assert evals[0] == evals[1]
    assert drawn[0] == drawn[1] != drawn[2]
    assert drawn[0] != evals[0]


def test_residual_dropout_keep_fraction():
    x = torch.ones(250, 400)
    key = fold_in(0, 11)
    out = dropout(x, 0.2, key)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    assert torch.all(out[kept] == 1.0 / 0.8)
    assert torch.equal(out, dropout(x, 0.2, key))
    assert not torch.equal(out, dropout(x, 0.2, fold_in(0, 12)))
    assert dropout(x, 0.2, None) is x
    assert dropout(x, 0.0, key) is x


def test_dropout_resume_gives_identical_losses(tmp_path):
    def cfg(name, steps):
        c = _resume_cfg(tmp_path, name, max_steps=steps)
        return dataclasses.replace(
            c, model=dataclasses.replace(c.model, dropout=0.2, n_layer=1))

    full = train(cfg("full", 5))
    part = train(cfg("part", 3))
    assert part["losses"] == full["losses"][:3]
    rest = train(cfg("part", 5))
    assert rest["first_step"] == 3
    assert rest["losses"] == full["losses"][3:]
