"""The trainer's rest against the JAX package's (f32 on the CPU).

- ``remat="dots"``: "dots" and "full" give "none"'s loss and gradients
  bit for bit on MHA/GELU, GQA/SwiGLU and MoE port models (deterministic
  algorithms on, so the embedding's backward sums in one order); during
  ``backward()`` a ``TorchDispatchMode`` counts as many ``aten.mm`` under
  "dots" as under "none" (no product recomputed) and more under "full";
  a 5-step loss trajectory at "dots" matches the JAX trainer's at
  "dots" (``test_loss_trajectory_matches_jax``'s tolerances);
- ``independent_wd=False``: ``optimizer_update`` matches the optax chain
  of ``make_optimizer`` (decay by ``wd``, not ``wd / lr``);
- ``resolve_auto_knobs`` off the card picks "dots" where JAX's rule does;
  on the card it takes the first rung whose ``card_peak_bytes`` fits;
  ``parameter_count`` counts ``GPT.init``'s parameters;
- the card estimate's activation term (``activation_bytes``) equals the
  bytes one microbatch's saved tensors take, counted through
  ``saved_tensors_hooks`` (storages counted once, parameters left out),
  under "none" and "full"; under "dots" those plus the products the
  policy keeps (``aten.mm`` outputs it marks MUST_SAVE). Under the two
  checkpoints the fused route's f32 RoPE tables are held by the
  checkpoint's arguments, not saved: the count adds them;
- the first-step OOM ladder (``torch.OutOfMemoryError`` raised by a
  patched ``GPT.hidden`` at chosen rungs): none -> dots and none -> dots
  -> full retry on the same batch and give a direct run's losses at the
  final rung bit for bit; an explicit remat, another error, an OOM at
  step 2 and an exhausted ladder re-raise;
- SIGTERM in-process (``signal.raise_signal`` after step k's update):
  ``interrupted_at == k``, the newest checkpoint is step k, the previous
  handler is back, and resuming gives the uninterrupted run's losses;
- asynchronous checkpoints: a change to the items after ``save``
  returns never reaches the file; no ``step_N.pt`` is visible before the
  rename; a writer error surfaces at ``close``; a forced save of the step
  in flight is a no-op; resuming after an asynchronous run equals
  resuming after a synchronous one.
"""

import dataclasses
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import midgpt_tpu_torch.models.gpt as gpt
import midgpt_tpu_torch.train as tr
from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.checkpoint import Checkpointer
from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig, get_config
from midgpt_tpu_torch.convert import gpt_from_jax_params, jax_params_from_gpt
from midgpt_tpu_torch.data import write_tokens
from midgpt_tpu_torch.models.gpt import GPT

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)

MOE = dict(MHA, mlp="moe", moe_experts=4)
MODELS = {"mha_gelu": MHA, "gqa_swiglu": GQA, "moe": MOE}
TRAIN = dict(learning_rate=1e-3, min_lr=1e-4, warmup_steps=2,
             lr_decay_steps=10, beta2=0.99, weight_decay=1e-4,
             grad_clip=1.0)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _grads(model_kw, remat):
    """One microbatch's loss and gradients (f32, the chunked loss), and the
    products ``backward()`` ran."""
    model = GPT.init(ModelConfig(**model_kw, remat=remat),
                     torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, model_kw["vocab_size"], (2, model_kw["block_size"] + 1)))
    loss = tr.loss_fn(model, toks[:, :-1], toks[:, 1:], 32)
    with _CountMM() as count:
        loss.backward()
    return loss.item(), [p.grad for p in model.parameters()], count.mm


@pytest.mark.parametrize("name", list(MODELS))
def test_remat_dots_and_full_give_none_exactly(deterministic, name):
    none = _grads(MODELS[name], "none")
    dots = _grads(MODELS[name], "dots")
    full = _grads(MODELS[name], "full")
    for other in (dots, full):
        assert other[0] == none[0]
        assert all(torch.equal(a, b) for a, b in zip(other[1], none[1]))
    # "dots" recomputes no product; "full" recomputes the block's
    assert dots[2] == none[2]
    assert full[2] > none[2]


def _configs(model_kw, **kw):
    kw = {**TRAIN, **kw}
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(**model_kw), compute_dtype="float32",
        mesh=MeshConfig(fsdp=1), **kw)
    pcfg = ExperimentConfig(model=ModelConfig(**model_kw),
                            compute_dtype="float32", device="cpu", **kw)
    return jcfg, pcfg


def test_remat_dots_loss_trajectory_matches_jax():
    """5 steps, 2 microbatches, from a converted init, both packages at
    remat "dots": losses within 1e-4 relative, parameters within 2e-6
    plus 1e-5 relative (the tolerances of
    ``test_loss_trajectory_matches_jax``)."""
    from midgpt_tpu.parallel.mesh import create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_step

    model_kw = dict(block_size=64, vocab_size=256, n_layer=2, n_head=2,
                    n_embd=64, attn_impl="naive", remat="dots")
    jcfg, pcfg = _configs(model_kw, batch_size=8, g_accum_iters=2)
    jm, tm, _ = model_pair(model_kw, gain=1.0)
    mesh = create_mesh(jcfg.mesh, devices=jax.devices()[:1])
    tx, _ = make_optimizer(jcfg)
    step_fn = make_train_step(jcfg, tx, mesh)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    state = tr.state_from_model(tm)
    shadow = tr.make_shadow(tm, torch.float32)
    sched = tr.make_lr_schedule(pcfg)
    rng = np.random.default_rng(7)
    for step in range(5):
        toks = rng.integers(0, 256, (2, 4, 65)).astype(np.int32)
        x, y = toks[..., :-1], toks[..., 1:]
        jstate, jloss = step_fn(jstate, jnp.asarray(x), jnp.asarray(y),
                                jax.random.PRNGKey(0))
        loss, _ = tr.train_step(state, shadow, t(x).long(), t(y).long(),
                                pcfg, sched(step))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4,
                                   err_msg=f"step {step}")
    ref = dict(tree_paths(jstate.params))
    got = jax_params_from_gpt(state.model)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-5,
                                   atol=2e-6, err_msg=k)


def test_optimizer_update_without_independent_wd_matches_optax():
    """``independent_wd=False``: three updates (gradients of global norm
    ~30, clip 1.0, a weight decay large enough to see) held to the optax
    chain as in ``test_optimizer_update_matches_optax_chain``."""
    import optax

    from midgpt_tpu.train import make_optimizer

    model_kw = dict(block_size=16, vocab_size=32, n_layer=2, n_head=2,
                    n_embd=32)
    _, tm, params = model_pair(model_kw)
    jcfg, pcfg = _configs(model_kw, independent_wd=False, weight_decay=0.1)
    tx, _ = make_optimizer(jcfg)
    update = jax.jit(tx.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jparams)
    state = tr.state_from_model(tm)
    sched = tr.make_lr_schedule(pcfg)
    rng = np.random.default_rng(5)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in params.items()}
        updates, opt = update({k: jnp.asarray(v) for k, v in g.items()},
                              opt, jparams)
        new = optax.apply_updates(jparams, updates)
        gmodel = gpt_from_jax_params(g, pcfg.model, device="cpu")
        before = jax_params_from_gpt(state.model)
        tr.optimizer_update(state, [p.detach() for p in gmodel.parameters()],
                            pcfg, sched(step))
        after = jax_params_from_gpt(state.model)
        for k in params:
            got = after[k].astype(np.float64) - before[k]
            ref = np.asarray(new[k], np.float64) - np.asarray(jparams[k])
            tol = 1e-5 * np.abs(ref) + 2 * np.spacing(np.abs(after[k]))
            assert np.all(np.abs(got - ref) <= tol), (k, step)
        jparams = new
    # the decay differs from the default's: wd against wd / lr
    other = tr.state_from_model(gpt_from_jax_params(params, pcfg.model,
                                                    device="cpu"))
    tr.optimizer_update(other, [torch.ones_like(p) for p in
                                other.model.parameters()],
                        dataclasses.replace(pcfg, independent_wd=True), 1e-3)
    mine = tr.state_from_model(gpt_from_jax_params(params, pcfg.model,
                                                   device="cpu"))
    tr.optimizer_update(mine, [torch.ones_like(p) for p in
                               mine.model.parameters()], pcfg, 1e-3)
    assert not torch.equal(next(other.model.parameters()),
                           next(mine.model.parameters()))


@pytest.mark.parametrize("micro", [48, 56])
def test_auto_resolves_to_dots_where_jax_does(micro):
    from midgpt_tpu.config import get_config as jax_get_config
    from midgpt_tpu.train import resolve_auto_knobs as jax_resolve
    from midgpt_tpu_torch.config import MODEL_CONFIGS

    jcfg = dataclasses.replace(jax_get_config("openwebtext"),
                               batch_size=micro, g_accum_iters=1,
                               mesh=MeshConfig(fsdp=1))
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, remat="auto"))
    pcfg = ExperimentConfig(
        model=dataclasses.replace(MODEL_CONFIGS["openwebtext"],
                                  remat="auto"), batch_size=micro)
    assert jax_resolve(jcfg, 1, 16e9).model.remat == "dots"
    assert tr.resolve_auto_knobs(pcfg, 16e9).model.remat == "dots"


# "auto"'s choice on an 80 GB card before the headroom scaled with the
# run (a fixed 256 MiB); peaks an H100 80GB HBM3 measured for a
# shakespeare_char run at remat "full" (max_memory_allocated, graph
# pools included)
CARD_CHOICES = {"openwebtext": "dots", "openwebtext_moe": "dots",
                "shakespeare_char": "none", "tiny": "none"}
CHAR_PEAKS = (670_771_200, 704_980_992, 706_293_760, 708_913_152)


@pytest.mark.parametrize("name", list(CARD_CHOICES))
def test_card_fit_headroom_scales_with_the_run(name):
    """The fit's headroom is cuBLAS's fixed workspaces and a share of the
    larger moment: "auto" picks what it picked with the fixed 256 MiB,
    and char's estimate shrinks into the 0.8-1.25 band of its peaks."""
    cfg = get_config(name)
    auto = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat="auto"))
    got = tr.resolve_auto_knobs(auto, int(80e9), card=True).model.remat
    assert got == CARD_CHOICES[name]
    est = tr.card_peak_bytes(cfg, got)
    larger = max(est["backward"], est["optimizer"])
    assert est["headroom"] == (tr.CARD_HEADROOM_BYTES + int(
        tr.CARD_HEADROOM_SHARE * larger))
    assert est["peak"] == larger + est["headroom"]
    if name == "shakespeare_char":
        est = tr.card_peak_bytes(cfg)  # the run's own remat, "full"
        assert cfg.model.remat == "full"
        larger = max(est["backward"], est["optimizer"])
        assert est["peak"] < larger + (256 << 20)
        for peak in CHAR_PEAKS:
            assert 0.8 <= est["peak"] / peak <= 1.25


def test_card_resolution_takes_the_first_rung_that_fits():
    cfg = get_config("openwebtext_moe", batch_size=128, g_accum_iters=1)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat="auto"))
    peaks = {r: tr.card_peak_bytes(cfg, r)["peak"] for r in tr.REMAT_LADDER}
    assert peaks["full"] < peaks["dots"] < peaks["none"]
    for hbm, want in ((peaks["none"] / 0.89, "none"),
                      (peaks["dots"] / 0.89, "dots"),
                      (peaks["full"] / 0.89, "full"),
                      (peaks["full"] / 2, "full")):
        got = tr.resolve_auto_knobs(cfg, int(hbm), card=True)
        assert got.model.remat == want
    explicit = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat="none"))
    assert tr.resolve_auto_knobs(explicit, 1, card=True) is explicit


@pytest.mark.parametrize("name", ["openwebtext", "openwebtext_moe",
                                  "llama_7b", "shakespeare_char", "tiny"])
def test_parameter_count_counts_gpt_init(name):
    from midgpt_tpu_torch.config import MODEL_CONFIGS

    cfg = MODEL_CONFIGS[name]
    if name == "llama_7b":  # too large to build here: a narrow copy
        cfg = dataclasses.replace(cfg, n_layer=2, n_embd=512, n_head=4,
                                  n_kv_head=2, vocab_size=512)
    with torch.device("meta"):
        model = GPT(cfg, *_meta_parts(cfg))
    assert tr.parameter_count(cfg) == sum(p.numel()
                                          for p in model.parameters())


def _meta_parts(cfg):
    from midgpt_tpu_torch.models.gpt import Block
    from midgpt_tpu_torch.models.layers import Embedding, Linear

    gen = torch.Generator()
    blocks = [Block.init(cfg, gen) for _ in range(cfg.n_layer)]
    wte = Embedding(torch.empty(cfg.vocab_size, cfg.n_embd))
    head = None if cfg.tie_embeddings else Linear(
        torch.empty(cfg.n_embd, cfg.vocab_size))
    return wte, blocks, head


# -- the card estimate's activation term -------------------------------------

ACT_BASE = dict(block_size=128, vocab_size=96, n_layer=2, n_head=2,
                n_embd=128)
ACT_MODELS = {
    "fused": dict(attn_impl="fused"),
    "fused_norm": dict(attn_impl="fused", norm_impl="fused"),
    "fused_gqa_swiglu": dict(attn_impl="fused", n_head=4, n_embd=512,
                             n_kv_head=2, mlp="swiglu"),
    "fused_moe": dict(attn_impl="fused", mlp="moe", moe_experts=4),
    "fused_moe_top2": dict(attn_impl="fused", mlp="moe", moe_experts=4,
                           moe_top_k=2),
    "flash": dict(attn_impl="flash"),
    "flash_dropout": dict(attn_impl="flash", dropout=0.2),
    "flash_gqa_swiglu": dict(attn_impl="flash", n_head=4, n_embd=512,
                             n_kv_head=2, mlp="swiglu"),
    "naive": dict(attn_impl="naive"),
}


def _counted_bytes(cfg, remat, monkeypatch):
    """One bf16 microbatch's saved bytes: every storage the
    saved-tensor hooks see (once; parameters left out) and, under
    "dots", the outputs of the products the policy keeps."""
    model = tr.make_shadow(GPT.init(
        dataclasses.replace(cfg.model, remat=remat),
        torch.Generator().manual_seed(0), device="cpu"), torch.bfloat16)
    b, tt, v = cfg.microbatch_size, cfg.model.block_size, cfg.model.vocab_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, v, (b, tt)))
    y = torch.from_numpy(rng.integers(0, v, (b, tt)))
    seen, kept = {}, []
    real = gpt._dots_policy

    def policy(ctx, op, *args, **kwargs):
        out = real(ctx, op, *args, **kwargs)
        if (out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                and not ctx.is_recompute):
            lhs, rhs = args[-2], args[-1]
            kept.append(lhs.shape[0] * rhs.shape[1] * lhs.dtype.itemsize)
        return out

    monkeypatch.setattr(gpt, "_dots_policy", policy)

    def pack(tensor):
        st = tensor.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return tensor

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        tr.loss_fn(model, x, y, tr.effective_loss_chunk(cfg),
                   key=7 if cfg.model.dropout else None)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    return sum(n for k, n in seen.items() if k not in params) + sum(kept)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("name", list(ACT_MODELS))
def test_activation_term_counts_the_saved_tensors(name, remat, monkeypatch):
    kw = {**ACT_BASE, **ACT_MODELS[name]}
    cfg = ExperimentConfig(model=ModelConfig(**kw), batch_size=2,
                           device="cpu", loss_chunk=32)
    route = kw["attn_impl"]
    got = _counted_bytes(cfg, remat, monkeypatch)
    if remat != "none" and route == "fused":
        # sin_full, cos_full [T, C] f32: checkpoint arguments, not saved
        got += 2 * 4 * kw["block_size"] * (kw["n_embd"] // kw["n_head"])
    assert tr.activation_bytes(cfg, remat, route)["saved"] == got
    # the card takes the fused route where its kernels can, else flash
    card = tr.activation_bytes(cfg, remat)
    if route != "naive":
        assert card == tr.activation_bytes(cfg, remat, route)


# -- the first-step OOM ladder ------------------------------------------------

def _run_cfg(tmp_path, name, **kw):
    data = tmp_path / "data"
    if not (data / "val.bin").exists():
        rng = np.random.default_rng(0)
        write_tokens(str(data / "train.bin"), np.tile(np.arange(64), 400))
        write_tokens(str(data / "val.bin"), rng.integers(0, 64, 5000))
    kw = {"eval_interval": 100, "eval_batches": 1, "log_interval": 1,
          "ckpt_interval": 100, "max_steps": 4, "compute_dtype": "float32",
          **kw}
    return get_config("tiny", rundir=str(tmp_path / name),
                      data_dir=str(data), device="cpu", **kw)


def _with_remat(cfg, remat):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=remat))


def _oom_at(monkeypatch, rungs, calls=None, error=None):
    """Training forwards at a remat in ``rungs`` raise (an OOM unless
    ``error``); with ``calls``, only the training forwards whose index is
    in it. Records each training forward's (remat, first token row)."""
    seen = []
    real = GPT.hidden

    def hidden(self, tokens, *a, **kw):
        if torch.is_grad_enabled():
            seen.append((self.config.remat, tokens[0].tolist()))
            if self.config.remat in rungs and (
                    calls is None or len(seen) - 1 in calls):
                raise (error or torch.OutOfMemoryError(
                    "CUDA out of memory (injected)"))
        return real(self, tokens, *a, **kw)

    monkeypatch.setattr(GPT, "hidden", hidden)
    return seen


@pytest.mark.parametrize("bad,final_rung", [({"none"}, "dots"),
                                            ({"none", "dots"}, "full")],
                         ids=["none_to_dots", "none_to_dots_to_full"])
def test_oom_ladder_steps_down_and_retries(tmp_path, monkeypatch, capsys,
                                           bad, final_rung):
    auto = _with_remat(_run_cfg(tmp_path, "auto"), "auto")
    direct = tr.train(_with_remat(_run_cfg(tmp_path, "direct"), final_rung))
    seen = _oom_at(monkeypatch, bad)
    got = tr.train(auto)
    assert got["remat"] == final_rung
    assert got["losses"] == direct["losses"]
    out = capsys.readouterr().out
    ladder = ["none", "dots", "full"][:len(bad) + 1]
    for a, b in zip(ladder, ladder[1:]):
        assert f"first-step OOM at remat={a}; retrying with remat={b}" in out
    # every rung tried the first step's first microbatch
    first = [row for _, row in seen[:len(bad) + 1]]
    assert all(row == first[0] for row in first)
    assert [r for r, _ in seen[:len(bad) + 1]] == ladder


@pytest.mark.parametrize("case", ["explicit", "other_error", "second_step",
                                  "exhausted"])
def test_oom_ladder_reraises(tmp_path, monkeypatch, case):
    cfg = _with_remat(_run_cfg(tmp_path, case), "auto")
    if case == "explicit":
        cfg = _with_remat(cfg, "none")
        _oom_at(monkeypatch, {"none"})
    elif case == "other_error":
        _oom_at(monkeypatch, {"none"}, error=RuntimeError("not memory"))
    elif case == "second_step":  # calls 2, 3: step 1's two microbatches
        _oom_at(monkeypatch, {"none", "dots", "full"}, calls={2})
    else:
        _oom_at(monkeypatch, {"none", "dots", "full"})
    with pytest.raises((torch.OutOfMemoryError, RuntimeError)) as info:
        tr.train(cfg)
    if case == "other_error":
        assert "not memory" in str(info.value)
    else:
        assert isinstance(info.value, torch.OutOfMemoryError)


# -- SIGTERM -------------------------------------------------------------------

def test_sigterm_saves_the_step_and_resumes(tmp_path, monkeypatch):
    full = tr.train(_run_cfg(tmp_path, "full", max_steps=6))
    k = 2
    real = tr.step_body
    bodies = []

    def step_then_signal(*args, **kwargs):
        real(*args, **kwargs)
        bodies.append(1)
        if len(bodies) == k + 1:  # step k's update is done
            signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(tr, "step_body", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    cfg = _run_cfg(tmp_path, "cut", max_steps=6)
    part = tr.train(cfg)
    assert signal.getsignal(signal.SIGTERM) is before
    assert part["interrupted_at"] == k
    assert part["losses"] == full["losses"][:k + 1]
    ck = Checkpointer(cfg.rundir)
    assert ck.all_steps() == [k]  # the interval save of step 0 pruned
    assert ck.restore()[1]["loader"] == {"step": k + 1, "seed": 1234}
    monkeypatch.setattr(tr, "step_body", real)
    rest = tr.train(cfg)
    assert rest["first_step"] == k + 1
    assert rest["losses"] == full["losses"][k + 1:]


# -- asynchronous checkpoints ------------------------------------------------

def _blocking_save(monkeypatch):
    """``torch.save`` in the writer waits until ``release`` is set."""
    import midgpt_tpu_torch.checkpoint as ckmod

    started, release = threading.Event(), threading.Event()
    real = ckmod.torch.save

    def save(obj, path):
        started.set()
        assert release.wait(timeout=30)
        real(obj, path)

    monkeypatch.setattr(ckmod.torch, "save", save)
    return started, release


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    started, release = _blocking_save(monkeypatch)
    ck = Checkpointer(str(tmp_path), save_interval_steps=5)
    w = torch.arange(10.0)
    assert ck.save(5, {"w": w, "step": 5}, {"step": 5})
    assert started.wait(timeout=30)
    w.add_(100.0)  # the masters move on while the write runs
    # nothing is visible under the final name before the rename
    names = os.listdir(ck.directory) if os.path.isdir(ck.directory) else []
    assert not any(n.startswith("step_") and n.endswith(".pt")
                   for n in names)
    assert ck.latest_step() == 5 and ck.all_steps() == [5]
    # a forced save of the step in flight is a no-op
    assert ck.save(5, {"w": w, "step": 5}, {"step": 5}, force=True) is False
    release.set()
    ck.close()
    assert os.listdir(ck.directory) == ["step_00000005.pt"]
    items, meta = ck.restore()
    assert torch.equal(items["w"], torch.arange(10.0))
    assert items["step"] == 5 and meta == {"step": 5}


def test_async_writer_error_surfaces_at_close(tmp_path, monkeypatch):
    import midgpt_tpu_torch.checkpoint as ckmod

    def fail(obj, path):
        with open(path, "w") as f:
            f.write("torn")
        raise OSError("disk full (injected)")

    monkeypatch.setattr(ckmod.torch, "save", fail)
    ck = Checkpointer(str(tmp_path), save_interval_steps=1)
    assert ck.save(0, {"w": torch.ones(3)}, {"step": 0})
    with pytest.raises(OSError, match="disk full"):
        ck.close()
    assert os.listdir(ck.directory) == []  # the temporary file is gone
    assert ck.latest_step() is None
    ck.close()  # raised once


class _SyncCheckpointer(Checkpointer):
    def __init__(self, *args, async_save=True, **kwargs):
        super().__init__(*args, async_save=False, **kwargs)


def test_resume_after_async_equals_resume_after_sync(tmp_path, monkeypatch):
    kw = dict(max_steps=3, ckpt_interval=1)
    tr.train(_run_cfg(tmp_path, "async", **kw))
    async_rest = tr.train(_run_cfg(tmp_path, "async", max_steps=5,
                                   ckpt_interval=1))
    monkeypatch.setattr(tr, "Checkpointer", _SyncCheckpointer)
    tr.train(_run_cfg(tmp_path, "sync", **kw))
    sync_rest = tr.train(_run_cfg(tmp_path, "sync", max_steps=5,
                                  ckpt_interval=1))
    assert async_rest["first_step"] == sync_rest["first_step"] == 3
    assert async_rest["losses"] == sync_rest["losses"]
    a = torch.load(tmp_path / "async" / "checkpoints" / "step_00000004.pt",
                   weights_only=True)
    s = torch.load(tmp_path / "sync" / "checkpoints" / "step_00000004.pt",
                   weights_only=True)
    for item in ("params", "mu", "nu"):
        for name in a["items"][item]:
            assert torch.equal(a["items"][item][name],
                               s["items"][item][name])
    assert a["meta"]["loader"] == s["meta"]["loader"] == {"step": 5,
                                                          "seed": 1234}
