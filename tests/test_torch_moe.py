"""The port's Switch mixture-of-experts MLP against the JAX package's, on
the same NumPy inputs at f32 on the CPU (a 2-layer model of width 64 with
4 experts, or the layer alone at width 16).

- ``MoEMLP``'s ``y``, ``aux`` and dropped fraction within 1e-5 of
  ``midgpt_tpu.models.gpt.MoEMLP`` at top_k 1 and 2, with a capacity that
  drops claims (shown to drop) and one that cannot (cf = E); the
  gradients of x, the router and both expert stacks within 1e-4 of
  ``jax.grad``'s;
- the ``GPT``'s logits, ``loss_fn`` (cross-entropy plus the weighted aux)
  and ``moe_stats`` against JAX's; a 5-step f32 loss trajectory of
  ``train_step`` against JAX's train step (``_trajectory_vs_jax``'s
  tolerances);
- ``convert`` both ways in JAX's pytree paths, and a quantized MoE dict
  refused; ``quantize_model`` refuses an MoE model, as JAX's does;
- greedy streams of ``generate_served`` token-identical to the JAX
  engine's (its Pallas kernels in interpret mode): spec-off with the
  prefix cache on and off, ``speculate=3`` and ``prefill_chunk=8``, at a
  capacity that drops claims in verify and prefill calls (the capacity is
  a function of each call's T, so a call at another shape would change
  which claims drop and so the tokens);
- the port's own contracts: ``remat="full"`` and ``"none"`` give the same
  loss and gradients bit for bit with dropout 0.2; a resume ignores a
  changed ``moe_aux_weight`` and refuses changed ``moe_experts``; the
  router telemetry is logged at every eval; ``openwebtext_moe`` has JAX's
  model and mesh (tensor=4), and JAX's FLOPs a token; its entry points
  need the card unless the CPU is asked for.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.models.gpt import MoEMLP as JaxMoEMLP
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.config import ModelConfig, get_config, get_model_config
from midgpt_tpu_torch.convert import gpt_from_jax_params, jax_params_from_gpt
from midgpt_tpu_torch.models.gpt import GPT, MoEMLP
from midgpt_tpu_torch.models.layers import Linear, fold_in
from midgpt_tpu_torch.train import (
    init_state,
    loss_fn,
    make_shadow,
    train,
    train_step,
)

from test_torch_train import _resume_cfg, _trajectory_vs_jax
from torch_port_util import model_pair, t

torch.set_num_threads(2)

# 2 layers, width 64, 4 experts; capacity factor 1: a random router
# overflows its experts, so claims drop
MOE = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=64,
           mlp="moe", moe_experts=4, moe_capacity=1.0)
LAYER = dict(e=4, d=16, f=64)


def _layer_pair(top_k: int, cf: float, seed: int = 0, t: int = 32):
    """The same MoE layer in both packages, NumPy weights from ``seed``."""
    e, d, f = LAYER["e"], LAYER["d"], LAYER["f"]
    rng = np.random.default_rng(seed)
    router = (2 * rng.standard_normal((d, e)) / math.sqrt(d)).astype(
        np.float32)
    up = (rng.standard_normal((e, d, f)) / math.sqrt(d)).astype(np.float32)
    down = (rng.standard_normal((e, f, d)) / math.sqrt(f)).astype(np.float32)
    jcfg = JaxModelConfig(block_size=32, vocab_size=8, n_layer=1, n_head=2,
                          n_embd=d, mlp="moe", moe_experts=e, moe_top_k=top_k,
                          moe_capacity=cf, mlp_hidden=f)
    jm = JaxMoEMLP.init(jax.random.PRNGKey(0), jcfg)
    jm = dataclasses.replace(
        jm, router=dataclasses.replace(jm.router, weight=jnp.asarray(router)),
        expert_up=jnp.asarray(up), expert_down=jnp.asarray(down))
    tm = MoEMLP(Linear(torch.tensor(router)), torch.tensor(up),
                torch.tensor(down), cf, top_k)
    x = rng.standard_normal((3, t, d)).astype(np.float32)
    return jm, tm, x


# (top_k, capacity factor, T, drops): T = 1 is the decode shape, where
# every claim is first in its expert's queue
CASES = [(1, 1.0, 32, True), (1, 4.0, 32, False), (2, 1.0, 32, True),
         (2, 4.0, 32, False), (1, 1.0, 1, False), (2, 1.0, 1, False)]
CASE_IDS = [f"top{k}-cf{cf}-T{t}" for k, cf, t, _ in CASES]


@pytest.mark.parametrize("top_k,cf,t,drops", CASES, ids=CASE_IDS)
def test_moe_layer_matches_jax(top_k, cf, t, drops):
    jm, tm, x = _layer_pair(top_k, cf, t=t)
    jy, jaux, jdrop = jm(jnp.asarray(x), return_dropped=True)
    with torch.no_grad():
        y, aux, dropped = tm(torch.tensor(x), return_dropped=True)
    assert tm.capacity(t) == max(1, min(t, math.ceil(cf * top_k * t
                                                     / LAYER["e"])))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-5)
    np.testing.assert_allclose(dropped.item(), float(jdrop), atol=1e-5)
    assert (dropped.item() > 0) == drops
    assert np.abs(np.asarray(jy)).max() > 0.1  # not a vacuous zero output


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_layer_gradients_match_jax(top_k):
    """d/d(x, router, expert_up, expert_down) of ``sum(y * r) + aux`` at a
    capacity that drops claims."""
    jm, tm, x = _layer_pair(top_k, 1.0, seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(m, xx):
        y, aux = m(xx)
        return jnp.sum(y * r) + aux

    jg_m, jg_x = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y, aux = tm(xt)
    (torch.sum(y * torch.tensor(r)) + aux).backward()
    pairs = [(xt.grad, jg_x), (tm.router.weight.grad, jg_m.router.weight),
             (tm.expert_up.grad, jg_m.expert_up),
             (tm.expert_down.grad, jg_m.expert_down)]
    for name, (got, want) in zip(("x", "router", "up", "down"), pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=name)
    assert np.abs(np.asarray(jg_m.router.weight)).max() > 1e-3


def test_gpt_logits_loss_and_moe_stats_match_jax():
    from midgpt_tpu.train import loss_fn as jax_loss_fn

    jm, tm, _ = model_pair(MOE)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, MOE["vocab_size"], (2, MOE["block_size"] + 1))
    x, y = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        logits = tm(t(x).long())
        loss = loss_fn(tm, t(x).long(), t(y).long())
        xent = loss_fn(tm, t(x).long(), t(y).long(), include_moe_aux=False)
        stats = tm.moe_stats(t(x).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jm(jnp.asarray(x))),
                               atol=1e-4, rtol=1e-5)
    jloss = jax_loss_fn(jm, jnp.asarray(x), jnp.asarray(y), None, True)
    jxent = jax_loss_fn(jm, jnp.asarray(x), jnp.asarray(y), None, True,
                        include_moe_aux=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(xent.item(), float(jxent), rtol=1e-5)
    jstats = jm.moe_stats(jnp.asarray(x))
    np.testing.assert_allclose(stats["aux"].item(), float(jstats["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(stats["dropped_frac"].item(),
                               float(jstats["dropped_frac"]), atol=1e-6)
    assert stats["dropped_frac"].item() > 0
    # the optimized loss carries the weighted aux, summed over the layers
    with torch.no_grad():
        _, aux = tm.hidden(t(x).long(), return_aux=True)
    assert loss.item() == pytest.approx(xent.item() + 0.01 * aux.item(),
                                        rel=1e-6)
    np.testing.assert_allclose(aux.item(), stats["aux"].item(), rtol=1e-6)


def test_moe_loss_trajectory_matches_jax():
    _trajectory_vs_jax(MOE)


def test_convert_round_trip_of_jax_moe_params():
    from midgpt_tpu.quant import quantize_model as jax_quantize

    jm, tm, params = model_pair(MOE)
    paths = [p for p, _ in tree_paths(jm)]
    for p in ("blocks/mlp/router/weight", "blocks/mlp/expert_up",
              "blocks/mlp/expert_down"):
        assert p in paths
    back = jax_params_from_gpt(tm)
    assert set(back) == set(params)
    for k in params:
        assert np.array_equal(back[k], params[k]), k
    assert dict(tree_paths(jm))["blocks/mlp/expert_up"].shape == (
        2, 4, 64, 256)
    # a quantized MoE model: JAX's quantize_model refuses it, and a dict
    # with int8 leaves beside an MoE config is refused here
    with pytest.raises(AssertionError):
        jax_quantize(jm)
    q = dict(params, **{"lm_head/scale": np.ones(96, np.float32)})
    with pytest.raises(ValueError, match="MoE"):
        gpt_from_jax_params(q, ModelConfig(**MOE), device="cpu")
    bad = dict(params)
    bad["blocks/mlp/expert_up"] = bad["blocks/mlp/expert_up"][:, :3]
    with pytest.raises(ValueError, match="expert_up"):
        gpt_from_jax_params(bad, ModelConfig(**MOE), device="cpu")


def test_quantize_model_refuses_moe():
    from midgpt_tpu_torch.quant import quantize_model

    _, tm, _ = model_pair(MOE)
    with pytest.raises(ValueError, match="MoE"):
        quantize_model(tm)


def _serve_prompts(vocab):
    """Random prompts and a repetitive one (its n-grams draft), shorter
    and longer than a page."""
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (5, 13, 21, 30)]
    motif = rng.integers(0, vocab, size=4)
    ps.append(np.tile(motif, 6).astype(np.int32))
    return ps


SERVE_VARIANTS = [dict(), dict(prefix_cache=False), dict(speculate=3),
                  dict(prefill_chunk=8)]
SERVE_IDS = ["cache-on", "cache-off", "spec3", "chunk8"]


@pytest.mark.parametrize("kw", SERVE_VARIANTS, ids=SERVE_IDS)
def test_moe_serving_streams_match_jax(pallas_interpret, monkeypatch, kw):
    """Greedy streams equal the JAX engine's. Every call of the port's
    MoE layers is recorded with its T and dropped fraction: claims drop in
    prefill calls (and in verify calls at ``speculate=3``, T = 4 rows at
    capacity 1), so a call at another T than JAX's would show here."""
    from midgpt_tpu.serving import generate_served as jax_generate_served
    from midgpt_tpu_torch.serving import generate_served

    jm, tm, _ = model_pair(MOE)
    prompts, n_new = _serve_prompts(MOE["vocab_size"]), 12
    common = dict(slots=2, page_size=8, window=4, **kw)
    ref = jax_generate_served(jm, prompts, n_new, cache_dtype=jnp.float32,
                              paged_kernel="pallas", **common)
    calls = []
    forward = MoEMLP.forward

    def recording(self, x, key=None, return_dropped=False, need_aux=True):
        y, aux, dropped = forward(self, x, key, True, need_aux)
        calls.append((x.shape[1], dropped.item()))
        return (y, aux, dropped) if return_dropped else (y, aux)

    monkeypatch.setattr(MoEMLP, "forward", recording)
    with torch.no_grad():
        got = generate_served(tm, prompts, n_new, device="cpu", **common)
    assert [list(map(int, a)) for a in got] == [list(map(int, a))
                                                for a in ref]
    assert len({tuple(a) for a in got}) > 1
    by_t = {}
    for tt, d in calls:
        by_t.setdefault(tt, []).append(d)
    assert max(max(v) for tt, v in by_t.items() if tt >= 8) > 0  # prefill
    if kw.get("speculate"):
        assert max(by_t[4]) > 0  # verify: spec + 1 rows
        assert 1 not in by_t  # no decode window runs with speculation
    else:
        assert max(by_t[1]) == 0  # decode: cap 1, one claim a row


def _moe_drop_step(remat, step_key):
    cfg = get_config(
        "tiny", batch_size=4, g_accum_iters=2, warmup_steps=0,
        compute_dtype="float32", device="cpu",
        model=ModelConfig(**MOE, dropout=0.2, attn_impl="naive",
                          remat=remat))
    state = init_state(cfg, "cpu")
    shadow = make_shadow(state.model, torch.float32)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, MOE["vocab_size"], (2, 2, 65))).long()
    loss, _ = train_step(state, shadow, toks[..., :-1], toks[..., 1:], cfg,
                         1e-3, step_key=step_key)
    return loss.item(), [p.grad.clone() for p in shadow.parameters()]


def test_moe_remat_full_and_none_agree_exactly():
    """A checkpointed MoE block recomputes the same routing, drops and
    dropout masks: loss and every gradient bit for bit."""
    key = fold_in(0, 3)
    full = _moe_drop_step("full", key)
    none = _moe_drop_step("none", key)
    assert full[0] == none[0]
    for a, b in zip(full[1], none[1]):
        assert torch.equal(a, b)
    assert _moe_drop_step("full", fold_in(0, 4))[0] != full[0]


def test_moe_resume_fingerprint_and_router_telemetry(tmp_path):
    """A tiny MoE run resumes after ``moe_aux_weight`` changes (a training
    knob) and refuses a checkpoint once ``moe_experts`` changes; every
    eval logs ``moe/aux`` and ``moe/dropped_frac``."""
    from midgpt_tpu_torch.utils.metrics import read_metrics

    def cfg(name, steps, **model_kw):
        c = _resume_cfg(tmp_path, name, max_steps=steps)
        return dataclasses.replace(c, eval_interval=2, model=dataclasses.replace(
            c.model, **{"mlp": "moe", "moe_experts": 4, "n_layer": 1,
                        **model_kw}))

    part = train(cfg("run", 3))
    rows = [r for r in read_metrics(str(tmp_path / "run"))
            if "loss/train" in r]
    assert [r["step"] for r in rows] == [0, 2]
    for r in rows:
        assert r["moe/aux"] > 0 and 0 <= r["moe/dropped_frac"] < 1
    rest = train(cfg("run", 5, moe_aux_weight=0.1))
    assert rest["first_step"] == 3 and len(part["losses"]) == 3
    with pytest.raises(ValueError, match="different model"):
        train(cfg("run", 6, moe_experts=2))


def test_openwebtext_moe_config_flops_and_fit_match_jax():
    from midgpt_tpu.config import get_config as jax_get_config
    from midgpt_tpu.models.gpt import GPT as JaxGPT
    from midgpt_tpu.models.gpt import count_params as jax_count_params
    from midgpt_tpu.utils.metrics import flops_per_token as jax_flops
    from midgpt_tpu_torch.models.gpt import count_params
    from midgpt_tpu_torch.utils.metrics import flops_per_token

    jcfg = jax_get_config("openwebtext_moe")
    pcfg = get_config("openwebtext_moe")
    for f in dataclasses.fields(pcfg.model):
        assert getattr(pcfg.model, f.name) == getattr(jcfg.model, f.name), f
    for f in dataclasses.fields(pcfg):
        if f.name not in ("model", "device", "mesh"):
            assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
    # JAX's mesh: the experts shard over tensor=4 (expert parallelism)
    mesh, jmesh = dataclasses.asdict(pcfg.mesh), dataclasses.asdict(jcfg.mesh)
    assert mesh == jmesh and mesh["tensor"] == 4
    assert flops_per_token(pcfg.model) == jax_flops(jcfg.model)
    assert flops_per_token(pcfg.model) == flops_per_token(
        get_model_config("openwebtext"))  # top-1: the active FLOPs
    # parameter counts of a narrow cut (JAX's count_params convention)
    small = dict(MOE, n_layer=1)
    jm = JaxGPT.init(jax.random.PRNGKey(0), JaxModelConfig(**small))
    pm = GPT.init(ModelConfig(**small), device="cpu")
    assert count_params(pm) == jax_count_params(jm)
    # the entry points need the card unless asked for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GPT.init(pcfg.model)
        with pytest.raises(RuntimeError, match="CUDA"):
            train(dataclasses.replace(pcfg, rundir="unused"))
