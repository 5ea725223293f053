"""The pipeline axis in training against JAX, on the CPU (f32 compute;
gloo worlds of spawned ranks, ``torch_dist_util``).

Five mesh steps of the port's pipelined trainer (each rank one GPipe
stage: ``L / S`` blocks, ``wte`` on the first stage, ``lm_head`` on the
last, the schedule and its backward written out over counted P2P
hand-offs) against JAX's ``make_train_window`` on a host mesh of the
same sizes, fed the same global batch: losses and grad norms (rtol 1e-5)
and the gathered f32 params in JAX's full layout (rtol 1e-5, atol 2e-6,
on the first stage's ranks, which keep a save), at ``pipeline=2``
(world 2), ``pipeline=4`` (world 4, four layers), ``pipeline=2 x
fsdp=2`` (world 4), ``pipeline=2 x tensor=2`` (world 4) and
``pipeline=2`` with ``g_accum_iters=2``. JAX's pipelined step (its
``shard_map`` over ``pipeline``) is held at those tolerances too; each
case also checks that the port's pipelined step equals its own
unpipelined one-rank step on the same rows (the GPipe microbatches only
reorder f32 sums).

Dropout at ``pipeline=2``: each microbatch draws its rows of the
microstep's masks, so five steps equal the port's unpipelined world of
one on the same rows and step keys (rtol 1e-6), and another key moves
the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig as JaxMeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.models.layers import fold_in
from midgpt_tpu_torch.parallel.pipeline import microbatches

from test_torch_mesh import MODEL, STEPS, TRAIN, _as_jax_paths
from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

CASES = [
    (2, dict(fsdp=1, pipeline=2), {}, 1),
    (4, dict(fsdp=1, pipeline=4), dict(n_layer=4), 1),
    (4, dict(fsdp=2, pipeline=2), {}, 1),
    (4, dict(fsdp=1, tensor=2, pipeline=2), {}, 1),
    (2, dict(fsdp=1, pipeline=2), {}, 2),
]
IDS = ["pipeline2", "pipeline4", "fsdp2_pipeline2", "tensor2_pipeline2",
       "pipeline2_accum2"]


def batches(g: int, vocab: int = MODEL["vocab_size"], seed: int = 7):
    """``[STEPS, G, B / G, T]`` inputs and targets of the global batch."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (STEPS, g, TRAIN["batch_size"] // g,
                                   MODEL["block_size"] + 1))
    return toks[..., :-1].astype(np.int32), toks[..., 1:].astype(np.int32)


def port_args(tm, mesh, g, model_kw, **extra):
    xs, ys = batches(g)
    return dict(model=dict(MODEL, **model_kw),
                train=dict(TRAIN, g_accum_iters=g, compute_dtype="float32",
                           device="cpu"),
                mesh=mesh, init={k: v.clone() for k, v in
                                 tm.state_dict().items()},
                xs=xs, ys=ys, gather_after=(STEPS,), **extra)


def jax_steps(model, mesh, world, g):
    """JAX's train window on a host mesh of ``mesh``'s sizes over
    ``world`` CPU devices: every step's loss and grad norm, and the
    params after the last."""
    from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_window

    jm, tm, _ = model_pair(model, gain=1.0)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**model),
                               compute_dtype="float32",
                               mesh=JaxMeshConfig(**mesh),
                               **dict(TRAIN, g_accum_iters=g))
    jmesh = jax_create_mesh(jcfg.mesh, devices=jax.devices()[:world])
    tx, _ = make_optimizer(jcfg)
    window = make_train_window(jcfg, tx, jmesh, 1)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    xs, ys = batches(g)
    losses, norms = [], []
    for s in range(STEPS):
        jstate, aux = window(jstate, jnp.asarray(xs[s:s + 1]),
                             jnp.asarray(ys[s:s + 1]), jax.random.PRNGKey(0))
        losses.append(float(aux["loss"][0]))
        norms.append(float(aux["grad_norm"][0]))
    return tm, losses, norms, {k: np.asarray(v)
                               for k, v in tree_paths(jstate.params)}


@pytest.mark.parametrize("world,mesh,model_kw,g", CASES, ids=IDS)
def test_pipeline_steps_match_jax(tmp_path, world, mesh, model_kw, g):
    model = dict(MODEL, **model_kw)
    tm, losses, norms, params = jax_steps(model, mesh, world, g)
    out = run_world(str(tmp_path / "pp"), world, "mesh_steps",
                    port_args(tm, mesh, g, model_kw), timeout=180)
    one = run_world(str(tmp_path / "one"), 1, "mesh_steps",
                    port_args(tm, dict(fsdp=1), g, model_kw), timeout=120)[0]
    pp = mesh["pipeline"]
    stages = 0
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        # the first step's hand-offs: a stage after the first receives M
        # activations and sends M gradients, one before the last the other
        # way round
        stage = r // (world // pp)
        rows = TRAIN["batch_size"] // g // mesh.get("fsdp", 1)
        assert got["collectives"]["send_recv"] == 2 * g * microbatches(
            rows, pp) * ((0 < stage) + (stage < pp - 1))
        if got["params"][STEPS] is None:  # a later stage keeps no save
            assert stage > 0
            continue
        stages += 1
        ours = _as_jax_paths(got["params"][STEPS], model)
        assert set(ours) == set(params)
        for k in ours:
            np.testing.assert_allclose(ours[k], params[k], rtol=1e-5,
                                       atol=2e-6, err_msg=f"rank {r} {k}")
    assert stages == world // pp


def test_dropout_at_pipeline2_equals_world1(tmp_path):
    _, tm, _ = model_pair(MODEL, gain=1.0)
    keys = [fold_in(5, s) for s in range(STEPS)]
    kw = dict(dropout=0.2)

    def steps(name, world, mesh, step_keys):
        return run_world(str(tmp_path / name), world, "mesh_steps",
                         port_args(tm, mesh, 1, kw, step_keys=step_keys),
                         timeout=180)

    one = steps("one", 1, dict(fsdp=1), keys)[0]
    pp = steps("pp2", 2, dict(fsdp=1, pipeline=2), keys)
    for r in pp:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                   rtol=1e-6)
    for k, v in one["params"][STEPS].items():
        np.testing.assert_allclose(pp[0]["params"][STEPS][k], v, rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    other = steps("other", 2, dict(fsdp=1, pipeline=2),
                  [k + 1 for k in keys])
    assert other[0]["loss"][0] != pytest.approx(one["loss"][0], rel=1e-6)
