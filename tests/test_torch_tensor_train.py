"""The tensor axis in training against JAX, on the CPU (f32 compute; gloo
worlds of spawned ranks, ``torch_dist_util``).

Five mesh steps of the port's sharded trainer (each rank its tensor
shard of the model: column/row-parallel attention and MLP, a
vocab-parallel embedding, head and loss, and for an MoE ``E / tensor``
experts) against JAX's ``make_train_window`` on a host mesh of the same
sizes, fed the same global batch: losses and grad norms (rtol 1e-5) and
the gathered f32 params in JAX's full layout (rtol 1e-5, atol 2e-6), on
every rank, at ``tensor=2`` (world 2), ``fsdp=2 x tensor=2`` (world 4),
``tensor=4`` (world 4), an MoE at ``tensor=2`` (world 2, JAX's expert
sharding) and ring attention at ``sequence=2 x tensor=2`` (world 4).
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
from midgpt_tpu_torch.config import MeshConfig

from test_torch_mesh import MODEL, STEPS, TRAIN, _as_jax_paths, _batches, _port_args
from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

CASES = [
    (2, dict(fsdp=1, tensor=2), {}),
    (4, dict(fsdp=2, tensor=2), {}),
    (4, dict(fsdp=1, tensor=4), {}),
    (2, dict(fsdp=1, tensor=2), dict(mlp="moe", moe_experts=4)),
    (4, dict(fsdp=1, sequence=2, tensor=2),
     dict(attn_impl="ring", ring_schedule="zigzag")),
]
IDS = ["tensor2", "fsdp2_tensor2", "tensor4", "moe_tensor2",
       "ring_sequence2_tensor2"]


def jax_steps(model, mesh, world):
    """JAX's train window on a host mesh of ``mesh``'s sizes over
    ``world`` CPU devices: every step's loss and grad norm, and the
    params after the last."""
    from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_window

    jm, tm, _ = model_pair(model, gain=1.0)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**model),
                               compute_dtype="float32",
                               mesh=JaxMeshConfig(**mesh), **TRAIN)
    jmesh = jax_create_mesh(jcfg.mesh, devices=jax.devices()[:world])
    tx, _ = make_optimizer(jcfg)
    window = make_train_window(jcfg, tx, jmesh, 1)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    xs, ys = _batches()
    losses, norms = [], []
    for s in range(STEPS):
        jstate, aux = window(jstate, jnp.asarray(xs[s:s + 1]),
                             jnp.asarray(ys[s:s + 1]), jax.random.PRNGKey(0))
        losses.append(float(aux["loss"][0]))
        norms.append(float(aux["grad_norm"][0]))
    return tm, losses, norms, {k: np.asarray(v)
                               for k, v in tree_paths(jstate.params)}


@pytest.mark.parametrize("world,mesh,model_kw", CASES, ids=IDS)
def test_tensor_steps_match_jax(tmp_path, world, mesh, model_kw):
    model = dict(MODEL, **model_kw)
    tm, losses, norms, params = jax_steps(model, mesh, world)
    out = run_world(str(tmp_path), world, "mesh_steps",
                    _port_args(tm, mesh, **model_kw), timeout=180)
    sizes = MeshConfig(**mesh).sizes(world)
    fsdp, tpn = sizes[2], sizes[4]
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
        lo, hi, n_master, n_mu, n_nu, padded = got["shard"]
        # this rank's 1 / fsdp of its tensor shard's masters and moments
        assert n_master == n_mu == n_nu == padded // fsdp == hi - lo
        ours = _as_jax_paths(got["params"][STEPS], model)
        assert set(ours) == set(params)
        for k in ours:
            np.testing.assert_allclose(ours[k], params[k], rtol=1e-5,
                                       atol=2e-6, err_msg=f"rank {r} {k}")
    # a tensor shard holds about 1 / tensor of the parameters
    whole = sum(v.size for v in params.values())
    assert out[0]["shard"][5] < whole / tpn * 1.25
