"""The sequence axis in training, on the CPU (f32 compute; gloo worlds of
spawned ranks, ``torch_dist_util``).

- five mesh steps at ``sequence=2`` (world 2) for ring standard, zigzag
  and Ulysses: losses, grad norms (rtol 1e-5) and the gathered f32
  params (rtol 1e-5, atol 2e-6) against JAX's ``make_train_window`` on a
  host mesh of the same sizes fed the same global batch, each rank
  holding the same rows and its ``T / 2`` columns (the helper
  :func:`check_mesh_steps` also serves ``tests/test_torch_sequence_mesh.py``
  and ``tests/test_torch_sequence_four.py``);
- the residual mask of a ``[B, T/S, D]`` slice equals the whole rows'
  at its columns, bit for bit;
- sequence peers read the same rows (their loaders are the same data
  shard's) and split their columns;
- ``"auto"`` resolves to ring under ``sequence > 1``; flash, naive and
  fused raise naming ring and Ulysses; the card's route and activation
  count follow;
- an MoE model under ``sequence > 1`` raises ``NotImplementedError``;
- the launcher's ``--set mesh.sequence=N model.attn_impl=ring`` reaches
  the config unchanged, the ``-1`` rule filling ``fsdp``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig as JaxMeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, ModelConfig
from midgpt_tpu_torch.data import Loader, load_shard, write_tokens
from midgpt_tpu_torch.models.gpt import GPT, sequence_impl
from midgpt_tpu_torch.models.layers import dropout, fold_in
from midgpt_tpu_torch.parallel import GroupExchange, seq_cols
from midgpt_tpu_torch.parallel.mesh import Mesh
from midgpt_tpu_torch.train import (
    activation_bytes,
    card_route,
    check_sequence,
)

from test_torch_mesh import MODEL, STEPS, TRAIN, _as_jax_paths, _batches, _port_args
from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

IMPLS = [("ring", "standard"), ("ring", "zigzag"), ("ulysses", "zigzag")]
IMPL_IDS = ["ring_standard", "ring_zigzag", "ulysses"]


def check_mesh_steps(tmp_path, world, mesh, impl, schedule):
    """The port's mesh steps (``torch_dist_util.mesh_steps``) against
    JAX's train window on a host mesh of the same sizes."""
    from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_window

    model = dict(MODEL, attn_impl=impl, ring_schedule=schedule)
    jm, tm, _ = model_pair(model, gain=1.0)
    out = run_world(str(tmp_path), world, "mesh_steps",
                    _port_args(tm, mesh, attn_impl=impl,
                               ring_schedule=schedule), timeout=180)
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
    params = {k: np.asarray(v) for k, v in tree_paths(jstate.params)}
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
        ours = _as_jax_paths(got["params"][STEPS], model)
        assert set(ours) == set(params)
        for k in ours:
            np.testing.assert_allclose(ours[k], params[k], rtol=1e-5,
                                       atol=2e-6, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("impl,schedule", IMPLS, ids=IMPL_IDS)
def test_sequence2_steps_match_jax(tmp_path, impl, schedule):
    check_mesh_steps(tmp_path, 2, dict(fsdp=1, sequence=2), impl, schedule)


@pytest.mark.parametrize("s,i", [(2, 0), (2, 1), (4, 3)])
def test_t_slice_residual_mask_equals_the_whole_rows(s, i):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 16, 8, generator=g)
    key = torch.tensor(fold_in(3, 1), dtype=torch.int64)
    whole = dropout(x, 0.3, key, row_offset=2)
    tl = 16 // s
    cols = slice(i * tl, (i + 1) * tl)
    got = dropout(x[:, cols].contiguous(), 0.3, key, row_offset=2,
                  seq=(i, s))
    np.testing.assert_array_equal(got.numpy(), whole[:, cols].numpy())
    assert not torch.equal(got, dropout(x[:, cols].contiguous(), 0.3, key,
                                        row_offset=2))


def test_sequence_peers_read_the_same_rows(tmp_path):
    path = str(tmp_path / "train.bin")
    write_tokens(path, np.random.default_rng(3).integers(0, 500, 50_003))
    sizes = MeshConfig(fsdp=2, sequence=2).sizes(4)
    meshes = [Mesh(rank=r, world=4, sizes=sizes) for r in range(4)]
    batches = {}
    for m in meshes:
        loader = Loader(load_shard(path, m.data_index, m.data_shards), 32,
                        (2, 3), seed=7, process_index=m.data_index)
        batches[m.rank] = loader.next()[0]
        assert seq_cols(32, m) == slice(16 * m.seq_index,
                                        16 * (m.seq_index + 1))
    for m in meshes:
        peer = m.seq_ranks[1 - m.seq_index]
        assert meshes[peer].data_index == m.data_index
        np.testing.assert_array_equal(batches[m.rank], batches[peer])
    assert not np.array_equal(batches[0], batches[meshes[0].seq_next ^ 3])
    with pytest.raises(ValueError, match="not divisible by sequence"):
        seq_cols(33, meshes[0])


def test_auto_takes_ring_and_whole_t_impls_raise():
    assert sequence_impl("auto", 2) == "ring"
    assert sequence_impl("ulysses", 4) == "ulysses"
    assert sequence_impl("flash", 1) == "flash"
    for impl in ("flash", "naive", "fused"):
        with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
            sequence_impl(impl, 2)
    cfg = ModelConfig(**dict(MODEL, attn_impl="flash"))
    model = GPT.init(cfg, device="cpu")
    model.set_batch_offset(0, GroupExchange(None, 0, 2, [0, 1]))
    with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
        model.hidden(torch.zeros(2, 16, dtype=torch.long))
    with pytest.raises(ValueError, match="block_size"):
        model.hidden(torch.zeros(2, 17, dtype=torch.long))  # 34 > 32
    # the card's route and the activations a rank keeps
    seq2 = Mesh(rank=0, world=2, sizes=(1, 1, 1, 2, 1), distributed=True)
    one = Mesh(rank=0, world=1, sizes=(1,) * 5, distributed=True)
    auto = ModelConfig(**dict(MODEL, attn_impl="auto"))
    assert card_route(auto, 2) == "ring" and card_route(auto) == "flash"
    for impl in ("ring", "ulysses"):
        assert sequence_impl(impl, 1) == "flash"
        assert card_route(ModelConfig(**dict(MODEL, attn_impl=impl))) == (
            "flash")
    naive = ExperimentConfig(model=ModelConfig(**MODEL), **TRAIN)
    for bad in (lambda: card_route(naive.model, 2),
                lambda: check_sequence(naive, seq2)):
        with pytest.raises(ValueError, match="'ring' or 'ulysses'"):
            bad()
    exp = ExperimentConfig(model=ModelConfig(**dict(MODEL,
                                                    attn_impl="ring")),
                           **TRAIN)
    half, whole = (activation_bytes(exp, "none", mesh=m)["saved"]
                   for m in (seq2, one))
    assert half < whole


def test_moe_under_sequence_raises():
    moe = dict(MODEL, mlp="moe", moe_experts=4)
    cfg = ExperimentConfig(model=ModelConfig(**moe), **TRAIN)
    seq2 = Mesh(rank=0, world=2, sizes=(1, 1, 1, 2, 1), distributed=True)
    with pytest.raises(NotImplementedError, match="MoE x sequence"):
        check_sequence(cfg, seq2)
    check_sequence(cfg, Mesh(rank=0, world=2, sizes=(1, 1, 2, 1, 1)))
    model = GPT.init(cfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE x sequence"):
        model.set_batch_offset(0, GroupExchange(None, 0, 2, [0, 1]))
    dense = dataclasses.replace(cfg, model=ModelConfig(**MODEL))
    with pytest.raises(ValueError, match="not divisible by sequence"):
        check_sequence(dense, Mesh(rank=0, world=3, sizes=(1, 1, 1, 3, 1)))


def test_launch_overrides_reach_the_mesh_and_model():
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.launch import apply_overrides

    cfg = apply_overrides(get_config("openwebtext"),
                          ["mesh.fsdp=1", "mesh.sequence=4",
                           "model.attn_impl=ring",
                           'model.ring_schedule="standard"'])
    assert (cfg.model.attn_impl, cfg.model.ring_schedule) == ("ring",
                                                              "standard")
    assert cfg.mesh.sizes(4) == (1, 1, 1, 4, 1)
    cfg = apply_overrides(get_config("openwebtext"), ["mesh.sequence=2"])
    assert cfg.mesh.sizes(8) == (1, 1, 4, 2, 1)  # fsdp=-1 takes the rest
