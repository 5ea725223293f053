"""The pipeline axis's checkpoints, tied embeddings and multi-slice
meshes, on the CPU (f32; gloo worlds of spawned ranks,
``torch_dist_util``).

- a save of ``train()`` at ``pipeline=2`` holds full tensors in JAX's
  layout (the single-card shapes: every stage's blocks, the embedding
  and the head come to the first stage) on rank 0 alone, each in a
  storage of its own; resumed at world 1 without a process group its
  first two steps equal single-card steps from the checkpoint's tensors,
  bit for bit;
- a world-1 save loaded at ``pipeline=2 x fsdp=2`` (each rank its
  stage's slice of the tensors, moments and step): its next two steps
  equal single-card steps from the same tensors on the same global
  batches (rtol 1e-5 on losses and params);
- tied embeddings at ``pipeline=2``: the embedding on both ends, its
  gradient summed over the two stages and counted once in the norm;
  five steps against JAX's ``make_train_window`` (rtol 1e-5);
- ``replica=2 x fsdp=2, num_slices=2`` (world 4, JAX's hybrid layout):
  five steps against JAX's train window on the same mesh (rtol 1e-5).
"""

import os

import numpy as np
import torch

from midgpt_tpu_torch.checkpoint import Checkpointer
from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig
from midgpt_tpu_torch.data import Loader, load_shard
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.train import (
    make_lr_schedule,
    make_shadow,
    state_from_model,
    train,
    train_step,
)

from test_torch_mesh import MODEL as MESH_MODEL
from test_torch_mesh import STEPS, _as_jax_paths
from test_torch_mesh_train import MODEL, TRAIN, _data
from test_torch_pipeline_train import jax_steps, port_args
from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)


def _train_mesh(tmp_path, name, data_dir, world, mesh, **train_kw):
    args = dict(model=MODEL, train=dict(TRAIN, **train_kw), mesh=mesh,
                rundir=str(tmp_path / name), data_dir=data_dir)
    return run_world(str(tmp_path / f"world_{name}"), world, "mesh_train",
                     args, timeout=240)


def _single_card_steps(cfg, items, xs, ys, first: int = 0):
    """Single-card steps from a checkpoint's tensors on ``xs, ys``."""
    model = GPT.init(cfg.model, device="cpu")
    model.load_state_dict({k: v.clone() for k, v in items["params"].items()})
    state = state_from_model(model)
    state.load_items(items)
    shadow, sched = make_shadow(model, torch.float32), make_lr_schedule(cfg)
    losses = [float(train_step(state, shadow, torch.as_tensor(x).long(),
                               torch.as_tensor(y).long(), cfg,
                               sched(first + s))[0])
              for s, (x, y) in enumerate(zip(xs, ys))]
    return losses, state


def test_pipeline2_save_resumes_at_world1(tmp_path):
    data_dir = _data(tmp_path)
    short = dict(max_steps=10, eval_interval=5, log_interval=5)
    part = _train_mesh(tmp_path, "part", data_dir, 2,
                       dict(fsdp=1, pipeline=2), **dict(short, max_steps=6))
    assert part[0]["losses"] == part[1]["losses"]
    rundir = str(tmp_path / "part")
    assert Checkpointer(rundir).latest_step() == 5
    items, meta = Checkpointer(rundir).restore()
    assert len(meta["loaders"]) == 2
    assert meta["loaders"][0] == meta["loaders"][1] == meta["loader"]
    cfg = ExperimentConfig(model=ModelConfig(**MODEL), rundir=rundir,
                           data_dir=data_dir, **dict(TRAIN, **short))
    model = GPT.init(cfg.model, device="cpu")
    for key in ("params", "mu", "nu"):  # full tensors, JAX's layout
        assert list(items[key]) == list(model.state_dict())
        assert {k: tuple(v.shape) for k, v in items[key].items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
        for v in items[key].values():
            assert v.untyped_storage().nbytes() == v.numel() * 4
    loader = Loader(load_shard(os.path.join(data_dir, "train.bin")),
                    MODEL["block_size"], (2, 4), cfg.data_seed)
    batches = [loader.peek(step) for step in (6, 7)]
    ref, _ = _single_card_steps(cfg, items, [b[0] for b in batches],
                                [b[1] for b in batches], first=6)
    one = train(cfg)
    assert one["first_step"] == 6 and len(one["losses"]) == 4
    assert one["losses"][:2] == ref


def test_world1_save_loads_at_pipeline2_fsdp2(tmp_path):
    data_dir = _data(tmp_path)
    rundir = str(tmp_path / "one")
    cfg = ExperimentConfig(model=ModelConfig(**MODEL), rundir=rundir,
                           data_dir=data_dir,
                           **dict(TRAIN, max_steps=4, eval_interval=5,
                                  log_interval=5))
    train(cfg)
    items, _ = Checkpointer(rundir).restore()
    assert items["step"] == 4
    rng = np.random.default_rng(11)
    toks = rng.integers(0, MODEL["vocab_size"],
                        (2, 2, 4, MODEL["block_size"] + 1))
    xs, ys = toks[..., :-1], toks[..., 1:]
    args = dict(model=MODEL, train=TRAIN, mesh=dict(fsdp=2, pipeline=2),
                init=items["params"], items=items, xs=xs, ys=ys,
                gather_after=(2,))
    out = run_world(str(tmp_path / "pp"), 4, "mesh_steps", args,
                    timeout=180)
    losses, state = _single_card_steps(cfg, items, xs, ys)
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        if r >= 2:  # the second stage keeps no save
            assert got["params"][2] is None
            continue
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(got["params"][2][k], v.numpy(),
                                       rtol=1e-5, atol=2e-6, err_msg=k)


def _against_jax(tmp_path, world, mesh, model_kw):
    model = dict(MESH_MODEL, **model_kw)
    tm, losses, norms, params = jax_steps(model, mesh, world, 1)
    out = run_world(str(tmp_path), world, "mesh_steps",
                    port_args(tm, mesh, 1, model_kw), timeout=180)
    kept = 0
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
        if got["params"][STEPS] is None:
            continue
        kept += 1
        ours = _as_jax_paths(got["params"][STEPS], model)
        assert set(ours) == set(params)
        for k in ours:
            np.testing.assert_allclose(ours[k], params[k], rtol=1e-5,
                                       atol=2e-6, err_msg=f"rank {r} {k}")
    return out, kept


def test_tied_embedding_at_pipeline2_matches_jax(tmp_path):
    out, kept = _against_jax(tmp_path, 2, dict(fsdp=1, pipeline=2),
                             dict(tie_embeddings=True))
    assert kept == 1
    # the embedding's gradient, summed over its two stages: one
    # all-reduce a step more than untied
    untied = run_world(str(tmp_path / "untied"), 2, "mesh_steps",
                       port_args(model_pair(MESH_MODEL, gain=1.0)[1],
                                 dict(fsdp=1, pipeline=2), 1, {}),
                       timeout=180)
    for r in range(2):
        assert (out[r]["collectives"]["all_reduce"]
                == untied[r]["collectives"]["all_reduce"] + 1)


def test_multislice_replica2_fsdp2_matches_jax(tmp_path):
    out, kept = _against_jax(tmp_path, 4,
                             dict(replica=2, fsdp=2, num_slices=2), {})
    assert kept == 4
