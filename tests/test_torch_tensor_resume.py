"""The tensor axis's dropout and checkpoints, on the CPU (gloo worlds of
spawned ranks, ``torch_dist_util``).

- dropout 0.1 at ``tensor=2`` (naive and flash attention): five steps
  against a world of one on the same global batches and step keys (rtol
  1e-5 on losses, grad norms and params at f32): each local head's
  attention mask is keyed by its global head index, the residual and
  embedding masks by global row (identical on tensor peers), so only
  the sums' order differs;
- a save's items are host tensors on rank 0 alone, each in a storage of
  its own (no view of a gathered whole-model buffer);
- a save of ``train()`` at ``tensor=2`` holds full tensors in JAX's
  layout (the single-card shapes) and both ranks' loader states, equal
  (tensor peers read the same rows); resumed at world 1 without a
  process group its first two steps equal single-card steps from the
  checkpoint's tensors, bit for bit; loaded at ``fsdp=2`` (each rank
  its slice of the tensors, moments and step) its next two steps equal
  single-card steps from the same tensors on the same global batches
  (rtol 1e-5 on losses and params).
"""

import os

import numpy as np
import pytest
import torch

from midgpt_tpu_torch.checkpoint import Checkpointer
from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig
from midgpt_tpu_torch.data import Loader, load_shard
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.models.layers import fold_in
from midgpt_tpu_torch.train import (
    make_lr_schedule,
    make_shadow,
    state_from_model,
    train,
    train_step,
)

from test_torch_mesh import MODEL as MESH_MODEL
from test_torch_mesh import STEPS, _port_args
from test_torch_mesh_train import MODEL, TRAIN, _data
from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_dropout_at_tensor2_equals_world1(tmp_path, impl):
    _, tm, _ = model_pair(MESH_MODEL, gain=1.0)
    keys = [fold_in(5, s) for s in range(STEPS)]

    def steps(name, world, mesh):
        args = dict(_port_args(tm, mesh, dropout=0.1, attn_impl=impl),
                    step_keys=keys)
        return run_world(str(tmp_path / name), world, "mesh_steps", args,
                         timeout=180)

    one = steps("one", 1, dict(fsdp=1))[0]
    for r in steps("tp2", 2, dict(fsdp=1, tensor=2)):
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                   rtol=1e-5)
        for k, v in one["params"][STEPS].items():
            np.testing.assert_allclose(r["params"][STEPS][k], v, rtol=1e-5,
                                       atol=2e-6, err_msg=k)


@pytest.mark.parametrize("world,mesh", [
    (2, dict(fsdp=1, tensor=2)), (4, dict(fsdp=2, tensor=2))],
    ids=["tensor2", "fsdp2_tensor2"])
def test_saved_items_are_host_tensors_of_their_own(tmp_path, world, mesh):
    """A save's items (``ShardedState.items``) are full tensors in host
    memory on rank 0 alone, each in a storage of its own: none is a view
    of a gathered whole-model buffer, which would keep that buffer
    alive."""
    _, tm, _ = model_pair(MESH_MODEL, gain=1.0)
    out = run_world(str(tmp_path), world, "save_items",
                    _port_args(tm, mesh), timeout=180)
    assert all(r is None for r in out[1:])
    got = out[0]
    assert got["devices"] == ["cpu"] and got["own_storage"]
    assert got["storages"] == got["tensors"] and got["step"] == 0
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(got["params"][k], v.numpy(),
                                      err_msg=k)
        assert not got["mu"][k].any()


def _train_mesh(tmp_path, name, data_dir, world, mesh, **train_kw):
    args = dict(model=MODEL, train=dict(TRAIN, **train_kw), mesh=mesh,
                rundir=str(tmp_path / name), data_dir=data_dir)
    return run_world(str(tmp_path / f"world_{name}"), world, "mesh_train",
                     args, timeout=240)


def test_tensor2_save_resumes_at_world1_and_fsdp2(tmp_path):
    data_dir = _data(tmp_path)
    short = dict(max_steps=10, eval_interval=5, log_interval=5)
    part = _train_mesh(tmp_path, "part", data_dir, 2,
                       dict(fsdp=1, tensor=2), **dict(short, max_steps=6))
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
        assert {k: tuple(v.shape) for k, v in items[key].items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}

    # world 1, no process group: the saved state, then its own batches
    model.load_state_dict({k: v.clone() for k, v in items["params"].items()})
    state = state_from_model(model)
    state.load_items(items)
    loader = Loader(load_shard(os.path.join(data_dir, "train.bin")),
                    MODEL["block_size"], (2, 4), cfg.data_seed)
    shadow, sched = make_shadow(model, torch.float32), make_lr_schedule(cfg)
    ref = []
    for step in (6, 7):  # the second loss reads the restored moments
        x, y = (torch.from_numpy(a).long() for a in loader.peek(step))
        ref.append(float(train_step(state, shadow, x, y, cfg,
                                    sched(step))[0]))
    one = train(cfg)
    assert one["first_step"] == 6 and len(one["losses"]) == 4
    assert one["losses"][:2] == ref

    # fsdp=2: the checkpoint's tensors, moments and step cut into slices;
    # two steps on global batches against single-card steps from them
    rng = np.random.default_rng(11)
    toks = rng.integers(0, MODEL["vocab_size"],
                        (2, 2, 4, MODEL["block_size"] + 1))
    xs, ys = toks[..., :-1], toks[..., 1:]
    args = dict(model=MODEL, train=TRAIN, mesh=dict(fsdp=2),
                init=items["params"], items=items, xs=xs, ys=ys,
                gather_after=(2,))
    fsdp = run_world(str(tmp_path / "fsdp"), 2, "mesh_steps", args,
                     timeout=180)
    model = GPT.init(cfg.model, device="cpu")
    model.load_state_dict({k: v.clone() for k, v in items["params"].items()})
    state = state_from_model(model)
    state.load_items(items)
    shadow = make_shadow(model, torch.float32)
    losses = [float(train_step(state, shadow, torch.from_numpy(xs[s]),
                               torch.from_numpy(ys[s]), cfg, sched(s))[0])
              for s in range(2)]
    for r in fsdp:
        np.testing.assert_allclose(r["loss"], losses, rtol=1e-5)
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(r["params"][2][k], v.numpy(),
                                       rtol=1e-5, atol=2e-6, err_msg=k)
