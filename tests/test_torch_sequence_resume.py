"""The sequence axis's dropout and checkpoints, on the CPU (gloo worlds
of spawned ranks, ``torch_dist_util``).

- dropout 0.1 at ``sequence=2``, ring and Ulysses: five steps against a
  world of one with flash attention on the same global batches and
  step keys (rtol 1e-5 on losses, grad norms and params at f32): every
  attention, residual and embedding mask is keyed by global row, column
  and head, so only the sums' order differs;
- a save of ``train()`` at ``sequence=2`` (ring) holds full tensors by
  name and both ranks' loader states, equal (sequence peers read the
  same rows); resumed at world 1 without a process group it restores
  that state (its first two steps equal single-card steps from the
  checkpoint's tensors, bit for bit); a world-1 save resumed at
  ``sequence=2`` continues the run (losses within rtol 1e-5 of the
  uninterrupted world-1 run's).
"""

import dataclasses
import os
import shutil

import numpy as np
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


def test_dropout_at_sequence2_equals_world1(tmp_path):
    _, tm, _ = model_pair(MESH_MODEL, gain=1.0)
    keys = [fold_in(5, s) for s in range(STEPS)]

    def steps(name, world, mesh, impl):
        args = dict(_port_args(tm, mesh, dropout=0.1, attn_impl=impl),
                    step_keys=keys)
        return run_world(str(tmp_path / name), world, "mesh_steps", args,
                         timeout=180)

    one = steps("one", 1, dict(fsdp=1), "flash")[0]
    for impl in ("ring", "ulysses"):
        for r in steps(impl, 2, dict(fsdp=1, sequence=2), impl):
            np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
            np.testing.assert_allclose(r["grad_norm"], one["grad_norm"],
                                       rtol=1e-5)
            for k, v in one["params"][STEPS].items():
                np.testing.assert_allclose(r["params"][STEPS][k], v,
                                           rtol=1e-5, atol=2e-6,
                                           err_msg=f"{impl} {k}")


def _train_seq(tmp_path, name, data_dir, world, **train_kw):
    args = dict(model=dict(MODEL, attn_impl="ring"),
                train=dict(TRAIN, **train_kw),
                mesh=dict(fsdp=1, sequence=world), rundir=str(tmp_path / name),
                data_dir=data_dir)
    return run_world(str(tmp_path / f"world_{name}"), world, "mesh_train",
                     args, timeout=240)


def test_sequence2_save_resumes_at_world1_and_back(tmp_path):
    data_dir = _data(tmp_path)
    short = dict(max_steps=10, eval_interval=5, log_interval=5)
    part = _train_seq(tmp_path, "part", data_dir, 2,
                      **dict(short, max_steps=6))
    assert part[0]["losses"] == part[1]["losses"]
    rundir = str(tmp_path / "part")
    assert Checkpointer(rundir).latest_step() == 5
    items, meta = Checkpointer(rundir).restore()
    assert len(meta["loaders"]) == 2
    assert meta["loaders"][0] == meta["loaders"][1] == meta["loader"]
    assert meta["loader"]["step"] == 6

    # world 1, no process group: the saved state, then its own batches
    cfg = ExperimentConfig(model=ModelConfig(**dict(MODEL, attn_impl="ring")),
                           rundir=rundir, data_dir=data_dir,
                           **dict(TRAIN, **short))
    model = GPT.init(cfg.model, device="cpu")
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

    # and back: a world-1 save at step 5 resumed at sequence=2
    back = str(tmp_path / "back")
    whole = train(dataclasses.replace(cfg, rundir=back))
    shutil.rmtree(back)
    first = train(dataclasses.replace(cfg, rundir=back, max_steps=6))
    assert len(first["losses"]) == 6
    resumed = _train_seq(tmp_path, "back", data_dir, 2, **short)
    for r in resumed:
        assert r["first_step"] == 6
        np.testing.assert_allclose(r["losses"], whole["losses"][6:],
                                   rtol=1e-5)
