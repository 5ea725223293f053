"""The port's ``train()`` under a process group, on the CPU (worlds of 1
and 2 spawned ranks over gloo, ``torch_dist_util``; f32 compute).

- two ranks of the port against the JAX package's two-process run of
  ``tests/test_distributed.py`` (its worker and config, at f32 compute),
  from the same init: every logged loss (train and val evals at steps 0
  and 10, the optimized loss at 5, 10 and 15) and the final val loss
  within rtol 1e-5, the same on both ranks, and the last step saved;
- a world-2 save (step 5) resumed at world 2 gives the uninterrupted
  run's losses bit for bit, and resumed at world 1 (no process group)
  restores the saved state: its first two steps equal single-card steps
  from the checkpoint's tensors on the world-1 batches, bit for bit;
- ``steps_per_dispatch=2`` at world 2 gives the K=1 losses bit for bit;
- SIGTERM to one rank: both ranks stop at that step, and it is saved;
- ``torch.distributed.run --nproc_per_node=2 -m midgpt_tpu_torch.launch
  --multihost`` on the CPU: rank 0 writes ``config.json`` and the
  metrics, the last step is saved; ``--multihost`` without ``--rundir``
  raises.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax
import numpy as np
import torch

from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.models.gpt import GPT as JaxGPT
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.checkpoint import Checkpointer
from midgpt_tpu_torch.config import ExperimentConfig, ModelConfig
from midgpt_tpu_torch.convert import gpt_from_jax_params
from midgpt_tpu_torch.data import Loader, load_shard, write_tokens
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.train import (
    make_lr_schedule,
    make_shadow,
    state_from_model,
    train,
    train_step,
)
from midgpt_tpu_torch.utils.metrics import read_metrics

from torch_dist_util import run_world

torch.set_num_threads(2)

# tests/test_distributed.py's two-process config
MODEL = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=64,
             dropout=0.0, attn_impl="naive", remat="none")
TRAIN = dict(learning_rate=1e-2, min_lr=1e-3, warmup_steps=5,
             lr_decay_steps=20, max_steps=20, batch_size=8, g_accum_iters=2,
             eval_interval=10, eval_batches=2, log_interval=5,
             compute_dtype="float32", device="cpu")


def _data(tmp_path) -> str:
    """test_distributed's token files."""
    data_dir = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    base = np.tile(np.arange(64), 2000)
    toks = np.where(rng.random(base.shape) < 0.05,
                    rng.integers(0, 64, size=base.shape), base)
    write_tokens(os.path.join(data_dir, "train.bin"), toks)
    write_tokens(os.path.join(data_dir, "val.bin"), toks[:20_000])
    return data_dir


def _train_world(tmp_path, name, world, data_dir, **kw):
    args = dict(model=MODEL, train=dict(TRAIN, **kw.pop("train", {})),
                mesh=dict(fsdp=-1), rundir=str(tmp_path / name),
                data_dir=data_dir, **kw)
    return run_world(str(tmp_path / f"world_{name}"), world, "mesh_train",
                     args, timeout=240)


def _logged(rundir):
    return {(r["step"], k): v for r in read_metrics(rundir)
            for k, v in r.items() if k.startswith("loss")}


def test_two_ranks_match_jax_two_process_run(tmp_path):
    from test_distributed import _TRAIN_WORKER, _run_workers

    data_dir = _data(tmp_path)
    worker = _TRAIN_WORKER.replace(
        "    batch_size=8, g_accum_iters=2,",
        '    batch_size=8, g_accum_iters=2, compute_dtype="float32",')
    assert worker != _TRAIN_WORKER
    path = str(tmp_path / "jax_worker.py")
    with open(path, "w") as f:
        f.write(worker)
    jax_rundirs = []

    def tail(attempt):
        jax_rundirs.append(str(tmp_path / f"jax_run{attempt}"))
        return [jax_rundirs[-1], data_dir]

    _run_workers(path, tail)
    ref = _logged(jax_rundirs[-1])
    assert len(ref) == 8, ref

    # the same init: JAX's GPT.init(PRNGKey(seed)) in the port's layout
    jm = JaxGPT.init(jax.random.PRNGKey(0), JaxModelConfig(**MODEL))
    init = gpt_from_jax_params({p: np.asarray(v) for p, v in tree_paths(jm)},
                               ModelConfig(**MODEL), device="cpu").state_dict()
    out = _train_world(tmp_path, "port", 2, data_dir, init=init)
    got = _logged(str(tmp_path / "port"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=str(k))
    assert out[0]["losses"] == out[1]["losses"]
    assert out[0]["val_loss"] == out[1]["val_loss"]
    assert len(out[0]["losses"]) == 20
    assert Checkpointer(str(tmp_path / "port")).latest_step() == 19


def test_world2_save_resumes_at_world2_and_world1(tmp_path):
    data_dir = _data(tmp_path)
    short = dict(max_steps=12, eval_interval=6, log_interval=3)
    whole = _train_world(tmp_path, "whole", 2, data_dir, train=short)[0]
    part = _train_world(tmp_path, "part", 2, data_dir,
                        train=dict(short, max_steps=6))[0]
    assert part["losses"] == whole["losses"][:6]
    assert Checkpointer(str(tmp_path / "part")).latest_step() == 5
    shutil.copytree(tmp_path / "part", tmp_path / "part_w1")

    resumed = _train_world(tmp_path, "part", 2, data_dir, train=short)[0]
    assert resumed["first_step"] == 6
    assert resumed["losses"] == whole["losses"][6:]
    assert resumed["val_loss"] == whole["val_loss"]

    # world 1, no process group: the saved state, then its own batches
    cfg = ExperimentConfig(model=ModelConfig(**MODEL),
                           rundir=str(tmp_path / "part_w1"),
                           data_dir=data_dir, **dict(TRAIN, **short))
    items, meta = Checkpointer(cfg.rundir).restore()
    assert len(meta["loaders"]) == 2 and meta["loader"]["step"] == 6
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
    assert one["first_step"] == 6 and len(one["losses"]) == 6
    assert one["losses"][:2] == ref


def test_window_of_two_equals_k1_under_a_mesh(tmp_path):
    data_dir = _data(tmp_path)
    short = dict(max_steps=8, eval_interval=4, log_interval=2)
    k1 = _train_world(tmp_path, "k1", 2, data_dir, train=short)[0]
    k2 = _train_world(tmp_path, "k2", 2, data_dir,
                      train=dict(short, steps_per_dispatch=2))[0]
    assert k2["losses"] == k1["losses"]
    assert k2["train_dispatches"] == 4 and k1["train_dispatches"] == 8
    assert k2["val_loss"] == k1["val_loss"]


def test_sigterm_to_one_rank_stops_both_at_the_same_step(tmp_path):
    data_dir = _data(tmp_path)
    out = _train_world(tmp_path, "term", 2, data_dir, sigterm_at=(1, 7))
    assert [o["interrupted_at"] for o in out] == [7, 7]
    assert [len(o["losses"]) for o in out] == [8, 8]
    ckpt = Checkpointer(str(tmp_path / "term"))
    assert ckpt.latest_step() == 7
    with open(os.path.join(str(tmp_path / "term"), "metrics.jsonl")) as f:
        assert json.loads(f.readline())["config"]["max_steps"] == 20
    again = _train_world(tmp_path, "term", 2, data_dir,
                         train=dict(max_steps=10))
    assert [o["first_step"] for o in again] == [8, 8]


def test_multihost_launch_on_the_cpu(tmp_path):
    from midgpt_tpu_torch.launch import main

    data_dir = _data(tmp_path)
    rundir = str(tmp_path / "run")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "midgpt_tpu_torch.launch",
           "--multihost", "--config", "tiny", "--rundir", rundir, "--set",
           "device=cpu", f"data_dir={data_dir}", "max_steps=4",
           "eval_interval=2", "eval_batches=1", "log_interval=1",
           "mesh.fsdp=-1", "model.block_size=32", "model.vocab_size=64"]
    proc = subprocess.run(cmd, env=env, cwd=str(tmp_path), text=True,
                          capture_output=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("final:") == 1  # rank 0 alone prints it
    with open(os.path.join(rundir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["mesh"]["fsdp"] == -1 and cfg["device"] == "cpu"
    rows = read_metrics(rundir)
    assert [r["step"] for r in rows if "loss/optimized" in r] == [1, 2, 3]
    assert Checkpointer(rundir).latest_step() == 3
    with pytest.raises(ValueError, match="--rundir"):
        main(["--multihost", "--config", "tiny", "--set", "device=cpu"])
