"""Worlds of the port's processes over gloo, for the mesh tests.

:func:`run_world` starts ``world`` processes of this module, each a rank
of a gloo process group whose rendezvous is a ``file://`` store in the
test's own directory, new for every world (no port to race for, and no
stale rendezvous when a directory serves two worlds). Each rank sets one thread,
runs one of the worker functions below on the pickled arguments and
saves what it returns; the parent waits with a timeout, kills the world
if it runs over, and raises with every rank's output if a rank fails.
This module imports no JAX: the workers run the port alone.
"""

from __future__ import annotations

import os
import pickle
import signal
import subprocess
import sys
import typing as tp
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_world(workdir: str, world: int, fn: str, args: tp.Any,
              timeout: float = 240.0,
              env: tp.Optional[tp.Dict[str, str]] = None) -> tp.List[tp.Any]:
    """``fn(args)``'s result on every rank of a world of ``world``
    processes, in rank order."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, HERE, full_env.get("PYTHONPATH", "")])
    full_env.update(env or {})
    store = os.path.join(workdir, f"store_{uuid.uuid4().hex}")
    for r in range(world):
        result = os.path.join(workdir, f"result_{r}.pkl")
        if os.path.exists(result):
            os.remove(result)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fn, str(r), str(world),
         workdir, store],
        env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=workdir) for r in range(world)]
    outs: tp.List[str] = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise AssertionError("world timed out:\n" + "\n".join(
            f"-- rank {r} --\n{o[-3000:]}" for r, o in enumerate(outs)))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("\n".join(
            f"-- rank {r} rc={p.returncode} --\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"result_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module: the
    checks it shares with the tests (``tensor_all_reduces``,
    ``tensor_bf16_factor``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- workers (run in the spawned ranks) ---------------------------------------


def _np(x):
    import numpy as np

    return {k: np.asarray(v.detach().cpu()) for k, v in x.items()}


def mesh_layout(args):
    """This rank's grid coordinates, data shard and axis groups."""
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(MeshConfig(**args["mesh"]))
    groups = {a: (None if g is None else dist.get_process_group_ranks(g))
              for a, g in (("tensor", mesh.tensor_group),
                           ("param", mesh.param_group),
                           ("pipeline", mesh.pipeline_group),
                           ("embed", mesh.embed_group))}
    return {"rank": mesh.rank, "coords": mesh.coords, "sizes": mesh.sizes,
            "data_index": mesh.data_index, **groups,
            "tp_index": mesh.tp_index, "tp_size": mesh.tp_size,
            "fsdp": dist.get_process_group_ranks(mesh.fsdp_group),
            "replica": dist.get_process_group_ranks(mesh.replica_group),
            "sequence": dist.get_process_group_ranks(mesh.sequence_group),
            "grad": dist.get_process_group_ranks(mesh.grad_group),
            "seq_index": mesh.seq_index, "seq_size": mesh.seq_size,
            "seq_next": mesh.seq_next, "seq_prev": mesh.seq_prev,
            "pp_index": mesh.pp_index, "pp_size": mesh.pp_size,
            "pp_prev": mesh.pp_prev, "pp_next": mesh.pp_next}


def seq_attention(args):
    """Ring or Ulysses attention of this rank's chunk of the given whole-T
    q, k, v over the mesh's sequence group (a process-group exchange):
    its output chunk and the gradients of ``sum(out * dout)`` with
    respect to its q, k, v chunks, and the collectives it counted."""
    import torch

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel import sharding
    from midgpt_tpu_torch.parallel.exchange import GroupExchange
    from midgpt_tpu_torch.parallel.mesh import create_mesh
    from midgpt_tpu_torch.parallel.ring import ring_attention
    from midgpt_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = create_mesh(MeshConfig(**args["mesh"]))
    ex = GroupExchange.from_mesh(mesh)
    cols = sharding.seq_cols(args["q"].shape[2], mesh)
    q, k, v, dout = (torch.from_numpy(args[n][:, :, cols]).clone()
                     for n in ("q", "k", "v", "dout"))
    for x in (q, k, v):
        x.requires_grad_(True)
    before = sharding.collective_launches()
    kw = args.get("kw", {})
    if args["impl"] == "ulysses":
        out = ulysses_attention(q, k, v, ex, **kw)
    else:
        out = ring_attention(q, k, v, ex, **kw)
    dq, dk, dv = torch.autograd.grad((out * dout).sum(), (q, k, v))
    after = sharding.collective_launches()
    return {"out": out.detach().numpy(), "dq": dq.numpy(),
            "dk": dk.numpy(), "dv": dv.numpy(),
            "collectives": {n: after[n] - before[n] for n in after}}


def pipe_toy(args):
    """JAX's tanh toy (``tests/test_pipeline.py``) as GPipe stages over
    the world's pipeline group: this rank's stage holds its ``L / S``
    layers of the given ``w [L, D, D]``, ``b [L, D]``. The forward's
    outputs ``[M, BM, D]`` (the last stage's), then the gradients of
    ``sum(sin(out))`` with respect to this stage's ``w`` and ``b`` (and
    on the first stage ``x``), and the hand-offs counted."""
    import torch

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel import sharding
    from midgpt_tpu_torch.parallel.mesh import create_mesh
    from midgpt_tpu_torch.parallel.pipeline import (
        GroupPipe,
        pipeline_run,
        stage_layers,
    )

    mesh = create_mesh(MeshConfig(fsdp=1, pipeline=-1))
    ex = GroupPipe.from_mesh(mesh)
    s, size = mesh.pp_index, mesh.pp_size
    layers = stage_layers(args["w"].shape[0], size, s)
    w = torch.from_numpy(args["w"][layers.start:layers.stop]).requires_grad_()
    b = torch.from_numpy(args["b"][layers.start:layers.stop]).requires_grad_()
    x = torch.from_numpy(args["x"]).requires_grad_(True)
    m, bm, d = x.shape

    def stage_fn(head):
        def fn(st, h, mb):
            for i in range(len(layers)):
                h = torch.tanh(h @ w[i] + b[i])
            return torch.sin(h).sum() if head and st == size - 1 else h
        return fn

    before = sharding.collective_launches()["send_recv"]
    out = pipeline_run(ex, m, stage_fn(False), lambda i: x[i], (bm, d),
                       torch.float32, "cpu", train=False)
    pipeline_run(ex, m, stage_fn(True), lambda i: x[i], (bm, d),
                 torch.float32, "cpu", train=True)
    return {"stage": s, "layers": (layers.start, layers.stop),
            "out": torch.stack(out).detach().numpy() if out else None,
            "gw": w.grad.numpy(), "gb": b.grad.numpy(),
            "gx": None if s else x.grad.numpy(),
            "send_recv": sharding.collective_launches()["send_recv"] - before}


def tensor_ops(args):
    """Megatron's two operators over the world's tensor group: ``y =
    g(f(x) @ w[rank])`` and the gradients of ``sum(y * dout)`` with
    respect to x and this rank's ``w``, and the collectives counted."""
    import torch

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel import sharding
    from midgpt_tpu_torch.parallel.mesh import create_mesh
    from midgpt_tpu_torch.parallel.tensor import (
        GroupTensorExchange,
        copy_to_tensor,
        reduce_from_tensor,
    )

    mesh = create_mesh(MeshConfig(fsdp=1, tensor=-1))
    ex = GroupTensorExchange.from_mesh(mesh)
    x = torch.from_numpy(args["x"]).requires_grad_(True)
    w = torch.from_numpy(args["w"][mesh.tp_index]).requires_grad_(True)
    before = sharding.collective_launches()
    y = reduce_from_tensor([copy_to_tensor(x, ex) @ w], ex)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(args["dout"])).sum(),
                                 (x, w))
    after = sharding.collective_launches()
    return {"y": y.detach().numpy(), "dx": dx.numpy(), "dw": dw.numpy(),
            "collectives": {n: after[n] - before[n] for n in after
                            if after[n] != before[n]}}


def serve_group(args):
    """The serving engine on this rank of a tensor-only mesh over the
    world (``parallel.mesh.group_mesh``: a ``GroupTensorExchange``): the
    full model built from the given JAX parameters, its shard cut here.
    Every case's greedy streams; the combiner's argmax of the given
    logits (each rank holding its vocabulary shard); and a deadline
    trace on a clock whose reading differs by rank (rank r's advances
    ``1 + r`` per read): which requests were shed and the others'
    tokens; and on that clock, with telemetry on, the shortest of the
    dispatch spans (each read on this rank's own clock)."""
    import numpy as np
    import torch

    from midgpt_tpu_torch.config import MeshConfig, ModelConfig
    from midgpt_tpu_torch.convert import gpt_from_jax_params
    from midgpt_tpu_torch.parallel import sharding
    from midgpt_tpu_torch.parallel.mesh import create_mesh, group_mesh
    from midgpt_tpu_torch.parallel.tensor import greedy_argmax
    from midgpt_tpu_torch.serving import ServingEngine

    mesh = create_mesh(MeshConfig(fsdp=1, tensor=-1))
    sm = group_mesh(mesh, "cpu")
    model = gpt_from_jax_params(args["params"], ModelConfig(**args["model"]),
                                device="cpu")
    before = sharding.collective_launches()
    out = {"streams": {}}
    for case, kw in args["cases"].items():
        eng = ServingEngine(model, mesh=sm, device="cpu",
                            cache_dtype=torch.float32, **kw)
        rids = [eng.submit(p, args["n_new"], seed=i)
                for i, p in enumerate(args["prompts"])]
        fin = eng.run()
        out["streams"][case] = [list(map(int, fin[r].tokens)) for r in rids]
        out["tp"] = eng.tp
    after = sharding.collective_launches()
    out["collectives"] = {n: after[n] - before[n] for n in after
                          if after[n] != before[n]}
    logits = torch.from_numpy(args["logits"])
    out["argmax"] = greedy_argmax(logits.chunk(sm.tp, -1)[mesh.tp_index],
                                  sm.tensor).numpy()
    reads = [0.0]

    def clock():
        reads[0] += 1.0 + mesh.rank
        return reads[0]

    eng = ServingEngine(model, mesh=sm, device="cpu", slots=1, window=4,
                        cache_dtype=torch.float32, clock=clock)
    rids = [eng.submit(p, 6, seed=i, deadline_s=d)
            for i, (p, d) in enumerate(zip(args["prompts"],
                                           args["deadlines"]))]
    eng.run()
    out["shed"] = sorted(eng.expired)
    out["kept"] = {r: list(map(int, eng.finished[r].tokens))
                   for r in rids if r in eng.finished}
    eng = ServingEngine(model, mesh=sm, device="cpu", slots=1, window=4,
                        cache_dtype=torch.float32, clock=clock,
                        telemetry=True)
    eng.submit(args["prompts"][0], 6)
    eng.run()
    out["shortest_span"] = min(d.dur for d in eng.telemetry.dispatches)
    return out


def _experiment(args):
    from midgpt_tpu_torch.config import (
        ExperimentConfig,
        MeshConfig,
        ModelConfig,
    )

    return ExperimentConfig(model=ModelConfig(**args["model"]),
                            mesh=MeshConfig(**args.get("mesh", {})),
                            **args["train"])


def mesh_steps(args):
    """Steps of the sharded trainer on this rank's rows (and columns) of
    the given global batches ``[steps, G, B, T]`` from the given full
    init (cut to this rank's tensor shard under a tensor axis, to its
    stage under a pipeline axis), or from a checkpoint's
    ``args["items"]``: every step's loss and grad norm, and the gathered
    f32 params after each step in ``args["gather_after"]`` (on a
    first-stage rank; None on the other stages)."""
    import torch

    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.parallel import batch_rows, seq_cols, sharding
    from midgpt_tpu_torch.parallel.mesh import create_mesh
    from midgpt_tpu_torch.train import (
        bind_mesh,
        effective_loss_chunk,
        init_sharded_state,
        make_lr_schedule,
        train_step,
    )

    cfg = _experiment(args)
    mesh = create_mesh(cfg.mesh)
    model = GPT.init(cfg.model, device="cpu")
    model.load_state_dict(args["init"])
    state = init_sharded_state(cfg, mesh, "cpu", model=model)
    if "items" in args:  # a checkpoint's full tensors, moments and step
        state.load_items(args["items"])
    rows = batch_rows(args["xs"].shape[2], mesh)
    cols = seq_cols(args["xs"].shape[3], mesh)
    bind_mesh(state.shadow, mesh, rows.start)
    sched = make_lr_schedule(cfg)
    out = {"loss": [], "grad_norm": [], "params": {}, "shard": None}
    counted = sharding.collective_launches()
    for s in range(len(args["xs"])):
        x = torch.from_numpy(args["xs"][s][:, rows, cols]).long()
        y = torch.from_numpy(args["ys"][s][:, rows, cols]).long()
        loss, norm = train_step(state, state.shadow, x, y, cfg, sched(s),
                                effective_loss_chunk(cfg, mesh),
                                args.get("step_keys", [None] * 99)[s])
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(norm))
        if s == 0:  # the first step's collectives
            out["collectives"] = {k: v - counted[k] for k, v in
                                  sharding.collective_launches().items()}
        if s + 1 in args.get("gather_after", ()):
            items = state.items(keep=mesh.pp_index == 0)
            out["params"][s + 1] = (None if items is None
                                    else _np(items["params"]))
    out["shard"] = (state.layout.lo, state.layout.hi,
                    int(state.master_flat.numel()),
                    int(state.mu_flat.numel()), int(state.nu_flat.numel()),
                    state.layout.padded)
    return out


def save_items(args):
    """``ShardedState.items`` from the given full init, kept on rank 0
    only: each kept tensor's device, whether its storage is its own
    (exactly its bytes, not a view of a gathered whole-model buffer) and
    its values; None elsewhere."""
    import torch.distributed as dist

    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.parallel.mesh import create_mesh
    from midgpt_tpu_torch.train import init_sharded_state

    cfg = _experiment(args)
    mesh = create_mesh(cfg.mesh)
    model = GPT.init(cfg.model, device="cpu")
    model.load_state_dict(args["init"])
    state = init_sharded_state(cfg, mesh, "cpu", model=model)
    items = state.items(keep=dist.get_rank() == 0)
    if items is None:
        return None
    tensors = [t for key in ("params", "mu", "nu")
               for t in items[key].values()]
    return {"devices": sorted({str(t.device) for t in tensors}),
            "own_storage": all(
                t.untyped_storage().nbytes() == t.numel() * t.element_size()
                for t in tensors),
            "storages": len({t.untyped_storage().data_ptr()
                             for t in tensors}),
            "tensors": len(tensors), "step": items["step"],
            "params": _np(items["params"]), "mu": _np(items["mu"])}


def mesh_train(args):
    """``train()`` under the group; ``args["sigterm_at"] = (rank, step)``
    raises SIGTERM in that rank when its step body reaches that step."""
    import dataclasses

    import midgpt_tpu_torch.train as tr

    cfg = dataclasses.replace(_experiment(args), rundir=args["rundir"],
                              data_dir=args["data_dir"])
    if "init" in args:  # start from the given weights, not cfg.seed's
        real_init = tr.GPT.init

        def init(model_cfg, generator=None, device=None, dtype=None,
                 tensor=None, stage=None):
            m = real_init(model_cfg, generator, device="cpu")
            m.load_state_dict(args["init"])
            if stage is not None:
                m.keep_stage_(*stage)
            if tensor is not None:
                m.shard_tensor_(tensor)
            return m.to(device=device, dtype=dtype)

        tr.GPT.init = init
    hit = args.get("sigterm_at")
    if hit is not None:
        import torch.distributed as dist

        real = tr.step_body

        def body(prog, state, *a, **kw):
            if dist.get_rank() == hit[0] and state.step == hit[1]:
                signal.raise_signal(signal.SIGTERM)
            return real(prog, state, *a, **kw)

        tr.step_body = body
    final = tr.train(cfg)
    return {k: final[k] for k in ("losses", "val_loss", "first_step",
                                  "train_dispatches")
            if k in final} | {"interrupted_at": final.get("interrupted_at")}


def _main() -> None:
    fn, rank, world, workdir, store = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), sys.argv[4],
                                       sys.argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method="file://" + store,
        rank=rank, world_size=world)
    try:
        result = globals()[fn](args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    _main()
