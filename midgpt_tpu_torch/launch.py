"""Command-line launcher for training with the port.

    python -m midgpt_tpu_torch.launch --config openwebtext --rundir R \
        [--set key=value ...]

    python -m torch.distributed.run --nproc_per_node=N \
        -m midgpt_tpu_torch.launch --multihost --config openwebtext \
        --rundir R --set mesh.fsdp=-1

Any ``ExperimentConfig`` field can be overridden with ``--set`` (dotted
paths reach the model and mesh configs, e.g. ``--set model.n_layer=4
device=cpu mesh.replica=2``; values parse as JSON where they can). The
resolved config is written to ``<rundir>/config.json`` before training
starts; training resumes from the newest checkpoint in the rundir.

``--multihost`` joins the process group that ``torch.distributed.run``
describes in the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL with this rank's card
``cuda:LOCAL_RANK`` as its device, or gloo when the config asks for
``device=cpu``. It needs ``--rundir``; rank 0 writes ``config.json``
and every rank waits at a barrier before training (the JAX launcher's
``sync_global_devices``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import typing as tp


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def apply_overrides(cfg, overrides: tp.Iterable[str]):
    """Dotted-path replace on nested frozen dataclasses."""
    for item in overrides:
        path, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"--set expects key=value, got {item!r}")
        value = _parse_value(raw)

        def rec(obj, keys):
            if len(keys) == 1:
                return dataclasses.replace(obj, **{keys[0]: value})
            return dataclasses.replace(
                obj, **{keys[0]: rec(getattr(obj, keys[0]), keys[1:])})

        cfg = rec(cfg, path.split("."))
    return cfg


def init_multihost(device: str) -> int:
    """Join ``torch.distributed.run``'s process group: NCCL on the card
    (the device ``cuda:LOCAL_RANK``, made current), gloo on the CPU.
    Returns this process's rank."""
    import torch
    import torch.distributed as dist

    from midgpt_tpu_torch.utils.platform import local_rank, resolve_device

    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torch.distributed.run's "
                           f"environment; missing {missing}")
    dev = resolve_device(device, local_rank())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    return dist.get_rank()


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="named experiment")
    parser.add_argument("--rundir", default=None)
    parser.add_argument("--multihost", action="store_true",
                        help="join torch.distributed.run's process group")
    parser.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                        help="config field overrides, dotted paths allowed")
    args = parser.parse_args(argv)

    from midgpt_tpu_torch.config import get_config, to_dict
    from midgpt_tpu_torch.train import train

    cfg = apply_overrides(get_config(args.config), args.set)
    rundir = args.rundir or cfg.rundir
    if not rundir:
        if args.multihost:
            raise ValueError("--multihost requires an explicit --rundir")
        rundir = os.path.join("outputs", time.strftime("%Y%m%d-%H%M%S"))
    cfg = dataclasses.replace(cfg, rundir=rundir)
    rank = init_multihost(cfg.device) if args.multihost else 0
    if rank == 0:
        os.makedirs(rundir, exist_ok=True)
        text = json.dumps(to_dict(cfg), indent=2)
        with open(os.path.join(rundir, "config.json"), "w") as f:
            f.write(text)
        print(text)
    try:
        if args.multihost:
            import torch.distributed as dist

            dist.barrier()  # config.json is written
        final = train(cfg)
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()
    if rank == 0:
        print("final:", json.dumps({k: v for k, v in final.items()
                                    if k != "losses"}))
    return final


if __name__ == "__main__":
    main()
