"""Command-line launcher for training with the port.

    python -m midgpt_tpu_torch.launch --config openwebtext --rundir R \
        [--set key=value ...]

Any ``ExperimentConfig`` field can be overridden with ``--set`` (dotted
paths reach the model config, e.g. ``--set model.n_layer=4 device=cpu``;
values parse as JSON where they can). The resolved config is written to
``<rundir>/config.json`` before training starts; training resumes from
the newest checkpoint in the rundir.
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


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="named experiment")
    parser.add_argument("--rundir", default=None)
    parser.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                        help="config field overrides, dotted paths allowed")
    args = parser.parse_args(argv)

    from midgpt_tpu_torch.config import get_config, to_dict
    from midgpt_tpu_torch.train import train

    cfg = apply_overrides(get_config(args.config), args.set)
    rundir = args.rundir or cfg.rundir or os.path.join(
        "outputs", time.strftime("%Y%m%d-%H%M%S"))
    cfg = dataclasses.replace(cfg, rundir=rundir)
    os.makedirs(rundir, exist_ok=True)
    text = json.dumps(to_dict(cfg), indent=2)
    with open(os.path.join(rundir, "config.json"), "w") as f:
        f.write(text)
    print(text)
    final = train(cfg)
    print("final:", json.dumps({k: v for k, v in final.items()
                                if k != "losses"}))
    return final


if __name__ == "__main__":
    main()
