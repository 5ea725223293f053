"""Run chosen phases of ``chip_smoke.py`` from several checkouts in turns,
on one card, to compare two commits in one call.

    python3 chip_turns.py --dirs build/parent . . build/parent \\
        --phases serve train char long timing_serve timing_train \\
        timing_flash timing_long

Each entry of ``--dirs`` is the root of a checkout (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore``
lists); the checkouts run one after another, in the order given, each in
a process of its own that builds that checkout's kernels and imports its
``chip_smoke.py``. The phases:

- ``serve``: the serve, serve_spec and serve_int8 main-path runs;
- ``train``, ``char``, ``long``: the train, train_char and train_long
  main-path runs, each followed by its profile (two steps under
  torch.profiler);
- ``timing_serve``, ``timing_train``, ``timing_flash``, ``timing_long``:
  the timing phases of the paged kernels (decode, verify, both int8
  branches), the fused, the flash and the split/norm kernels.

Every record a phase prints is printed again as one JSON line with the
turn's index and checkout added. Exits with the first failing turn's
code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("serve", "train", "char", "long", "timing_serve", "timing_train",
          "timing_flash", "timing_long")


def worker(phases) -> None:
    """The phases, run from the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import gc

    import torch

    import chip_smoke as cs
    from midgpt_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    gpu = cs.gpu_line()
    from midgpt_tpu_torch import serving
    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.ops import fused_norm as fn
    from midgpt_tpu_torch.ops import paged_attn as pa

    cfg = get_model_config("openwebtext")

    def serve():
        cs.phase_serve(pa, serving, GPT, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        cs.phase_serve_spec(pa, serving, GPT, cfg, gpu)
        gc.collect()
        torch.cuda.empty_cache()
        cs.phase_serve_int8(pa, serving, GPT, cfg, gpu)

    def timing_serve():
        cs.phase_timing(pa, cfg, gpu)
        cs.phase_timing_verify(pa, cfg, gpu)
        cs.phase_timing_int8(pa, cfg, gpu)

    runs = {
        "serve": serve,
        "timing_serve": timing_serve,
        "train": lambda: (cs.phase_train(fa, gpu),
                          cs.phase_train_profile(gpu)),
        "char": lambda: (cs.phase_train_char(fl, fa, gpu),
                         cs.phase_train_profile(gpu, "shakespeare_char",
                                                cs.CHAR_SET)),
        "long": lambda: (cs.phase_train_long(fa, fn, gpu),
                         cs.phase_train_profile(gpu, overrides=cs.LONG_SET,
                                                long=True)),
        "timing_train": lambda: cs.phase_timing_train(fa, gpu),
        "timing_flash": lambda: cs.phase_timing_flash(fl, gpu),
        "timing_long": lambda: cs.phase_timing_long(fa, fn, gpu),
    }
    for phase in phases:
        runs[phase]()
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dirs", nargs="+", required=True)
    ap.add_argument("--phases", nargs="+", choices=PHASES, required=True)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.phases)
        return 0
    for turn, d in enumerate(args.dirs):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--dirs",
             d, "--phases", *args.phases],
            cwd=d, capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                print(json.dumps({"turn": turn, "checkout": d, **rec}),
                      flush=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
