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
- ``serve_spec``: the serve_spec main-path run alone;
- ``serve_prefix``: the serve_prefix runs (cache off, on, chunked,
  int8), for checkouts that have the phase;
- ``train``, ``char``, ``long``: the train, train_char and train_long
  main-path runs, each followed by its profile (two steps under
  torch.profiler);
- ``train_profile``, ``char_profile``, ``long_profile``: those profiles
  alone (``chip_smoke.phase_train_profile``: a fresh init, one warm-up
  step, two steps under torch.profiler, device time by kernel and group,
  the idle share), which ``chip_smoke.py`` itself no longer runs;
- ``timing_serve``, ``timing_train``, ``timing_flash``, ``timing_long``,
  ``timing_int8_matmul``: the timing phases of the paged kernels (decode,
  verify, both int8 branches), the fused, the flash, the split/norm and
  the int8 matmul kernels;
- ``int8_plain``: serve_int8's int8 runs (spec-off, spec-on) with
  ``QuantLinear``'s product swapped for its plain version, so that the
  kernel's streams (``serve``) compare with the plain version's;
- ``serve_moe``: the serve_moe phase (``openwebtext_moe``);
- ``cluster``: the cluster phase (two replicas in turn, on worker
  threads, beside one 16-slot engine), its reference streams from one
  engine served first;
- ``graphs``: the graphs phase, for checkouts that have it;
- ``train_steps``: ``train()`` from the outside in any checkout, on
  ``openwebtext`` (the train phase's 16 x 1024 tokens a step, remat none
  and dots), ``shakespeare_char`` (dropout 0.2, remat full) and
  ``openwebtext_moe``: TRAIN_STEPS steps each in ``debug`` mode (one
  eval batch, the second window profiled, one save, at the end);
  steps-only tokens/s (the loop less the evals and the save) and the
  median of the logged per-step (per-window) rates past the first two
  windows (past the first four steps at K=1), at K=1 and, where
  the checkout's config has ``steps_per_dispatch``, at K=4;
- ``sample``: the fixed-batch sampler from the outside in any checkout:
  ``generate`` at B=8, P=256, 64 new tokens, greedy (one warm call,
  then ``SAMPLE_REPS`` timed), and ``generate_served`` on the same
  prompts (serve's engine); tokens/s of each, a decode step's eager host
  and device ms (``decode_step_recent`` alone), and where the checkout
  has the sampler's programs a warm call's host and device ms and a
  replayed step's (``chip_smoke.sampler_replay_timing``); first of all
  the sample CLI's own call (3 rows, a one-token prompt, 200 new tokens,
  temperature 0.8) as the first call of its shape in the process, the
  programs' captures included (capture ms each), and again warm;
- ``dispatch``: one dispatch of any checkout's engine, from the outside:
  serve's engine on eight requests (serve's first eight prompts spec-off,
  serve_spec's repetitive half at speculate=4; bf16 and int8), two steps
  in (every slot decoding), then ``DISPATCH_STEPS`` steps timed alone
  (host ms a step, each ending in the harvest's read) and as many under
  ``torch.profiler`` (device busy ms and aten ops a step, the idle share
  against the profiled step).

Every engine of every phase but ``sample``'s ``generate_served`` runs
``warm_prefill`` over its whole block when it is made, in checkouts
whose engine has it, so prefill
dispatches (captured programs or eager chunks) are warm in both trees
before any phase's clock starts.

``--prefix-cache off`` serves with the prefix cache off in every checkout
whose engine has one (its default is on), so that checkouts from before
and after the prefix cache serve the same work.

Every ``ServingEngine.run()`` of a phase also prints a ``streams`` record:
the engine's quant, kv_quant, speculate, prefix_cache and prefill_chunk
arguments, the number of finished requests, a SHA-1 of their token
streams in request order and a short one of each stream, so that two
checkouts' streams compare run by run and request by request (the k-th
``streams`` record of one turn against the k-th of another).

Every record a phase prints is printed again as one JSON line with the
turn's index and checkout added. Exits with the first failing turn's
code.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

STREAM_KEYS = ("quant", "kv_quant", "speculate", "prefix_cache",
               "prefill_chunk")
PHASES = ("serve", "serve_spec", "serve_prefix", "train", "char", "long",
          "timing_serve", "timing_train", "timing_flash", "timing_long",
          "timing_int8_matmul", "int8_plain", "serve_moe", "cluster",
          "graphs", "dispatch", "train_steps", "sample", "train_profile",
          "char_profile", "long_profile")
DISPATCH_STEPS = 6
SAMPLE_REPS = 3
# train_steps: steps a run, per configuration (name, remat or None)
TRAIN_STEPS = {("openwebtext", None): 48, ("openwebtext", "dots"): 48,
               ("shakespeare_char", None): 160, ("openwebtext_moe", None): 24}


def train_steps(cs, gpu) -> None:
    """The ``train_steps`` phase's records (see the module docstring)."""
    import dataclasses
    import statistics
    import subprocess as sp
    import tempfile

    from midgpt_tpu_torch.config import ExperimentConfig, get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.utils.metrics import read_metrics

    ks = ((1, 4) if "steps_per_dispatch" in {
        f.name for f in dataclasses.fields(ExperimentConfig)} else (1,))
    sets = {"openwebtext": cs.TRAIN_SET, "shakespeare_char": cs.CHAR_SET,
            "openwebtext_moe": cs.MOE_SET}
    with tempfile.TemporaryDirectory() as tmp:
        zipf = os.path.join(tmp, "zipf")
        write_tokens(os.path.join(zipf, "train.bin"),
                     cs.zipf_tokens(cs.DATA_TOKENS, cs.SEED))
        write_tokens(os.path.join(zipf, "val.bin"),
                     cs.zipf_tokens(cs.DATA_TOKENS, cs.SEED + 1))
        char = os.path.join(tmp, "char")
        sp.run([sys.executable, os.path.join(
            "data", "shakespeare_char", "prepare.py"), "--synthetic",
            "--out_dir", char], check=True, capture_output=True)
        for (name, remat), steps in TRAIN_STEPS.items():
            for k in ks:
                # debug: no save inside the loop (an asynchronous write
                # slows the steps it overlaps), the second window profiled
                over = dict(sets[name], max_steps=steps, eval_interval=steps,
                            eval_batches=1, ckpt_interval=steps,
                            log_interval=1, debug=True)
                if k > 1:
                    over["steps_per_dispatch"] = k
                rundir = os.path.join(tmp, f"{name}_{remat}_{k}")
                cfg = get_config(name, rundir=rundir, seed=cs.SEED,
                                 data_dir=char if name == "shakespeare_char"
                                 else zipf, **over)
                if remat is not None:
                    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                        cfg.model, remat=remat))
                final, wall, peak, _ = cs.train_measured(cfg)
                rates = [r["tokens_per_sec"] for r in read_metrics(rundir)
                         if "tokens_per_sec" in r]
                tokens = cfg.batch_size * cfg.model.block_size
                steps_s = (final["loop_s"] - final["eval_s"]
                           - final["ckpt_s"] - final["ckpt_wait_s"])
                # past the warm-up, the capture and the profiled window
                steady = rates[2:] if k > 1 else rates[4:]
                print(json.dumps({
                    "phase": "train_steps", "config": name,
                    "remat": final["remat"], "k": k, "steps": steps,
                    "losses_head": final["losses"][:4],
                    "tokens_per_s_steps_only": tokens * steps / steps_s,
                    "tokens_per_s_median": statistics.median(steady),
                    "step_ms_median": 1e3 * tokens
                    / statistics.median(steady),
                    "tokens_per_s": final["tokens_per_sec"],
                    "loop_s": final["loop_s"], "eval_s": final["eval_s"],
                    "ckpt_s": final["ckpt_s"],
                    "ckpt_wait_s": final["ckpt_wait_s"], "wall_s": wall,
                    "peak_bytes": peak, "gpu": gpu}), flush=True)


def dispatch_steps(cs, serving, model, ps, **kw):
    """The ``dispatch`` phase's record for one engine setting."""
    import statistics
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = serving.ServingEngine(model, slots=cs.SPEC["slots"],
                                page_size=cs.SPEC["page_size"],
                                device=cs.DEVICE, **kw)
    for i, p in enumerate(ps):
        eng.submit(p, cs.MAX_NEW, seed=i)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    host = []
    for _ in range(DISPATCH_STEPS):
        t0 = time.perf_counter()
        eng.step()
        host.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DISPATCH_STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / DISPATCH_STEPS
    busy, aten = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            busy += e.self_device_time_total / 1e3 / DISPATCH_STEPS
        elif e.key.startswith("aten::"):
            aten += e.count
    return {"slots_live_after": sum(r is not None for r in eng.slot_req),
            "host_ms_per_step": statistics.median(host),
            "host_ms_each": host, "profiled_ms_per_step": wall,
            "device_busy_ms_per_step": busy,
            "idle_share_profiled": (1.0 - busy / wall) if busy else None,
            "idle_share_unprofiled": (
                1.0 - busy / statistics.median(host)) if busy else None,
            "aten_ops_per_step": aten / DISPATCH_STEPS,
            "windows": eng.windows}


def cli_call(cs, sampling, model, cfg) -> dict:
    """The sample CLI's call (``midgpt_tpu_torch/sample.py``'s defaults:
    3 rows of the one-token prompt "\\n", 200 new tokens, temperature
    0.8, chunk 64, seed 0), as the CLI makes it once a process: its wall
    s as the first call of its shape (the programs' captures included
    where the checkout has them) and again, warm. One eager forward of a
    short prompt first, so that the context, cuBLAS and the kernels'
    modules are up in both trees, as they are for any call."""
    import time

    import numpy as np
    import torch

    from midgpt_tpu_torch.models import gpt as G

    G.prefill(model, torch.zeros((1, 8), dtype=torch.int32,
                                 device=cs.DEVICE),
              G.KVCache.init(cfg, 1, 8, device=cs.DEVICE))
    prompt = np.full((3, 1), 198, np.int32)  # GPT-2's "\n"
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampling.generate(model, prompt, 200, temperature=0.8, seed=0,
                          chunk_len=64, device=cs.DEVICE)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rec = {"cli_first_call_s": walls[0], "cli_second_call_s": walls[1]}
    if hasattr(sampling, "sampler_programs"):
        progs = list(sampling._SAMPLERS.values())[-1]
        rec["cli_plan"] = progs.plan
        rec["cli_capture_ms"] = {
            " ".join(map(str, prog.key[len(progs.key):])): prog.capture_ms
            for prog in progs.programs()}
    return rec


def sample_turn(cs, serving, model, cfg, gpu) -> None:
    """The ``sample`` phase's record (see the module docstring)."""
    import statistics
    import time

    import torch

    from midgpt_tpu_torch import sampling
    from midgpt_tpu_torch.models import gpt as G

    ps = cs.sample_prompt(cfg.vocab_size, 256)
    n = 64
    cli = cli_call(cs, sampling, model, cfg)

    def timed(fn):
        fn()  # warm: kernels, and the programs' captures where there are
        walls = []
        for _ in range(SAMPLE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    gen = timed(lambda: sampling.generate(model, ps, n, temperature=0.0,
                                          device=cs.DEVICE))
    # generate_served makes an engine a call: as a user calls it, with no
    # warm_prefill over the whole block inside the clock
    serving.ServingEngine.warm = False
    try:
        served = timed(lambda: serving.generate_served(
            model, list(ps), n, device=cs.DEVICE, **cs.SERVE))
    finally:
        serving.ServingEngine.warm = True
    rec = {"phase": "sample_turn", "batch": cs.SAMPLE_B, "prompt": 256,
           "new_tokens": n, "generate_wall_s": gen,
           "generate_tokens_per_s": cs.SAMPLE_B * n / gen,
           "served_wall_s": served,
           "served_tokens_per_s": cs.SAMPLE_B * n / served, **cli}
    if hasattr(sampling, "sampler_programs"):
        progs = list(sampling._SAMPLERS.values())[-1]
        rec["replays"] = cs.sampler_replay_timing(progs, ps)
    # one eager decode step (B=8, position 256 of a 320-slot ring)
    L = cfg.n_layer
    cache = G.prefill(model, torch.from_numpy(ps).to(cs.DEVICE),
                      G.KVCache.init(cfg, cs.SAMPLE_B, 320,
                                     device=cs.DEVICE))[1]
    rk = torch.zeros((L, cs.SAMPLE_B, cfg.kv_heads, 64, cfg.head_dim),
                     dtype=torch.bfloat16, device=cs.DEVICE)
    rv = torch.zeros_like(rk)
    tok = torch.zeros(cs.SAMPLE_B, dtype=torch.int32, device=cs.DEVICE)

    def one_step(i):
        G.decode_step_recent(model, tok, 256, cache, rk, rv, 0, 256, 320,
                             320)

    rec["eager_step_device_ms"] = cs.device_ms(one_step, 10)
    rec["eager_step_host_ms"] = cs.eager_ms(one_step, 20)
    print(json.dumps({**rec, "gpu": gpu}), flush=True)


def worker(phases, prefix_cache: str) -> None:
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
    engine = serving.ServingEngine
    if prefix_cache == "off" and "prefix_cache" in inspect.signature(
            engine).parameters:
        class CacheOff(engine):
            def __init__(self, *a, **kw):
                kw.setdefault("prefix_cache", False)
                super().__init__(*a, **kw)

        # generate_served and the phases look the engine up here
        serving.ServingEngine = CacheOff

    class Streams(serving.ServingEngine):
        warm = True  # warm_prefill at construction (see the docstring)

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._stream_kw = {k: kw[k] for k in STREAM_KEYS if k in kw}
            if self.warm and hasattr(self, "warm_prefill"):
                from midgpt_tpu_torch.ops import launches

                with launches.recording():  # not the phases' counts
                    self.warm_prefill(self.block)

        def run(self, *a, **kw):
            done = super().run(*a, **kw)
            toks = [list(done[r].tokens) for r in sorted(done)]
            print(json.dumps({
                "phase": "streams", **self._stream_kw,
                "requests": len(toks),
                "sha1": hashlib.sha1(json.dumps(toks).encode()).hexdigest(),
                "each": [hashlib.sha1(json.dumps(t).encode()).hexdigest()[:8]
                         for t in toks],
            }), flush=True)
            return done

    serving.ServingEngine = Streams

    def serve():
        cs.phase_serve(pa, serving, GPT, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        cs.phase_serve_spec(pa, serving, GPT, cfg, gpu)
        gc.collect()
        torch.cuda.empty_cache()
        if "im" in inspect.signature(cs.phase_serve_int8).parameters:
            from midgpt_tpu_torch.ops import int8_matmul as im

            cs.phase_serve_int8(pa, im, serving, GPT, cfg, gpu)
        else:
            cs.phase_serve_int8(pa, serving, GPT, cfg, gpu)

    def timing_int8_matmul():
        from midgpt_tpu_torch.ops import int8_matmul as im

        cs.phase_timing_int8_matmul(im, GPT, cfg, gpu)

    def int8_plain():
        from midgpt_tpu_torch import quant
        from midgpt_tpu_torch.ops import int8_matmul as im

        model = GPT.init(cfg, torch.Generator().manual_seed(cs.SEED),
                         device=cs.DEVICE, dtype=torch.bfloat16)
        ps = cs.prompts(cfg.vocab_size)
        kernel = quant.int8_matmul
        quant.int8_matmul = im.int8_matmul_reference
        try:
            for kw in (dict(window=4), dict(speculate=cs.SPEC["speculate"])):
                cs.serve_run(serving, model, ps, **kw, **cs.INT8)
        finally:
            quant.int8_matmul = kernel

    def timing_serve():
        cs.phase_timing(pa, cfg, gpu)
        cs.phase_timing_verify(pa, cfg, gpu)
        cs.phase_timing_int8(pa, cfg, gpu)

    def serve_prefix():
        from midgpt_tpu_torch.ops import int8_matmul as im

        cs.phase_serve_prefix(pa, im, serving, GPT, cfg, gpu)

    def new_model():
        return GPT.init(cfg, torch.Generator().manual_seed(cs.SEED),
                        device=cs.DEVICE, dtype=torch.bfloat16)

    def cluster():
        model = new_model()
        ps = cs.prompts(cfg.vocab_size)
        ref = [r.tokens for r in cs.serve_run(serving, model, ps)[1]]
        cs.phase_cluster(pa, serving, model, cfg, ref, gpu)

    def graphs():
        if hasattr(cs, "phase_graphs"):
            from midgpt_tpu_torch.ops import int8_matmul as im

            cs.phase_graphs(pa, im, serving, new_model(), cfg, gpu)

    def dispatch():
        model = new_model()
        half = cs.SPEC["slots"]
        for name, kw, ps in (
                ("window", {}, cs.prompts(cfg.vocab_size)[:half]),
                ("verify", dict(speculate=cs.SPEC["speculate"]),
                 cs.spec_prompts(cfg.vocab_size)[half:]),
                ("window_int8", cs.INT8, cs.prompts(cfg.vocab_size)[:half]),
                ("verify_int8", {**cs.INT8,
                                 "speculate": cs.SPEC["speculate"]},
                 cs.spec_prompts(cfg.vocab_size)[half:])):
            rec = dispatch_steps(cs, serving, model, ps, **kw)
            print(json.dumps({"phase": "dispatch", "case": name, **rec,
                              "gpu": gpu}), flush=True)

    runs = {
        "serve": serve,
        "serve_spec": lambda: cs.phase_serve_spec(pa, serving, GPT, cfg, gpu),
        "serve_prefix": serve_prefix,
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
        "timing_int8_matmul": timing_int8_matmul,
        "int8_plain": int8_plain,
        "serve_moe": lambda: cs.phase_serve_moe(pa, serving, GPT, gpu),
        "cluster": cluster,
        "graphs": graphs,
        "dispatch": dispatch,
        "train_steps": lambda: train_steps(cs, gpu),
        "train_profile": lambda: cs.phase_train_profile(gpu),
        "char_profile": lambda: cs.phase_train_profile(
            gpu, "shakespeare_char", cs.CHAR_SET),
        "long_profile": lambda: cs.phase_train_profile(
            gpu, overrides=cs.LONG_SET, long=True),
        "sample": lambda: sample_turn(cs, serving, new_model(), cfg, gpu),
    }
    for phase in phases:
        runs[phase]()
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dirs", nargs="+", required=True)
    ap.add_argument("--phases", nargs="+", choices=PHASES, required=True)
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="on")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.phases, args.prefix_cache)
        return 0
    for turn, d in enumerate(args.dirs):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--dirs",
             d, "--phases", *args.phases, "--prefix-cache",
             args.prefix_cache],
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
