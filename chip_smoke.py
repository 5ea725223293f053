"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as one JSON line and
each fatal on failure (exit code not 0, no result line):

1. build   -- nvcc builds every kernel source under midgpt_tpu_torch/csrc
              (one process per source, all started together), with the
              card's name and power limit;
2. kernel  -- each kernel against its plain PyTorch version on the card:
              bf16 and f32 pools, the openwebtext geometry and a GQA one,
              ragged resident lengths, first and last recent row, held
              element by element (see ``hold``); a faulted output (each
              slot's last resident row dropped) must fail the same check;
3. serve   -- the serving main path at the full width of ``openwebtext``
              (124M, random init from a seed, bf16 weights and pool):
              ServingEngine(slots=8, window=4, page_size=16) on 16 greedy
              requests; every kernel's launch count is read around that
              run alone, and one decode window's logits through the
              kernel are held to the plain path on the same state (bf16:
              within twice the plain bf16 path's distance from the f32
              path; f32: 1e-4 of the largest logit); the first 8
              prompts served greedy and sampled (T=0.8, top-k 50, noise
              drawn on the card), timed;
4. timing  -- each kernel at the serve shapes (a CUDA graph of launches
              replayed between CUDA events, median of repeats) beside
              its plain version and its bound, and the sampler's noise
              and draw at [8, vocab];
5. kernels -- one JSON object listing every kernel of the port.

The last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEVICE = "cuda"
SEED = 0
SERVE = dict(slots=8, window=4, page_size=16)
N_REQUESTS, MAX_NEW = 16, 64
# kernel-phase geometries: (name, Hkv, G, C); S=8, PS=16, Pmax=64, R=4
GEOMS = [("openwebtext", 12, 1, 64), ("gqa", 8, 4, 128)]
S, PS, PMAX, R = 8, 16, 64, 4
# empty, mid-page, page-aligned, ..., full table
LENS = [0, 7, 16, 200, 512, 777, 1000, PMAX * PS]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


ABS_TOL = 1e-5


def hold(got: torch.Tensor, ref32: torch.Tensor):
    """Hold a kernel output element by element against the plain version
    run in f32 on the same inputs upcast (the plain version upcasts them
    itself, so this is its value before the one final cast). Each element
    may be off by 1e-5 (the two sum in different orders) plus, for a bf16
    output, the final rounding: half a bf16 ulp, at most 2^-8 of the
    rounded value. Returns ``(max_abs_err, max err/tolerance)``; the check
    passes when the second is at most 1."""
    err = (got.float() - ref32).abs()
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + ABS_TOL
    return err.max().item(), (err / tol).max().item()


def plain32(pa, q, pk, pv, bt, pl, rk, rv, r, layer):
    """The plain version on the same inputs upcast to f32."""
    return pa.paged_decode_attention_reference(
        q.float(), pk.float(), pv.float(), bt, pl, rk.float(), rv.float(),
        r, layer)


def paged_inputs(hkv, g, c, dtype, lens, layers=2, seed=0):
    """Random pools, queries and recent rows on the card; every slot owns
    distinct live pages and its table pads hold the sentinel page id."""
    gen = torch.Generator().manual_seed(seed)
    live = [-(-n // PS) for n in lens]
    num_pages = sum(live) + 1
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    q = f(len(lens), hkv, g, c)
    pk = f(layers, num_pages, hkv, c, PS)
    pv = f(layers, num_pages, hkv, c, PS)
    rk, rv = f(len(lens), hkv, R, c), f(len(lens), hkv, R, c)
    bt = torch.full((len(lens), PMAX), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    dev = torch.device(DEVICE)
    out = [a.to(dev, dtype) for a in (q, pk, pv)]
    out += [bt.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)]
    out += [a.to(dev, dtype) for a in (rk, rv)]
    return out


def phase_kernel(pa) -> float:
    """Each case is held to the plain version (:func:`hold`), and the same
    check is shown to refuse a faulted output: the kernel run with each
    slot's last resident row dropped must fail it in every slot that had
    a row to drop."""
    worst = 0.0
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(hkv, g, c, dtype, LENS)
            pl = args[4]
            for r in (0, R - 1):
                got = pa.paged_decode_attention(*args, r, 1)
                torch.cuda.synchronize()
                ref = pa.paged_decode_attention_reference(*args, r, 1)
                ref32 = plain32(pa, *args, r, 1)
                err, ratio = hold(got, ref32)
                fault = pa.paged_decode_attention(
                    *args[:4], (pl - 1).clamp_min(0), *args[5:], r, 1)
                # the least err/tol among the slots that lost a row
                fault_ratio = min(hold(fault[i], ref32[i])[1]
                                  for i, n in enumerate(LENS) if n > 0)
                emit({"phase": "kernel", "kernel": "paged_decode_attention",
                      "geometry": name, "hkv": hkv, "g": g, "c": c,
                      "dtype": str(dtype).split(".")[-1], "r": r,
                      "lens": LENS, "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      "max_abs_err_vs_plain_same_dtype":
                          (got.float() - ref.float()).abs().max().item(),
                      "dropped_row_min_slot_err_over_tol": fault_ratio})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {name} "
                        f"{dtype} r={r}: {ratio} x the tolerance")
                if not fault_ratio > 1.0:
                    raise AssertionError(
                        f"the check passes a dropped resident row: {name} "
                        f"{dtype} r={r}: {fault_ratio}")
                worst = max(worst, err)
    return worst


def prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = np.linspace(16, 512, N_REQUESTS).astype(int)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def window_agreement(model, serving, tol_frac=None):
    """One decode window through the kernel and through the plain path,
    from the same engine state (8 prefilled requests). With ``tol_frac``
    the logits agree within that fraction of the largest logit. Without
    it (a bf16 model) the plain path also runs in f32 on the same weights
    and pages upcast, and the limit is twice the plain bf16 path's
    distance from it: were the kernel path no further from the f32 path
    than the plain bf16 path is, the two bf16 paths could differ by at
    most that (the triangle inequality)."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    for p in prompts(model.config.vocab_size)[: SERVE["slots"]]:
        eng.submit(p, MAX_NEW)
    eng.step()  # admission, prefill, one window: the pages hold real rows
    eng._ensure_growth()  # the page top-up step() makes before a window
    dev = eng.device
    state = [torch.from_numpy(a).to(dev) for a in (
        eng.bt, eng.pooled_len, eng.done, eng.emitted, eng.budget, eng.eos)]
    runs = [("kernel", model, eng.pool.dtype),
            ("reference", model, eng.pool.dtype)]
    if tol_frac is None:
        runs.append(("reference", copy.deepcopy(model).float(), torch.float32))
    outs, window_ms = [], []
    for kind, m, pool_dtype in runs:
        pool = serving.PagedKVPool(eng.pool.k.to(pool_dtype, copy=True),
                                   eng.pool.v.to(pool_dtype, copy=True),
                                   eng.pool.page_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serving.decode_window(
            m, pool, eng.logits.clone(), *state, eng.seeds.tolist(),
            eng.emitted.tolist(), window=eng.window, rope_len=eng.block,
            paged_kernel=kind,
        )[0])
        torch.cuda.synchronize()
        window_ms.append(1e3 * (time.perf_counter() - t0))
    a, b = outs[0], outs[1]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError("non-finite logits in the window check")
    err = (a - b).abs().max().item()
    extra = {}
    if tol_frac is None:
        plain_to_f32 = (b - outs[2]).abs().max().item()
        extra = {"max_abs_plain_bf16_to_f32": plain_to_f32,
                 "max_abs_kernel_bf16_to_f32":
                     (a - outs[2]).abs().max().item()}
        tol = 2.0 * plain_to_f32
        rule = "2 x max |plain bf16 - plain f32| on the same weights, pages"
    else:
        tol = tol_frac * b.abs().max().item()
        rule = f"{tol_frac} x max |logit|"
    argmax = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    if not err <= tol:
        raise AssertionError(f"window logits disagree: {err} > {tol}")
    return {"max_abs_err": err, "tol": tol, "tol_rule": rule, **extra,
            "argmax_agree": argmax, "max_abs_logit": b.abs().max().item(),
            "window_ms_kernel": window_ms[0],
            "window_ms_plain": window_ms[1]}


def sampled_vs_greedy(serving, model, ps, new_tokens: int = 32):
    """The same requests served greedy and sampled (T=0.8, top-k 50, the
    Gumbel noise drawn on the card), each run timed on the host clock;
    the sampled run twice, to show its streams repeat."""
    out = {}
    for name, kw in [("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, seed=3)),
                     ("sampled_again", dict(temperature=0.8, top_k=50,
                                            seed=3))]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serving.generate_served(model, ps, new_tokens, device=DEVICE,
                                       **SERVE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(len(x) == new_tokens for x in toks):
            raise AssertionError(f"{name}: lengths {[len(x) for x in toks]}")
        out[name] = (toks, len(ps) * new_tokens / wall)
    if not all(np.array_equal(a, b) for a, b in zip(out["sampled"][0],
                                                    out["sampled_again"][0])):
        raise AssertionError("sampled streams differ between two runs")
    if all(np.array_equal(a, b) for a, b in zip(out["sampled"][0],
                                                out["greedy"][0])):
        raise AssertionError("sampled streams equal the greedy ones")
    return {"requests": len(ps), "max_new_tokens": new_tokens,
            "temperature": 0.8, "top_k": 50,
            "tokens_per_s_greedy": out["greedy"][1],
            "tokens_per_s_sampled": out["sampled"][1],
            "tokens_per_s_sampled_again": out["sampled_again"][1]}


def phase_serve(pa, serving, GPT, cfg):
    gen = torch.Generator().manual_seed(SEED)
    model = GPT.init(cfg, gen, device=DEVICE, dtype=torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator): a short run, not counted
    serving.generate_served(model, ps[:2], 4, device=DEVICE, **SERVE)
    torch.cuda.synchronize()

    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in ps]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches

    steps = eng.windows * eng.window
    tokens = [finished[r].tokens for r in rids]
    if not all(len(x) == MAX_NEW for x in tokens):
        raise AssertionError(f"lengths {[len(x) for x in tokens]}")
    if not all(0 <= t < cfg.vocab_size for x in tokens for t in x):
        raise AssertionError("token id outside the vocabulary")
    if launches != cfg.n_layer * steps or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != n_layer x decode steps "
            f"{cfg.n_layer} x {steps}")
    if eng.alloc.free_pages != eng.alloc.num_pages:
        raise AssertionError("pages still held after the run")
    eng.alloc.check()
    ttft = sorted(1e3 * (finished[r].first_token_time
                         - finished[r].submit_time) for r in rids)
    sampled = sampled_vs_greedy(serving, model, ps[: SERVE["slots"]])
    bf16 = window_agreement(model, serving)
    model32 = GPT.init(cfg, torch.Generator().manual_seed(SEED),
                       device=DEVICE, dtype=torch.float32)
    f32 = window_agreement(model32, serving, 1e-4)
    del model32
    rec = {
        "phase": "serve", "config": "openwebtext", "dtype": "bfloat16",
        **SERVE, "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
        "prompt_lens": [int(p.size) for p in ps],
        "tokens": int(sum(len(x) for x in tokens)), "wall_s": wall,
        "tokens_per_s": sum(len(x) for x in tokens) / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "windows": eng.windows, "decode_steps": steps,
        "kernel_launches": launches, "stats": eng.stats(),
        "distinct_streams": len({tuple(x) for x in tokens}),
        "window_check_bf16": bf16, "window_check_f32": f32,
        "sampled_vs_greedy": sampled,
    }
    emit(rec)
    return model, launches


def eager_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    eager calls, CUDA events around each round. Where the host dispatches
    a call more slowly than the card runs it, this is the host's rate."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events; the median per call.
    The replay takes the host's per-call dispatch out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def decode_bound(q, pk, lens, r, rr_bytes_row):
    """Least time for one launch: bytes moved (q read, out written, the
    live K and V rows, the valid recent rows, the live table entries and
    the lengths) over HBM bandwidth, against the QK and PV multiply-adds
    over the peak rate of the pool's type."""
    s, hkv, g, c = q.shape
    esz = pk.element_size()
    live = int(lens.sum().item())
    ps = pk.shape[-1]
    pages = sum(-(-int(n) // ps) for n in lens.tolist())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * live * hkv * c * esz
              + 2 * s * hkv * (r + 1) * rr_bytes_row
              + 4 * pages + 4 * s)
    flops = 4 * (live + s * (r + 1)) * hkv * g * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[pk.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing(pa, cfg, gpu):
    """The kernel at the serve shapes: bf16 pool, 8 slots with resident
    lengths from the serve's prompt spread plus 32 generated tokens,
    r = R-1. The pool holds 4 x n_layer layers and launches rotate over
    them, so each launch finds its live rows (about 4 MB a layer) out of
    the 50 MB L2, as a decode step does after the other layers' weights
    have passed through it."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    lens = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    args = paged_inputs(hkv, g, c, torch.bfloat16, lens, layers=nl, seed=1)
    q, pk, pv, bt, pl, rk, rv = args
    r = R - 1

    def kernel(i):
        return pa.paged_decode_attention(q, pk, pv, bt, pl, rk, rv, r, i % nl)

    def plain(i):
        return pa.paged_decode_attention_reference(q, pk, pv, bt, pl, rk, rv,
                                                   r, i % nl)

    from midgpt_tpu_torch import sampling

    keys = torch.arange(S, dtype=torch.int64, device=DEVICE) * 977 + 5
    logits = torch.randn(S, cfg.vocab_size, device=DEVICE)

    def sample(i):
        return sampling.sample_token(
            logits, 0.8, 50, sampling.gumbel_noise(keys + i, cfg.vocab_size))

    sample_ms = device_ms(sample, reps=16)
    ms = device_ms(kernel, reps=2 * nl)
    plain_ms = device_ms(plain, reps=nl // 2)
    kernel_eager_ms = eager_ms(kernel, reps=2 * nl)
    got = pa.paged_decode_attention(q, pk, pv, bt, pl, rk, rv, r, 0)
    err, ratio = hold(got, plain32(pa, q, pk, pv, bt, pl, rk, rv, r, 0))
    if not ratio <= 1.0:
        raise AssertionError(f"serve-shape kernel error {err}: {ratio} x tol")
    bound_ms, bound_by = decode_bound(q, pk, pl, r, c * pk.element_size())
    rec = {"phase": "timing", "kernel": "paged_decode_attention",
           "shape": {"S": S, "Hkv": hkv, "G": g, "C": c, "PS": PS,
                     "Pmax": PMAX, "R": R, "r": r, "lens": lens,
                     "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms, "eager_ms": kernel_eager_ms,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "frac_of_bound": bound_ms / ms, "max_abs_err": err,
           "err_over_tol": ratio,
           "sample_ms": sample_ms, "sample_shape": [S, cfg.vocab_size],
           "gpu": gpu}
    emit(rec)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from midgpt_tpu_torch import serving
    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.ops import build
    from midgpt_tpu_torch.ops import paged_attn as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": build.SOURCES, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {k: [ln for ln in v.splitlines() if "ptxas info" in ln
                        and ("Used" in ln or "spill" in ln)]
                    for k, v in logs.items()}})

    kernel_err = phase_kernel(pa)
    cfg = get_model_config("openwebtext")
    model, launches = phase_serve(pa, serving, GPT, cfg)
    del model
    torch.cuda.empty_cache()
    timing = phase_timing(pa, cfg, gpu)

    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
        "replaces": "midgpt_tpu/ops/paged_attn.py:302",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "kernel_phase_max_abs_err": kernel_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
