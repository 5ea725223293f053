"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as one JSON line and
each fatal on failure (exit code not 0, no result line):

1. build   -- nvcc builds every kernel source under midgpt_tpu_torch/csrc
              (one process per source, all started together), with the
              card's name and power limit; per kernel, ptxas's registers,
              shared memory and spills, and the HGMMA (wgmma) instructions
              cuobjdump finds in its machine code; the dynamic shared
              memory each wgmma kernel launches with, and the paged
              split kernel's at the serve shapes;
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
4. timing  -- the paged kernel at the serve shapes (a CUDA graph of
              launches replayed between CUDA events, median of repeats)
              beside its plain version and its bound, and the sampler's
              noise and draw at [8, vocab];
   verify_kernel -- the paged verify kernel against its plain version:
              both geometries, T in (2, 5, 8), bf16 and f32, held as in
              phase 2; the same rule must refuse the output against a
              plain run with each slot's last resident column dropped
              and one whose self mask lets row t see row t + 1; each
              verify row t must equal the decode kernel's step t (the
              candidate rows as recent rows) bit for bit;
   long_table -- both paged kernels over a 32,768-token table (Pmax =
              2,048 pages of 16) at both geometries, bf16, held as in
              phase 2;
   serve_spec -- the speculative serving main path at the full width of
              ``openwebtext`` (bf16): ServingEngine(slots=8,
              page_size=16, speculate=4) on 16 greedy requests of 64 new
              tokens (eight serve prompts, eight repetitive), verify
              launches = n_layer x verify dispatches, decode launches 0;
              the same requests spec-off, timed; one verify dispatch's
              logits held to the plain path; sampled runs; a profile;
   timing  -- the verify kernel at the serve_spec shapes, as phase 4;
   kernel_int8 -- the int8 branch of both paged kernels against their
              plain versions: int8 pages (each page on its own po2 grid)
              with bf16 self rows, both geometries, decode r in (0, R-1)
              and verify T in (2, 5, 8), q bf16 and f32, held as in phase
              2; the same rule must refuse the plain version with each
              slot's first page's scale doubled and with the codes read
              without their scales;
   serve_int8 -- the int8 serving main path at the full width of
              ``openwebtext`` (bf16): quant="int8", kv_quant="int8" on the
              16 serve requests, spec-off (window 4: decode launches =
              n_layer x decode steps, verify 0) and speculate=4 (verify
              launches = n_layer x verify dispatches, decode 0), the bf16
              engine beside it in turns; one window's and one verify
              dispatch's logits held to the plain path (bf16, f32); the
              eager int8 projections' bytes and device time a decode step
              against bf16's;
   timing  -- both int8 branches at the serve shapes, as phase 4, their
              bounds counting int8 pages, page scales and bf16 self rows;
5. train_kernel -- the fused attention kernels (forward, combined
              backward) against their plain versions on the card: the
              openwebtext geometry (B=2, T=1024, H=12, C=64) and a GQA one
              (H=8, Hkv=2, C=128, T=512), f32 and bf16 (see
              ``fused_readings``); the same rule must refuse the kernels'
              outputs with the RoPE tables shifted by one position;
6. train   -- the training main path, ``midgpt_tpu_torch.train.train``,
              on ``openwebtext`` at full width and depth (124M, random
              init from a seed, f32 masters, bf16 compute, attn_impl
              "auto") for 20 steps of 16 x 1024 tokens in 2 microbatches,
              on Zipf-distributed tokens written from a seed; the fused
              kernels' launches are counted around the run alone and must
              equal the shapes' count; the loss must fall by 1 nat;
   train_profile -- two more steps of the same configuration under
              torch.profiler: device time by kernel and group, and the
              card's idle share (not part of the main path's counts);
7. parity  -- one microbatch (B=8) of the same model through the kernels
              and through the naive path: f32 loss and gradient norm
              within 1e-5 and 1e-4 relative; bf16 held by the triangle
              rule against the naive f32 path;
8. timing  -- the fused kernels at one training microbatch's shapes, as
              in phase 4, and the forward also at one train_long
              microbatch (B=4, T=2048); yardsticks from CUDA graphs on the
              already normed and roped q/k/v: SDPA forward plus the
              forward pre-pass for the forward (the same function), SDPA
              forward + backward for the backward (attention alone); the
              forward's two launches and the combined backward's three
              timed apart under torch.profiler;
9. flash_kernel -- the flash kernels (forward, dq, dk/dv) against their
              plain versions on the card: the shakespeare_char geometry
              (B=4, T=256, H=6, C=64), GQA at C=64 (H=8, Hkv=2, T=512) and
              C=128 (H=4, T=1024), each with dropout 0.2 and 0, f32 and
              bf16; and the train_char microbatch itself (B=64, bf16,
              dropout 0.2) on contiguous inputs and on the strided views
              the model passes (see ``flash_inputs``, ``flash_readings``);
              the same rule must refuse the kernels' outputs against the
              plain version run at seed + 1 (dropout) or with k and v one
              row off (no dropout); the delta that the dq kernel forms
              and writes is held to the plain delta (f32 rule);
10. train_char -- the training main path on ``shakespeare_char`` at full
              width and depth (6 layers, 6 heads of 64, width 384, T=256,
              vocab 65; dropout 0.2, remat "full", its 64 x 256 batch,
              bf16 compute) for 100 steps on the corpus of
              ``data/shakespeare_char/prepare.py --synthetic``; the flash
              and fused launches are counted around the run alone and must
              equal the shapes' count; the loss must fall by 1 nat;
   train_char_profile -- two more steps under torch.profiler, as
              train_profile;
11. parity_char -- one microbatch of the char model, dropout drawn, f32,
              through the flash kernels and through the naive path (same
              attention masks from the counter hash, same residual masks
              from the same keys): loss within 1e-5 and gradient norm
              within 1e-4 relative;
12. timing -- the flash kernels at one char microbatch (B=64, H=6, T=256,
              C=64, bf16, rate 0.2) beside their plain versions, bounds
              and SDPA with dropout 0.2 as a yardstick (all as device
              time from CUDA graphs): dq given delta and forming it, and
              the whole backward, whose profile must show the dq and
              dk/dv kernels alone;
13. split_kernel -- the split route's kernels (T above the combined
              kernel's cap: the bf16 pre-pass, the dq and dk/dv kernels)
              and the fused forward at T=2048 against their plain
              versions: the openwebtext geometry (B=2, T=2048, H=12, C=64)
              and a GQA one (B=1, H=8, Hkv=2, C=128), f32 and bf16, by
              ``fused_readings``' rule (the pre-pass's q^ and k^ by
              ``hold``), shifted RoPE tables refused; at T=1024 the split
              route held against the combined kernel;
14. norm_kernel -- the fused RMSNorm forward and backward against their
              plain versions: [8192, 768] bf16 and f32, with and without
              a weight, eps 1e-6 and 1e-5, and 4099 rows, held by
              ``hold``; rows shifted by one refused;
15. train_long -- ``train()`` on ``openwebtext`` at block_size 2048 with
              norm_impl "fused" (8 x 2048 tokens a step in 2
              microbatches, 10 steps, the Zipf data): the split kernels,
              never the combined one, and the norm kernels, launches
              counted around the run alone against their formulas
              (pre-pass = dq = dk/dv = n_layer x train microbatches);
              remat resolves to "none"; the loss falls;
   train_long_profile -- two more steps of that configuration under
              torch.profiler, as train_profile, the split route (pre-pass,
              dq, dk/dv) and the norm kernels grouped apart;
16. parity_long -- one microbatch (B=4, T=2048) of that model through the
              fused attention and norm and through the naive attention
              and plain norm: the parity phase's limits;
17. serve_norm -- the serve cell with norm_impl "fused": norm launches =
              (2 n_layer + 1) x model forwards; one decode window's
              logits held to the plain-norm model's;
18. timing -- the split route at B=4, T=2048 and, beside the combined
              kernel, at B=8, T=1024: the pre-pass, the dq and dk/dv
              kernels alone (given q^ and k^) and the route whole, the
              route's kernels apart under the profiler; the norm kernels at
              [8192, 768] bf16; each beside its plain version, bound and
              library call (SDPA forward + backward, alone and with the
              pre-pass added; F.rms_norm);
19. kernels -- one JSON object listing every kernel of the port.

The last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import typing as tp

import numpy as np
import torch

# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

DEVICE = "cuda"
SEED = 0
SERVE = dict(slots=8, window=4, page_size=16)
N_REQUESTS, MAX_NEW = 16, 64
# kernel-phase geometries: (name, Hkv, G, C); S=8, PS=16, Pmax=64, R=4
GEOMS = [("openwebtext", 12, 1, 64), ("gqa", 8, 4, 128)]
S, PS, PMAX, R = 8, 16, 64, 4
# empty, mid-page, page-aligned, ..., full table
LENS = [0, 7, 16, 200, 512, 777, 1000, PMAX * PS]
# train_kernel geometries: (name, B, T, H, Hkv, C)
FUSED_GEOMS = [("openwebtext", 2, 1024, 12, 12, 64), ("gqa", 2, 512, 8, 2, 128)]
FUSED_OUTS = ("out", "lse", "dqkv", "dwq", "dwk")
# the train phase: overrides of the openwebtext experiment, and its data
TRAIN_SET = dict(batch_size=16, g_accum_iters=2, max_steps=20,
                 warmup_steps=5, lr_decay_steps=20, eval_interval=10,
                 eval_batches=2, ckpt_interval=10, log_interval=1)
DATA_TOKENS = 4 << 20  # per split, uint16
ZIPF_IDS, ZIPF_EXP = 4096, 1.1
TRAIN_TIMING = dict(b=8, t=1024, h=12, hkv=12, c=64)  # one microbatch
# flash_kernel geometries: (name, B, T, H, Hkv, C); each at these rates
FLASH_GEOMS = [("shakespeare_char", 4, 256, 6, 6, 64),
               ("gqa", 2, 512, 8, 2, 64), ("c128", 2, 1024, 4, 4, 128)]
FLASH_RATES = (0.2, 0.0)
FLASH_OUTS = ("out", "lse", "dq", "dk", "dv", "delta")
FLASH_SEED = -12345
# the train_char phase: overrides of the shakespeare_char experiment (its
# batch, accumulation, dropout and remat stay); warmup and decay cut to
# the run, one save at the end
CHAR_SET = dict(max_steps=100, warmup_steps=10, lr_decay_steps=100,
                eval_interval=50, eval_batches=20, ckpt_interval=1000,
                log_interval=1)
CHAR_TIMING = dict(b=64, t=256, h=6, hkv=6, c=64, rate=0.2)  # one microbatch
# split_kernel geometries: (name, B, T, H, Hkv, C), T above the combined cap
SPLIT_GEOMS = [("openwebtext", 2, 2048, 12, 12, 64),
               ("gqa", 1, 2048, 8, 2, 128)]
SPLIT_OUTS = ("dq", "dwq", "dk_h", "dv_h", "dwk")
SPLIT_VS_COMBINED_T = 1024  # a T both backward routes take
# the train_long phase: openwebtext at a 2048-token context with the fused
# norm; its model overrides, then the experiment's
LONG_MODEL = dict(block_size=2048, norm_impl="fused")
LONG_SET = dict(batch_size=8, g_accum_iters=2, max_steps=10, warmup_steps=3,
                lr_decay_steps=10, eval_interval=5, eval_batches=1,
                ckpt_interval=1000, log_interval=1)
LONG_TIMING = dict(b=4, t=2048, h=12, hkv=12, c=64)  # one microbatch
NORM_SHAPES = [(8192, 768), (4099, 768)]  # rows: a train microbatch; ragged
NORM_EPS = (1e-6, 1e-5)  # the block norms, ln_f
NORM_BUFS = 8  # norm timing rotates over this many inputs (past the L2)


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


def paged_inputs(hkv, g, c, dtype, lens, layers=2, seed=0, pmax=PMAX):
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
    bt = torch.full((len(lens), pmax), num_pages, dtype=torch.int32)
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


def pool_copy(serving, pool, dtype):
    """A copy of ``pool`` in ``dtype`` (an int8 pool stays int8, with
    copies of its scale planes)."""
    if pool.quantized:
        return serving.PagedKVPool(pool.k.clone(), pool.v.clone(),
                                   pool.page_size, pool.scale_k.clone(),
                                   pool.scale_v.clone())
    return serving.PagedKVPool(pool.k.to(dtype, copy=True),
                               pool.v.to(dtype, copy=True), pool.page_size)


def window_agreement(model, serving, tol_frac=None, plain_model=None,
                     **engine_kw):
    """One decode window through the kernel and through the plain path,
    from the same engine state (8 prefilled requests). With ``tol_frac``
    the logits agree within that fraction of the largest logit. Without
    it (a bf16 model) the plain path also runs in f32 on the same weights
    and pages upcast, and the limit is twice the plain bf16 path's
    distance from it: were the kernel path no further from the f32 path
    than the plain bf16 path is, the two bf16 paths could differ by at
    most that (the triangle inequality). ``engine_kw`` (``quant``,
    ``kv_quant``) goes to the engine; its model serves all runs, and an
    int8 pool stays int8 in the f32 run. With ``plain_model`` (the same
    weights, another model path: plain norms) the plain runs take that
    model through the paged kernel, so the check holds the model path
    alone."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE, **engine_kw)
    model = eng.model
    for p in prompts(model.config.vocab_size)[: SERVE["slots"]]:
        eng.submit(p, MAX_NEW)
    eng.step()  # admission, prefill, one window: the pages hold real rows
    eng._ensure_growth()  # the page top-up step() makes before a window
    dev = eng.device
    state = [torch.from_numpy(a).to(dev) for a in (
        eng.bt, eng.pooled_len, eng.done, eng.emitted, eng.budget, eng.eos)]
    ref_kind, ref_model = (("reference", model) if plain_model is None
                           else ("kernel", plain_model))
    runs = [("kernel", model, eng.pool.dtype),
            (ref_kind, ref_model, eng.pool.dtype)]
    if tol_frac is None:
        runs.append((ref_kind, copy.deepcopy(ref_model).float(),
                     torch.float32))
    outs, window_ms = [], []
    for kind, m, pool_dtype in runs:
        pool = pool_copy(serving, eng.pool, pool_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serving.decode_window(
            m, pool, eng.logits.clone(), *state, eng.seeds.tolist(),
            eng.emitted.tolist(), window=eng.window, rope_len=eng.block,
            paged_kernel=kind,
        )[0])
        torch.cuda.synchronize()
        window_ms.append(1e3 * (time.perf_counter() - t0))
    return {**hold_logits(outs, tol_frac, "window"),
            "window_ms_kernel": window_ms[0],
            "window_ms_plain": window_ms[1]}


def hold_logits(outs, tol_frac, what: str):
    """Logits through the kernel (``outs[0]``) against the plain path
    (``outs[1]``): within ``tol_frac`` of the largest logit, or, without
    it, within twice the plain path's distance from the plain path in
    f32 (``outs[2]``)."""
    a, b = outs[0], outs[1]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"non-finite logits in the {what} check")
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
    if not err <= tol:
        raise AssertionError(f"{what} logits disagree: {err} > {tol}")
    return {"max_abs_err": err, "tol": tol, "tol_rule": rule, **extra,
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean()
            .item(), "max_abs_logit": b.abs().max().item()}


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


def decode_bound(q, pk, lens, r, rr_bytes_row, extra_bytes=0):
    """Least time for one launch: bytes moved (q read, out written, the
    live K and V rows, the valid recent rows, the live table entries and
    the lengths, plus ``extra_bytes``: an int8 pool's live page scales)
    over HBM bandwidth, against the QK and PV multiply-adds over the peak
    rate of the pool's type."""
    s, hkv, g, c = q.shape
    esz = pk.element_size()
    live = int(lens.sum().item())
    ps = pk.shape[-1]
    pages = sum(-(-int(n) // ps) for n in lens.tolist())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * live * hkv * c * esz
              + 2 * s * hkv * (r + 1) * rr_bytes_row
              + 4 * pages + 4 * s + extra_bytes)
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


# -- serving with speculation: the paged verify kernel ---------------------

SPEC = dict(slots=8, page_size=16, speculate=4)
VERIFY_TS = (2, 5, 8)  # candidate rows per slot in the verify_kernel phase
MOTIF = 8  # the repetitive half's motif length
SAMPLED = dict(temperature=0.8, top_k=50, seed=3)


def verify_inputs(hkv, g, c, tt, dtype, starts, layers=2, seed=0,
                  pmax=PMAX):
    """Random pools, queries and candidate rows on the card; every slot
    owns distinct pages for its resident tokens and the dispatch's rows,
    and its table pads hold the sentinel page id."""
    gen = torch.Generator().manual_seed(seed)
    live = [-(-(n + tt) // PS) for n in starts]
    num_pages = sum(live) + 1
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    s = len(starts)
    q = f(s, hkv, g, tt, c)
    kc, vc = f(s, hkv, tt, c), f(s, hkv, tt, c)
    pk = f(layers, num_pages, hkv, c, PS)
    pv = f(layers, num_pages, hkv, c, PS)
    bt = torch.full((s, pmax), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    dev = torch.device(DEVICE)
    out = [a.to(dev, dtype) for a in (q, kc, vc, pk, pv)]
    return out + [bt.to(dev), torch.tensor(starts, dtype=torch.int32,
                                            device=dev)]


def plain32_verify(pa, q, kc, vc, pk, pv, bt, st, layer):
    """The plain verify version on the same inputs upcast to f32."""
    return pa.paged_verify_attention_reference(
        q.float(), kc.float(), vc.float(), pk.float(), pv.float(), bt, st,
        layer)


def verify_peek(q, kc, vc, pk, pv, bt, st, layer):
    """A faulted plain verify in f32: row t also sees candidate row t + 1
    (the self mask one row too wide)."""
    s, hkv, g, t, c = q.shape
    num_pages, ps = pk.shape[1], pk.shape[-1]
    w = bt.shape[1] * ps
    idx = bt.long().clamp(0, num_pages - 1)
    ck, cv = (pool[layer][idx].permute(0, 2, 3, 1, 4).reshape(s, hkv, c, w)
              .float() for pool in (pk, pv))
    cols = torch.arange(w, device=q.device)
    mask_pool = torch.where(cols[None] < st[:, None].long(), 0.0,
                            -float("inf"))[:, None, None, None, :]
    ii = torch.arange(t, device=q.device)
    mask_self = torch.where(ii[None, :] <= ii[:, None] + 1, 0.0,
                            -float("inf"))
    qf = q.float()
    scores = torch.cat([
        torch.einsum("shgtc,shcw->shgtw", qf, ck) + mask_pool,
        torch.einsum("shgtc,shjc->shgtj", qf, kc.float()) + mask_self,
    ], dim=-1)
    probs = torch.softmax(scores / c ** 0.5, dim=-1)
    return (torch.einsum("shgtw,shcw->shgtc", probs[..., :w], cv)
            + torch.einsum("shgtj,shjc->shgtc", probs[..., w:], vc.float()))


def phase_verify_kernel(pa) -> float:
    """The verify kernel against its plain version (:func:`hold`) at both
    geometries, bf16 and f32, T in VERIFY_TS, resident lengths ``LENS``
    capped at W - T. The same check must refuse the kernel's output
    against (a) a plain run with each slot's last resident column
    dropped and (b) a plain run whose self mask lets row t see row t + 1;
    the least err/tol over the slots is printed for each."""
    worst = 0.0
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            for tt in VERIFY_TS:
                starts = [min(n, PMAX * PS - tt) for n in LENS]
                args = verify_inputs(hkv, g, c, tt, dtype, starts)
                got = pa.paged_verify_attention(*args, 1)
                torch.cuda.synchronize()
                ref = pa.paged_verify_attention_reference(*args, 1)
                ref32 = plain32_verify(pa, *args, 1)
                err, ratio = hold(got, ref32)
                dropped = plain32_verify(pa, *args[:6],
                                         (args[6] - 1).clamp_min(0), 1)
                drop_ratio = min(hold(got[i], dropped[i])[1]
                                 for i, n in enumerate(starts) if n > 0)
                peek = verify_peek(*args, 1)
                peek_ratio = min(hold(got[i], peek[i])[1]
                                 for i in range(len(starts)))
                # row t is the decode kernel's step t with the candidate
                # rows as recent rows: the same columns, split and summed
                # alike, so the same bits
                q, kc, vc, pk, pv, bt, st = args
                steps_equal = all(torch.equal(
                    got[:, :, :, t], pa.paged_decode_attention(
                        q[:, :, :, t].contiguous(), pk, pv, bt, st, kc, vc,
                        t, 1)) for t in range(tt))
                emit({"phase": "verify_kernel",
                      "kernel": "paged_verify_attention", "geometry": name,
                      "hkv": hkv, "g": g, "c": c, "t": tt,
                      "dtype": str(dtype).split(".")[-1], "starts": starts,
                      "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      "max_abs_err_vs_plain_same_dtype":
                          (got.float() - ref.float()).abs().max().item(),
                      "dropped_column_min_slot_err_over_tol": drop_ratio,
                      "self_peek_min_slot_err_over_tol": peek_ratio,
                      "rows_equal_decode_steps": steps_equal})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"verify kernel disagrees with its plain version: "
                        f"{name} {dtype} T={tt}: {ratio} x the tolerance")
                if not (drop_ratio > 1.0 and peek_ratio > 1.0):
                    raise AssertionError(
                        f"the check passes a fault: {name} {dtype} T={tt}: "
                        f"dropped column {drop_ratio}, self peek "
                        f"{peek_ratio}")
                if not steps_equal:
                    raise AssertionError(
                        f"verify rows differ from decode steps: {name} "
                        f"{dtype} T={tt}")
                worst = max(worst, err)
    return worst


LONG_PMAX = 2048  # pages of PS in the long_table phase: 32,768 tokens
LONG_LENS = [LONG_PMAX * PS, 9001, 5]


def phase_long_table(pa) -> float:
    """Both paged kernels over a 32,768-token table (Pmax = 2,048 pages of
    16; slots at the full table, mid-table and a few tokens) at both
    geometries, bf16, held to the plain version (:func:`hold`): decode at
    r = R - 1, verify at T = speculate + 1. The split block's shared
    memory does not grow with the table, so this is the serve cells'
    kernel, not a long-context variant."""
    worst = 0.0
    tt = SPEC["speculate"] + 1
    for name, hkv, g, c in GEOMS:
        args = paged_inputs(hkv, g, c, torch.bfloat16, LONG_LENS,
                            pmax=LONG_PMAX)
        got = pa.paged_decode_attention(*args, R - 1, 1)
        torch.cuda.synchronize()
        derr, dratio = hold(got, plain32(pa, *args, R - 1, 1))
        starts = [min(n, LONG_PMAX * PS - tt) for n in LONG_LENS]
        vargs = verify_inputs(hkv, g, c, tt, torch.bfloat16, starts,
                              pmax=LONG_PMAX)
        vgot = pa.paged_verify_attention(*vargs, 1)
        torch.cuda.synchronize()
        verr, vratio = hold(vgot, plain32_verify(pa, *vargs, 1))
        plan = pa.kernel_plan(g * tt, c, PS, LONG_PMAX, torch.bfloat16, tt)
        emit({"phase": "long_table", "geometry": name, "hkv": hkv, "g": g,
              "c": c, "pmax": LONG_PMAX, "ps": PS, "lens": LONG_LENS,
              "verify_starts": starts, "t": tt, "r": R - 1,
              "dtype": "bfloat16", "plan_verify": plan,
              "decode_max_abs_err": derr, "decode_err_over_tol": dratio,
              "verify_max_abs_err": verr, "verify_err_over_tol": vratio})
        if not (dratio <= 1.0 and vratio <= 1.0):
            raise AssertionError(
                f"long table: {name}: decode {dratio}, verify {vratio} x tol")
        worst = max(worst, derr, verr)
        del args, vargs, got, vgot
        gc.collect()
        torch.cuda.empty_cache()
    return worst


def spec_prompts(vocab: int):
    """The serve_spec traffic: the first eight serve prompts, then eight
    repetitive ones, a seeded 8-token motif tiled to 64, 128, ..., 512."""
    motif = np.random.default_rng(SEED + 1).integers(0, vocab, size=MOTIF)
    rep = [np.tile(motif, n // MOTIF).astype(np.int32)
           for n in range(64, 513, 64)]
    return prompts(vocab)[:8] + rep


def serve_run(serving, model, ps, **kw):
    """Serve ``ps`` (request seed = index), ``MAX_NEW`` tokens each, on
    one engine; host clock around submit and drain."""
    eng = serving.ServingEngine(model, slots=SPEC["slots"],
                                page_size=SPEC["page_size"], device=DEVICE,
                                **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [finished[r] for r in rids]
    if not all(len(r.tokens) == MAX_NEW for r in reqs):
        raise AssertionError(f"lengths {[len(r.tokens) for r in reqs]}")
    if eng.alloc.free_pages != eng.alloc.num_pages:
        raise AssertionError("pages still held after the run")
    eng.alloc.check()
    return eng, reqs, wall


def run_record(eng, reqs, wall):
    ttft = sorted(1e3 * (r.first_token_time - r.submit_time) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "dispatches": eng.decode_dispatches,
            "tokens_per_dispatch": tokens / eng.decode_dispatches}


def spec_half(reqs):
    """A half's drafts and acceptance. Without EOS, and with drafts cut
    to the budget, each dispatch a request takes part in emits 1 + its
    accepted drafts, so its dispatches are tokens - accepted."""
    tokens = sum(len(r.tokens) for r in reqs)
    drafted = sum(r.spec_drafted for r in reqs)
    accepted = sum(r.spec_accepted for r in reqs)
    return {"tokens": tokens, "drafted": drafted, "accepted": accepted,
            "acceptance": accepted / max(1, drafted),
            "tokens_per_dispatch_per_slot": tokens / (tokens - accepted)}


def verify_agreement(model, serving, tol_frac=None, **engine_kw):
    """One verify dispatch's logits ``[S, T, V]`` through the kernel and
    through the plain path, from the same engine state: the repetitive
    half prefilled and served until the proposer drafts (at most four
    dispatches), then the next dispatch's rows (:func:`hold_logits`).
    ``engine_kw`` as in :func:`window_agreement`."""
    from midgpt_tpu_torch.models.gpt import verify_tokens_paged

    eng = serving.ServingEngine(model, **SPEC, device=DEVICE, **engine_kw)
    model = eng.model
    for p in spec_prompts(model.config.vocab_size)[SPEC["slots"]:]:
        eng.submit(p, MAX_NEW)
    for _ in range(4):
        eng.step()  # (admission, prefill,) one verify dispatch
        eng._ensure_growth()  # the page top-up step() makes first
        drafts, n_draft, _ = eng._draft(eng._active_slots())
        if n_draft.sum():
            break
    dev = eng.device
    cand = torch.cat([eng.logits.argmax(-1).to(torch.int32)[:, None],
                      torch.from_numpy(drafts).to(dev)], dim=1)
    bt = torch.from_numpy(eng.bt).to(dev)
    start = torch.from_numpy(eng.pooled_len).to(dev)
    runs = [("kernel", model, eng.pool.dtype),
            ("reference", model, eng.pool.dtype)]
    if tol_frac is None:
        runs.append(("reference", copy.deepcopy(model).float(), torch.float32))
    outs, ms = [], []
    for kind, m, pool_dtype in runs:
        pool = pool_copy(serving, eng.pool, pool_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(verify_tokens_paged(
            m, cand, start, pool.k, pool.v, bt, eng.block, paged_kernel=kind,
            pool_sk=pool.scale_k, pool_sv=pool.scale_v)[0].float())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {**hold_logits(outs, tol_frac, "verify"),
            "rows": list(cand.shape), "drafted": int(n_draft.sum()),
            "verify_ms_kernel": ms[0], "verify_ms_plain": ms[1]}


def spec_profile(serving, model, ps, gpu, dispatches: int = 8):
    """Where a verify dispatch's time goes: an engine on the serve_spec
    traffic, admitted and past its first dispatch, then ``dispatches``
    steps under ``torch.profiler`` with the host clock around them."""
    import re

    from torch.profiler import ProfilerActivity, profile

    eng = serving.ServingEngine(model, **SPEC, device=DEVICE)
    for i, p in enumerate(ps[SPEC["slots"]:]):
        eng.submit(p, MAX_NEW, seed=i)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, host_calls = {}, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / dispatches)
        elif e.key.startswith("aten::"):
            host_calls += e.count
    groups = {"paged verify kernel": r"paged_attn_kernel",
              "matmul (cuBLAS)": r"nvjet|gemm|xmma|cutlass|cublas",
              "elementwise and reductions": r"at::native"}
    by_group = {k: 0.0 for k in groups}
    by_group["other"] = 0.0
    for kname, ms in kernels.items():
        hit = next((k for k, pat in groups.items()
                    if re.search(pat, kname, re.IGNORECASE)), "other")
        by_group[hit] += ms
    busy = sum(kernels.values())
    dispatch_ms = wall_ms / dispatches
    return {"dispatches": dispatches, "dispatch_ms_host": dispatch_ms,
            "device_busy_ms_per_dispatch": busy,
            "idle_share": (1 - busy / dispatch_ms) if busy else None,
            "device_ms_per_dispatch_by_group": by_group,
            "host_aten_calls_per_dispatch": host_calls / dispatches,
            "gpu": gpu}


def phase_serve_spec(pa, serving, GPT, cfg, gpu):
    """The speculative serving main path at the full width of
    ``openwebtext`` (bf16 weights and pool): ServingEngine(slots=8,
    page_size=16, speculate=4) on 16 greedy requests of 64 new tokens,
    eight of the serve prompts and eight repetitive ones. Launch counts
    are read around that run alone: verify kernel launches must equal
    n_layer x verify dispatches, decode kernel launches 0. Beside it:
    the same requests spec-off (window=4), timed; the share of requests
    whose spec-on stream equals spec-off (printed, not asserted: cuBLAS
    may sum an [S*T, D] row otherwise than an [S, D] one); one verify
    dispatch's logits through the kernel against the plain path (bf16
    and f32); sampled spec-on twice, whose streams must repeat and begin
    with the spec-off sampled run's first tokens; a profile."""
    model = GPT.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE,
                     dtype=torch.bfloat16)
    ps = spec_prompts(cfg.vocab_size)
    # warm-up (the verify shapes' cuBLAS handles): a short run, not counted
    serving.generate_served(model, ps[:2], 4, device=DEVICE, speculate=4,
                            page_size=SPEC["page_size"])
    torch.cuda.synchronize()

    pa.paged_verify_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    eng, reqs, wall = serve_run(serving, model, ps,
                                speculate=SPEC["speculate"])
    launches = pa.paged_verify_attention.launches
    decode_launches = pa.paged_decode_attention.launches
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError("token id outside the vocabulary")
    if (launches != cfg.n_layer * eng.verify_dispatches or launches == 0
            or decode_launches != 0):
        raise AssertionError(
            f"verify launches {launches} != n_layer x verify dispatches "
            f"{cfg.n_layer} x {eng.verify_dispatches}, or decode launches "
            f"{decode_launches} != 0")
    halves = {"random": spec_half(reqs[:8]), "repetitive": spec_half(reqs[8:])}
    rep = halves["repetitive"]
    if not (rep["accepted"] > 0 and rep["tokens_per_dispatch_per_slot"] > 1):
        raise AssertionError(f"no draft accepted on repetitive text: {rep}")
    on = run_record(eng, reqs, wall)

    eng_off, reqs_off, wall_off = serve_run(serving, model, ps, window=4)
    off = run_record(eng_off, reqs_off, wall_off)
    diverge = []
    for i, (a, b) in enumerate(zip(reqs, reqs_off)):
        if a.tokens != b.tokens:
            diverge.append([i, next(j for j, (x, y) in enumerate(
                zip(a.tokens, b.tokens)) if x != y)])

    check_bf16 = verify_agreement(model, serving)
    model32 = GPT.init(cfg, torch.Generator().manual_seed(SEED),
                       device=DEVICE, dtype=torch.float32)
    check_f32 = verify_agreement(model32, serving, 1e-4)
    del model32

    sampled = [serve_run(serving, model, ps, speculate=SPEC["speculate"],
                         **SAMPLED) for _ in range(2)]
    sampled_off = serve_run(serving, model, ps, window=4, **SAMPLED)
    streams = [[r.tokens for r in run[1]] for run in sampled]
    if streams[0] != streams[1]:
        raise AssertionError("sampled spec-on streams differ between runs")
    firsts = [r.tokens[0] for r in sampled_off[1]]
    if [x[0] for x in streams[0]] != firsts:
        raise AssertionError("sampled spec-on first tokens != spec-off's")
    if streams[0] == [r.tokens for r in reqs]:
        raise AssertionError("sampled streams equal the greedy ones")
    prof = spec_profile(serving, model, ps, gpu)
    rec = {
        "phase": "serve_spec", "config": "openwebtext", "dtype": "bfloat16",
        **SPEC, "requests": len(ps), "max_new_tokens": MAX_NEW,
        "prompt_lens": [int(p.size) for p in ps],
        "spec_on": on, "spec_off_window_4": off,
        "verify_dispatches": eng.verify_dispatches,
        "verify_kernel_launches": launches,
        "decode_kernel_launches": decode_launches,
        "stats": eng.stats(), "halves": halves,
        "greedy_equal_share": 1 - len(diverge) / len(ps),
        "greedy_first_divergence": diverge,
        "verify_check_bf16": check_bf16, "verify_check_f32": check_f32,
        "sampled": {**SAMPLED, "repeat": True, "first_tokens_equal": True,
                    "tokens_per_s": [run_record(*run)["tokens_per_s"]
                                     for run in sampled],
                    "tokens_per_s_spec_off":
                        run_record(*sampled_off)["tokens_per_s"],
                    "acceptance": sampled[0][0].stats()[
                        "spec_acceptance_rate"]},
        "profile": prof, "gpu": gpu,
    }
    emit(rec)
    del model
    return rec


def verify_bound(q, pk, starts, row_esz=None, extra_bytes=0):
    """Least time for one verify launch: bytes moved (q read, out written,
    the candidate rows' K and V at ``row_esz`` bytes an element, the pool's
    by default, the live K and V rows of the pool, the live table entries
    and the lengths, plus ``extra_bytes``) over HBM bandwidth, against the
    QK and PV multiply-adds (row t of a slot over its resident columns
    and self rows 0..t) over the peak rate of the pool's type."""
    s, hkv, g, tt, c = q.shape
    esz = pk.element_size()
    row_esz = esz if row_esz is None else row_esz
    ps = pk.shape[-1]
    live = sum(starts)
    pages = sum(-(-n // ps) for n in starts)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * s * hkv * tt * c * row_esz
              + 2 * live * hkv * c * esz + 4 * pages + 4 * s + extra_bytes)
    flops = 4 * c * hkv * g * (tt * live + s * tt * (tt + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[pk.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing_verify(pa, cfg, gpu):
    """The verify kernel at the serve_spec shapes: bf16 pool, 8 slots with
    resident lengths from the serve prompts' spread plus 32 generated
    tokens, T = speculate + 1 rows. As in :func:`phase_timing`, the pool
    holds 4 x n_layer layers and launches rotate over them."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    tt = SPEC["speculate"] + 1
    starts = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    args = verify_inputs(hkv, g, c, tt, torch.bfloat16, starts, layers=nl,
                         seed=1)

    def kernel(i):
        return pa.paged_verify_attention(*args, i % nl)

    def plain(i):
        return pa.paged_verify_attention_reference(*args, i % nl)

    ms = device_ms(kernel, reps=2 * nl)
    plain_ms = device_ms(plain, reps=nl // 2)
    eager = eager_ms(kernel, reps=2 * nl)
    got = pa.paged_verify_attention(*args, 0)
    err, ratio = hold(got, plain32_verify(pa, *args, 0))
    if not ratio <= 1.0:
        raise AssertionError(f"serve-shape verify error {err}: {ratio} x tol")
    bound_ms, bound_by = verify_bound(args[0], args[3], starts)
    rec = {"phase": "timing", "kernel": "paged_verify_attention",
           "shape": {"S": S, "Hkv": hkv, "G": g, "T": tt, "C": c, "PS": PS,
                     "Pmax": PMAX, "starts": starts, "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms, "eager_ms": eager,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library": "none: no PyTorch call walks a block table",
           "launches_per_dispatch": cfg.n_layer,
           "frac_of_bound": bound_ms / ms, "max_abs_err": err,
           "err_over_tol": ratio, "gpu": gpu}
    emit(rec)
    return rec


# -- int8 serving: the int8 branch of the paged kernels ---------------------

INT8 = dict(quant="int8", kv_quant="int8")


def quantize_pages(pa_args, pool_idx):
    """The float pools at ``pool_idx`` of a kernel's argument list as an
    int8 pool: each (layer, page, KV head) on its own po2 grid
    (``po2_ceil(absmax / 127)``), as the engine's page-birth scales put
    real rows. Returns the new argument list (pools int8, self rows bf16)
    and the scale planes ``[L, NP, Hkv]``."""
    from midgpt_tpu_torch.quant import po2_ceil_exact

    args = list(pa_args)
    planes = []
    for i in pool_idx:
        x = args[i].float()
        plane = po2_ceil_exact(x.abs().amax((-1, -2)) / 127.0)
        args[i] = torch.round(x / plane[..., None, None]).to(torch.int8)
        planes.append(plane)
    return args, planes


def gathered(planes, bt, layer):
    """Each slot's page scales ``[S, Pmax, Hkv]`` (pads clipped)."""
    return [p[layer][bt.long().clamp(0, p.shape[1] - 1)] for p in planes]


def int8_case(kind, hkv, g, c, dtype, lens, tt=None, layers=2, seed=0):
    """An int8-pool case for one kernel branch: ``(args, planes)`` where
    ``args`` are the wrapper's positional inputs before the layer (q in
    ``dtype``, pools int8, self rows bf16) and ``planes`` the pools'
    scale planes."""
    if kind == "decode":
        base = paged_inputs(hkv, g, c, torch.float32, lens, layers, seed)
        args, planes = quantize_pages(base, (1, 2))
        rows = (5, 6)
    else:
        base = verify_inputs(hkv, g, c, tt, torch.float32, lens, layers, seed)
        args, planes = quantize_pages(base, (3, 4))
        rows = (1, 2)
    args[0] = args[0].to(dtype)
    for i in rows:
        args[i] = args[i].to(torch.bfloat16)
    return args, planes


def int8_run(pa, kind, args, planes, layer, r=None, plain=False):
    """The int8 branch (or its plain version, in f32 on the upcast q and
    self rows) on ``args`` with the scales gathered from ``planes``."""
    bt = args[3] if kind == "decode" else args[5]
    scales = gathered(planes, bt, layer)
    if kind == "decode":
        if plain:
            q, pk, pv, bt, pl, rk, rv = args
            return pa.paged_decode_attention_reference(
                q.float(), pk, pv, bt, pl, rk.float(), rv.float(), r, layer,
                *scales)
        return pa.paged_decode_attention(*args, r, layer, *scales)
    if plain:
        q, kc, vc, pk, pv, bt, st = args
        return pa.paged_verify_attention_reference(
            q.float(), kc.float(), vc.float(), pk, pv, bt, st, layer, *scales)
    return pa.paged_verify_attention(*args, layer, *scales)


def phase_kernel_int8(pa) -> float:
    """Both int8 branches against their plain versions (:func:`hold`):
    both geometries, ragged lengths, decode r in (0, R-1) and verify T in
    VERIFY_TS, q bf16 and f32. The same check must refuse the kernel's
    output against the plain version (a) with each live slot's first
    page's scale doubled and (b) with the codes read without their
    scales; the least err/tol over the live slots is printed for each."""
    worst, layer = 0.0, 1
    cases = [("decode", {"r": r}) for r in (0, R - 1)]
    cases += [("verify", {"t": tt}) for tt in VERIFY_TS]
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            for kind, at in cases:
                tt = at.get("t")
                lens = LENS if tt is None else [min(n, PMAX * PS - tt)
                                                for n in LENS]
                args, planes = int8_case(kind, hkv, g, c, dtype, lens, tt)
                bt = args[3] if kind == "decode" else args[5]
                r = at.get("r")
                got = int8_run(pa, kind, args, planes, layer, r)
                torch.cuda.synchronize()
                err, ratio = hold(got, int8_run(pa, kind, args, planes,
                                                layer, r, plain=True))
                live = [i for i, n in enumerate(lens) if n > 0]
                doubled = [p.clone() for p in planes]
                for p in doubled:
                    p[layer, bt[live, 0].long()] *= 2.0
                ones = [torch.ones_like(p) for p in planes]
                faults = {}
                for fname, fp in (("scale_doubled", doubled),
                                  ("codes_unscaled", ones)):
                    ref = int8_run(pa, kind, args, fp, layer, r, plain=True)
                    faults[fname] = min(hold(got[i], ref[i])[1] for i in live)
                emit({"phase": "kernel_int8",
                      "kernel": f"paged_{kind}_attention[int8]",
                      "geometry": name, "hkv": hkv, "g": g, "c": c, **at,
                      "q_dtype": str(dtype).split(".")[-1], "lens": lens,
                      "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      **{f"{k}_min_slot_err_over_tol": v
                         for k, v in faults.items()}})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"int8 {kind} kernel disagrees with its plain "
                        f"version: {name} {dtype} {at}: {ratio} x tol")
                if not min(faults.values()) > 1.0:
                    raise AssertionError(
                        f"the check passes a fault: int8 {kind} {name} "
                        f"{dtype} {at}: {faults}")
                worst = max(worst, err)
    return worst


def projection_bytes_and_ms(model, cfg):
    """One decode step's projections (12 blocks' wqkv, wo, w_up, w_down and
    the head) at 8 rows in bf16: device ms of the bf16 Linears against
    the eager int8 QuantLinears (``w_int8.to(bf16)`` writes a bf16 copy
    of each weight, which the product then reads), and the bytes each
    must move: bf16 2 B a weight; eager int8 1 + 2 + 2 B (read the codes,
    write the copy, read it), activations and scales beside."""
    from midgpt_tpu_torch.quant import quantize_model

    qm = quantize_model(model)
    blk, qblk = model.blocks[0], qm.blocks[0]
    lins = [(blk.attn.wqkv, qblk.attn.wqkv, cfg.n_layer),
            (blk.attn.wo, qblk.attn.wo, cfg.n_layer),
            (blk.mlp.w_up, qblk.mlp.w_up, cfg.n_layer),
            (blk.mlp.w_down, qblk.mlp.w_down, cfg.n_layer),
            (model.lm_head, qm.lm_head, 1)]
    out = {"bf16_ms": 0.0, "int8_eager_ms": 0.0, "bf16_bytes": 0,
           "int8_eager_bytes": 0, "int8_fused_bytes": 0}
    with torch.no_grad():
        for lin, qlin, count in lins:
            d_in, d_out = lin.weight.shape
            x = torch.randn(S, d_in, device=DEVICE, dtype=torch.bfloat16)
            act = 2 * S * (d_in + d_out)
            out["bf16_ms"] += count * device_ms(lambda i: lin(x), reps=16)
            out["int8_eager_ms"] += count * device_ms(lambda i: qlin(x),
                                                      reps=16)
            out["bf16_bytes"] += count * (2 * d_in * d_out + act)
            out["int8_eager_bytes"] += count * (5 * d_in * d_out + act
                                                + 4 * d_out)
            out["int8_fused_bytes"] += count * (d_in * d_out + act
                                                + 4 * d_out)
    del qm
    return out


def phase_serve_int8(pa, serving, GPT, cfg, gpu):
    """The int8 serving main path at the full width and depth of
    ``openwebtext`` (random init from the seed, bf16): ``quant="int8",
    kv_quant="int8"`` on the 16 serve prompts, 64 new tokens each,
    spec-off (window 4) and ``speculate=4``, beside the bf16 engine on the
    same requests in turns (bf16, int8, int8, bf16). Launch counts are
    read around each int8 run alone: spec-off decode launches = n_layer x
    decode steps and no verify launch; spec-on verify launches = n_layer
    x verify dispatches and no decode launch. One window's and one
    verify dispatch's logits through the int8 kernels are held to the
    plain path on the same state (bf16 by the triangle rule, f32 within
    1e-4 of the largest logit)."""
    model = GPT.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE,
                     dtype=torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    # warm-up (the int8 shapes' cuBLAS handles): short runs, not counted
    for spec in (0, SPEC["speculate"]):
        serving.generate_served(model, ps[:2], 4, device=DEVICE,
                                speculate=spec, page_size=PS, **INT8)
    torch.cuda.synchronize()

    runs = {}
    for name, kw in (("bf16_off", dict(window=4)),
                     ("int8_off", dict(window=4, **INT8)),
                     ("int8_on", dict(speculate=SPEC["speculate"], **INT8)),
                     ("bf16_on", dict(speculate=SPEC["speculate"]))):
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        eng, reqs, wall = serve_run(serving, model, ps, **kw)
        runs[name] = (eng, reqs, wall, pa.paged_decode_attention.launches,
                      pa.paged_verify_attention.launches)
    eng, reqs, _, dec, ver = runs["int8_off"]
    if not eng.pool.quantized or eng.pool.k.dtype != torch.int8:
        raise AssertionError("the int8 engine's pool is not int8")
    steps = eng.windows * eng.window
    if dec != cfg.n_layer * steps or dec == 0 or ver != 0:
        raise AssertionError(
            f"int8 spec-off: decode launches {dec} != n_layer x decode "
            f"steps {cfg.n_layer} x {steps}, or verify launches {ver} != 0")
    eng_on, reqs_on, _, dec_on, ver_on = runs["int8_on"]
    if (ver_on != cfg.n_layer * eng_on.verify_dispatches or ver_on == 0
            or dec_on != 0):
        raise AssertionError(
            f"int8 spec-on: verify launches {ver_on} != n_layer x verify "
            f"dispatches {cfg.n_layer} x {eng_on.verify_dispatches}, or "
            f"decode launches {dec_on} != 0")
    for name in ("int8_off", "int8_on"):
        if not all(0 <= t < cfg.vocab_size for r in runs[name][1]
                   for t in r.tokens):
            raise AssertionError(f"{name}: token id outside the vocabulary")
    same = sum(a.tokens == b.tokens for a, b in zip(reqs, reqs_on))
    bf16_same = sum(a.tokens == b.tokens for a, b in
                    zip(reqs, runs["bf16_off"][1]))

    window_bf16 = window_agreement(model, serving, **INT8)
    verify_bf16 = verify_agreement(model, serving, **INT8)
    model32 = GPT.init(cfg, torch.Generator().manual_seed(SEED),
                       device=DEVICE, dtype=torch.float32)
    window_f32 = window_agreement(model32, serving, 1e-4, **INT8)
    verify_f32 = verify_agreement(model32, serving, 1e-4, **INT8)
    del model32
    proj = projection_bytes_and_ms(model, cfg)
    rec = {
        "phase": "serve_int8", "config": "openwebtext", "dtype": "bfloat16",
        **INT8, "slots": SPEC["slots"], "page_size": PS, "window": 4,
        "speculate": SPEC["speculate"], "requests": len(ps),
        "max_new_tokens": MAX_NEW,
        "runs_in_order": list(runs),
        **{name: {**run_record(e, r, w), "decode_launches": d,
                  "verify_launches": v}
           for name, (e, r, w, d, v) in runs.items()},
        "decode_steps": steps, "verify_dispatches": eng_on.verify_dispatches,
        "spec_on_equal_spec_off_streams": same,
        "int8_equal_bf16_streams": bf16_same,
        "pool_bytes_int8": int(eng.pool.k.numel() * 2
                               + eng.pool.scale_k.numel() * 8),
        "pool_bytes_bf16": int(runs["bf16_off"][0].pool.k.numel() * 4),
        "window_check_bf16": window_bf16, "window_check_f32": window_f32,
        "verify_check_bf16": verify_bf16, "verify_check_f32": verify_f32,
        "projections_one_decode_step": proj, "gpu": gpu,
    }
    emit(rec)
    del model
    return rec


def phase_timing_int8(pa, cfg, gpu):
    """The int8 branches at the serve shapes, as :func:`phase_timing` and
    :func:`phase_timing_verify` time the float ones: 8 slots, resident
    lengths from the serve prompts plus 32 tokens, decode r = R - 1 and
    verify T = speculate + 1, q bf16, int8 pages with bf16 self rows;
    launches rotate over 4 x n_layer layers. Bounds count int8 pages,
    each live page's two f32 scales and the bf16 self rows."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    lens = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    tt = SPEC["speculate"] + 1
    out = {}
    for kind, r in (("decode", R - 1), ("verify", None)):
        args, planes = int8_case(kind, hkv, g, c, torch.bfloat16, lens,
                                 None if kind == "decode" else tt,
                                 layers=nl, seed=1)
        bt = args[3] if kind == "decode" else args[5]
        per_layer = [gathered(planes, bt, i) for i in range(nl)]

        def kernel(i, kind=kind, args=args, r=r):
            sc = per_layer[i % nl]
            if kind == "decode":
                return pa.paged_decode_attention(*args, r, i % nl, *sc)
            return pa.paged_verify_attention(*args, i % nl, *sc)

        def plain(i, kind=kind, args=args, r=r):
            sc = per_layer[i % nl]
            if kind == "decode":
                return pa.paged_decode_attention_reference(*args, r, i % nl,
                                                           *sc)
            return pa.paged_verify_attention_reference(*args, i % nl, *sc)

        ms = device_ms(kernel, reps=2 * nl)
        plain_ms = device_ms(plain, reps=nl // 2)
        eager = eager_ms(kernel, reps=2 * nl)
        got = int8_run(pa, kind, args, planes, 0, r)
        err, ratio = hold(got, int8_run(pa, kind, args, planes, 0, r,
                                        plain=True))
        if not ratio <= 1.0:
            raise AssertionError(f"serve-shape int8 {kind} error {err}: "
                                 f"{ratio} x tol")
        pages = sum(-(-n // PS) for n in lens)
        scale_bytes = 2 * 4 * pages * hkv
        if kind == "decode":
            bound_ms, bound_by = decode_bound(args[0], args[1], args[4], r,
                                              c * 2, scale_bytes)
        else:
            bound_ms, bound_by = verify_bound(args[0], args[3], lens,
                                              row_esz=2,
                                              extra_bytes=scale_bytes)
        rec = {"phase": "timing", "kernel": f"paged_{kind}_attention[int8]",
               "shape": {"S": S, "Hkv": hkv, "G": g, "C": c, "PS": PS,
                         "Pmax": PMAX, "lens": lens, "q_dtype": "bfloat16",
                         "pool": "int8", "rows": "bfloat16",
                         **({"r": r, "R": R} if kind == "decode"
                            else {"T": tt})},
               "ms": ms, "plain_ms": plain_ms, "eager_ms": eager,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None,
               "library": "none: no PyTorch call walks a block table",
               "frac_of_bound": bound_ms / ms, "max_abs_err": err,
               "err_over_tol": ratio, "gpu": gpu}
        emit(rec)
        out[kind] = rec
    return out


# -- training: the fused attention kernels and the train main path --------


def fused_inputs(b, t, h, hkv, c, dtype, seed=0):
    """Packed qkv, LN weights, [T, C] rope tables and an output gradient,
    drawn on the CPU from ``seed`` and moved to the card."""
    from midgpt_tpu_torch.models.layers import rope_tables
    from midgpt_tpu_torch.ops.fused_attn import rope_full_tables

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, (h + 2 * hkv) * c, generator=gen)
    wq = 1.0 + 0.1 * torch.randn(c, generator=gen)
    wk = 1.0 + 0.1 * torch.randn(c, generator=gen)
    dout = torch.randn(b, t, h * c, generator=gen)
    sin, cos = rope_full_tables(*(torch.from_numpy(a)
                                  for a in rope_tables(c, t)))
    return [qkv.to(DEVICE, dtype), wq.to(DEVICE), wk.to(DEVICE),
            sin.to(DEVICE), cos.to(DEVICE), dout.to(DEVICE, dtype)]


def fused_run(fa, args, h, hkv, kernel):
    """``(out, lse, dqkv, dwq, dwk)`` through the kernels or the plain
    versions, on the same inputs."""
    qkv, wq, wk, sin, cos, dout = args
    if kernel:
        out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        grads = fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout,
                                       h, hkv)
    else:
        out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos,
                                                        h, hkv)
        grads = fa.fused_attention_backward_reference(
            qkv, wq, wk, sin, cos, out, lse, dout, h, hkv)
    return (out, lse, *grads)


def fused_readings(got, plain, ref32, names=FUSED_OUTS):
    """Per output, its distance from the plain version over the limit (the
    check passes when every reading is at most 1).

    f32 (``ref32 is None``): each element within ``1e-5 + rel * |plain|``,
    rel 1e-5 for the forward's out and lse and 1e-4 for the backward's
    outputs: the forward's two f32 sums only run in another order, while
    the backward chains three sums over T and the LN backward's mean
    subtraction, whose cancellation magnifies rounding differences.

    bf16: the kernels round inside (q, k, P and ds are cast), so each
    output is held by the triangle rule: its largest distance from the
    plain version run in f32 on the upcast inputs (``ref32``) may be at
    most twice the plain bf16 version's own largest distance from it."""
    out = {}
    for name, g, p, r in zip(names, got, plain,
                             ref32 if ref32 is not None else plain):
        if ref32 is None:
            rel = 1e-5 if name in ("out", "lse") else 1e-4
            out[name] = ((g - p).abs() / (1e-5 + rel * p.abs())).max().item()
        else:
            own = (p.float() - r).abs().max().item()
            out[name] = (g.float() - r).abs().max().item() / (2 * own)
    return out


def phase_train_kernel(fa) -> float:
    """Each case is held by :func:`fused_readings`, and the same rule must
    refuse every output of the kernels run with the RoPE tables shifted
    by one position (row t holds position t - 1's angles). Returns the
    largest bf16-kernel-to-bf16-plain distance seen."""
    worst = 0.0
    for name, b, t, h, hkv, c in FUSED_GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = fused_inputs(b, t, h, hkv, c, dtype)
            got = fused_run(fa, args, h, hkv, kernel=True)
            torch.cuda.synchronize()
            plain = fused_run(fa, args, h, hkv, kernel=False)
            ref32 = None
            if dtype == torch.bfloat16:
                ref32 = fused_run(fa, [a.float() for a in args], h, hkv,
                                  kernel=False)
            sound = fused_readings(got, plain, ref32)
            shifted = list(args)
            shifted[3], shifted[4] = (torch.roll(a, 1, 0) for a in args[3:5])
            fault = fused_run(fa, shifted, h, hkv, kernel=True)
            faulted = fused_readings(fault, plain, ref32)
            errs = {n: (g.float() - p.float()).abs().max().item()
                    for n, g, p in zip(FUSED_OUTS, got, plain)}
            emit({"phase": "train_kernel", "geometry": name, "B": b, "T": t,
                  "H": h, "Hkv": hkv, "C": c,
                  "dtype": str(dtype).split(".")[-1],
                  "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                           "(out, lse) / 1e-4 (grads)" if ref32 is None else
                           "max |kernel - plain f32| <= 2 x max |plain bf16 "
                           "- plain f32|"),
                  "sound_err_over_limit": sound,
                  "shifted_rope_err_over_limit": faulted,
                  "max_abs_err_vs_plain_same_dtype": errs})
            bad = [n for n, v in sound.items() if not v <= 1.0]
            if bad:
                raise AssertionError(f"fused kernels disagree with their "
                                     f"plain versions: {name} {dtype} {bad}")
            missed = [n for n, v in faulted.items() if not v > 1.0]
            if missed:
                raise AssertionError(f"the check passes shifted RoPE tables: "
                                     f"{name} {dtype} {missed}")
            if dtype == torch.bfloat16:
                worst = max(worst, *errs.values())
    return worst


def zipf_tokens(n: int, seed: int) -> np.ndarray:
    """``n`` token ids below ZIPF_IDS, P(id k) proportional to
    (k + 1)^-ZIPF_EXP: a stream whose loss has something to learn."""
    p = np.arange(1, ZIPF_IDS + 1, dtype=np.float64) ** -ZIPF_EXP
    rng = np.random.default_rng(seed)
    return rng.choice(ZIPF_IDS, size=n, p=p / p.sum()).astype(np.uint16)


def expected_launches(cfg) -> tp.Tuple[int, int]:
    """Fused forward and backward launches of ``train(cfg)`` from step 0:
    one of each per layer and training microbatch; one forward per layer
    and eval microbatch (two splits at every eval interval, the
    validation split once more at the end; every microbatch of
    ``eval_batches`` batches). remat "none": no recomputed forwards."""
    g = cfg.g_accum_iters
    train_mb = cfg.max_steps * g
    evals = len(range(0, cfg.max_steps, cfg.eval_interval))
    eval_mb = (2 * evals + 1) * cfg.eval_batches * g
    nl = cfg.model.n_layer
    return nl * (train_mb + eval_mb), nl * train_mb


def phase_train(fa, gpu):
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.train import train
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        rundir = os.path.join(tmp, "run")
        cfg = get_config("openwebtext", rundir=rundir, data_dir=data,
                         seed=SEED, **TRAIN_SET)
        fa.fused_attention_fwd.launches = 0
        fa.fused_attention_bwd.launches = 0
        t0 = time.perf_counter()
        final = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fa.fused_attention_fwd.launches,
                    fa.fused_attention_bwd.launches)
        rows = read_metrics(rundir)
        ckpts = sorted(os.listdir(os.path.join(rundir, "checkpoints")))
    losses = final["losses"]
    want = expected_launches(cfg)
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    tps_median = statistics.median(tps)
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = final["loop_s"] - final["eval_s"] - final["ckpt_s"]
    rec = {
        "phase": "train", "config": "openwebtext", "overrides": TRAIN_SET,
        "model": {k: getattr(cfg.model, k) for k in (
            "block_size", "vocab_size", "n_layer", "n_head", "n_embd",
            "attn_impl")},
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "loss_chunk": cfg.loss_chunk, "remat": final["remat"],
        "data": {"tokens_per_split": DATA_TOKENS, "zipf_ids": ZIPF_IDS,
                 "zipf_exponent": ZIPF_EXP, "seed": SEED},
        "losses": losses, "val_loss": final["val_loss"],
        "fused_fwd_launches": launches[0], "fused_bwd_launches": launches[1],
        "launch_formula": "fwd = n_layer x (train microbatches + eval "
                          "microbatches), bwd = n_layer x train microbatches",
        "expected_launches": list(want), "checkpoints": ckpts,
        "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "step_ms": 1e3 * final["loop_s"] / cfg.max_steps,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / tps_median,
        "tokens_per_s_per_step": tps,
        "timing_note": "tokens_per_s, mfu, step_ms: every trained token "
                       "over train()'s loop on the host clock, evals and "
                       "saves included; *_steps_only: the loop less the "
                       "evals and saves; step_ms_median: per-step host "
                       "clock between loss reads (log_interval=1)",
        "flops_per_token": fpt, "peak_flops": peak,
        "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-5:]) <= losses[0] - 1.0:
        raise AssertionError(f"the loss did not fall by 1 nat: {losses}")
    if final["remat"] != "none":
        raise AssertionError(f"remat resolved to {final['remat']}")
    if launches != want or min(launches) == 0:
        raise AssertionError(f"fused launches {launches} != {want}")
    if ckpts != [f"step_{cfg.max_steps - 1:08d}.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    return rec


def phase_train_profile(gpu, name: str = "openwebtext",
                        overrides: tp.Optional[dict] = None,
                        steps: int = 2, long: bool = False):
    """Where a training step's time goes: a train phase's configuration
    (fresh init, one batch of the Zipf stream folded into the
    vocabulary), one warm-up step, then ``steps`` steps under
    ``torch.profiler`` with the host clock around them. Device time is
    summed by kernel and by group; the idle share is 1 - (summed kernel
    time / wall time). ``long``: the train_long configuration
    (``long_config``: block 2048, the fused norm), whose backward takes
    the split route, grouped apart with the norm kernels."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, init_state, make_lr_schedule, make_shadow,
        resolve_auto_knobs, train_step)

    overrides = TRAIN_SET if overrides is None else overrides
    cfg = (long_config(**overrides) if long
           else get_config(name, seed=SEED, **overrides))
    cfg = resolve_auto_knobs(
        cfg, torch.cuda.get_device_properties(0).total_memory)
    g, b, t = cfg.g_accum_iters, cfg.microbatch_size, cfg.model.block_size
    toks = zipf_tokens(g * b * (t + 1), SEED + 3).astype(np.int64)
    toks = toks % cfg.model.vocab_size
    toks = torch.from_numpy(toks.reshape(g, b, t + 1)).to(DEVICE)
    x, y = toks[..., :-1], toks[..., 1:]
    state = init_state(cfg, DEVICE)
    shadow = make_shadow(state.model, torch.bfloat16)
    lr, chunk = make_lr_schedule(cfg), effective_loss_chunk(cfg)
    train_step(state, shadow, x, y, cfg, lr(0), chunk, fold_in(SEED, 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            train_step(state, shadow, x, y, cfg, lr(i + 1), chunk,
                       fold_in(SEED, i + 1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}  # the device's own events only (CPU ops carry theirs too)
    host_ops, host_calls = {}, 0  # the host's aten ops: self time, calls
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / steps)
        elif e.key.startswith("aten::"):
            host_ops[e.key] = e.self_cpu_time_total / 1e3 / steps
            host_calls += e.count
    # the split route's kernels (its pre-pass is the combined route's
    # too) are a group of their own where the backward takes that route
    split = ({"split backward (pre-pass, dq, dk/dv)":
              r"fused_bwd_prep|fused_bwd_tile|fused_dq|fused_dkv",
              "rms norm": r"rms_norm"} if long else {})
    groups = {**split, "fused attention forward": r"fused_fwd",
              "fused attention backward": r"fused_bwd",
              "flash forward": r"flash_fwd",
              "flash backward (dq, dk/dv)": r"flash_dq|flash_dkv",
              "matmul (cuBLAS)": r"nvjet|gemm|xmma|cutlass|cublas",
              "optimizer (foreach)": r"multi_tensor_apply",
              "elementwise and reductions": r"at::native"}
    by_group = {k: 0.0 for k in groups}
    by_group["other"] = 0.0
    for kname, ms in kernels.items():
        hit = next((k for k, pat in groups.items()
                    if re.search(pat, kname, re.IGNORECASE)), "other")
        by_group[hit] += ms
    busy = sum(kernels.values())
    step_ms = wall_ms / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    rec = {"phase": ("train_long_profile" if long else "train_profile"
                     if name == "openwebtext" else "train_char_profile"),
           "config": name, "overrides": overrides,
           "model_overrides": LONG_MODEL if long else None, "steps": steps,
           "step_ms_host": step_ms, "device_busy_ms_per_step": busy,
           "idle_share": (1 - busy / step_ms) if busy else None,
           "device_ms_per_step_by_group": by_group,
           "top_kernels_ms_per_step": [[n[:120], ms] for n, ms in top],
           "host_aten_calls_per_step": host_calls / steps,
           "host_aten_self_ms_per_step": sum(host_ops.values()),
           "top_host_ops_self_ms_per_step": sorted(
               host_ops.items(), key=lambda kv: -kv[1])[:10],
           "note": "step under the profiler; device times from its trace, "
                   "host times (aten ops' self CPU time, nested calls "
                   "counted apart) from the same trace",
           "gpu": gpu}
    emit(rec)
    del state, shadow
    return rec


def phase_parity(fa, gpu):
    """One microbatch (B=8) of the full-width model through the fused
    kernels and through the naive path: loss and global gradient norm."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, global_norm, loss_fn, make_shadow)

    exp = get_config("openwebtext")
    cfg, chunk = exp.model, effective_loss_chunk(exp)
    b, t = 8, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 2).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = GPT.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)

    def run(m, impl):
        m.zero_grad(set_to_none=True)
        before = fa.fused_attention_bwd.launches
        loss = loss_fn(m, x, y, chunk, attn_impl=impl)
        loss.backward()
        norm = global_norm([p.grad.float() for p in m.parameters()]).item()
        used = fa.fused_attention_bwd.launches - before
        if used != (cfg.n_layer if impl == "fused" else 0):
            raise AssertionError(f"{impl}: {used} fused backward launches")
        return loss.item(), norm

    f32 = {impl: run(model, impl) for impl in ("fused", "naive")}
    model16 = make_shadow(model, torch.bfloat16)
    bf16 = {impl: run(model16, impl) for impl in ("fused", "naive")}
    del model, model16
    (lf, nf), (ln, nn) = f32["fused"], f32["naive"]
    (lfb, nfb), (lnb, nnb) = bf16["fused"], bf16["naive"]
    rec = {"phase": "parity", "config": "openwebtext", "B": b, "T": t,
           "f32": {"loss_fused": lf, "loss_naive": ln,
                   "loss_rel_diff": abs(lf - ln) / abs(ln),
                   "grad_norm_fused": nf, "grad_norm_naive": nn,
                   "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
                   "limits": {"loss": 1e-5, "grad_norm": 1e-4}},
           "bf16": {"loss_fused": lfb, "loss_naive": lnb,
                    "loss_fused_to_f32": abs(lfb - ln),
                    "loss_naive_to_f32": abs(lnb - ln),
                    "grad_norm_fused": nfb, "grad_norm_naive": nnb,
                    "grad_norm_fused_to_f32": abs(nfb - nn),
                    "grad_norm_naive_to_f32": abs(nnb - nn),
                    "rule": "fused bf16 within 2 x naive bf16's distance "
                            "from naive f32"},
           "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 fused and naive paths disagree")
    if not (abs(lfb - ln) <= 2 * abs(lnb - ln)
            and abs(nfb - nn) <= 2 * abs(nnb - nn)):
        raise AssertionError("bf16 fused path too far from the f32 path")
    return rec


def fused_bounds(b, t, h, hkv, c, esz):
    """Least times of one forward and one backward launch, each the larger
    of bytes (inputs read once, outputs written once) over HBM bandwidth
    and bf16 operations over the peak rate. The causal triangle with its
    diagonal holds T (T + 1) / 2 score entries; the forward does two
    products over it (QK^T, PV), the backward five (QK^T, dO V^T, P^T dO,
    dS K, dS^T Q), 2 C operations per entry each."""
    f = (h + 2 * hkv) * c
    tables = 2 * t * c * 4 + 2 * c * 4  # sin, cos; wq, wk
    act = b * t * h * c * esz  # one [B, T, H C] activation
    fwd_bytes = b * t * f * esz + act + b * h * t * 4 + tables
    bwd_bytes = (b * t * f * esz + 2 * act + b * h * t * 4 + tables
                 + b * t * f * esz + 2 * c * 4)
    entries = b * h * t * (t + 1) // 2
    out = {}
    for name, nbytes, products in (("fwd", fwd_bytes, 2),
                                   ("bwd", bwd_bytes, 5)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * 2 * c * entries / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, products * 2 * c * entries)
    return out


def route_kernels_ms(call, reps: int = 5) -> tp.Dict[str, float]:
    """Device ms per call of each kernel that ``call`` launches (a route's
    kernels, such as the combined backward's pre-pass, tile kernel and
    post-pass, and the wrapper's PyTorch ops), from torch.profiler over
    ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.self_device_time_total}


def device_kernels(call) -> tp.List[str]:
    """The names of the device kernels a ``call`` runs (template
    arguments and parameters cut; other device work by its profiler
    name), from torch.profiler over five calls (a profile of one call
    after the train phases' profiles has come back empty)."""
    import re

    names = []
    for key in route_kernels_ms(call, reps=5):
        m = re.search(r"(\w+_kernel)\b", key)
        names.append(m.group(1) if m else key)
    return sorted(names)


def fwd_yardstick_ms(fa, args, h, hkv, reps):
    """The fused forward's library time, the same function: SDPA forward
    on the already normed and roped q^/k^ (and v) plus the forward
    pre-pass (the pre-pass kernel without delta, which norms and ropes
    them), each device time from a CUDA graph. Returns ``(sum, sdpa,
    prep)``."""
    import torch.nn.functional as F

    qkv, wq, wk, sin, cos, _ = args
    q, k, v = fa._split(qkv, h, hkv)
    qh, kh = (fa._ln_rope(a, w, sin, cos, fa.EPS)[0].to(qkv.dtype)
              .contiguous() for a, w in ((q, wq), (k, wk)))
    vh = v.contiguous()
    sdpa = device_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=h != hkv), reps=reps)
    prep = device_ms(lambda i: fa.fused_attention_bwd_prep(
        qkv, wq, wk, sin, cos, h, hkv), reps=reps)
    return sdpa + prep, sdpa, prep


def phase_timing_train(fa, gpu):
    """Both kernels at one training microbatch's shapes, bf16, beside
    their plain versions and bounds, and the forward also at one
    train_long microbatch (B=4, T=2048); SDPA on the already normed and
    roped [B, H, T, C] q/k/v as a yardstick: forward + the forward
    pre-pass for the forward (the same function), forward + backward for
    the backward (attention alone); the port never calls SDPA. All device
    time from CUDA graphs; each route's kernels apart under the
    profiler."""
    b, t, h, hkv, c = (TRAIN_TIMING[k] for k in ("b", "t", "h", "hkv", "c"))
    args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=3)
    qkv, wq, wk, sin, cos, dout = args
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)

    def fwd(i):
        return fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)

    def bwd(i):
        return fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout,
                                      h, hkv)

    def plain_fwd(i):
        return fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                    hkv)

    def plain_bwd(i):
        return fa.fused_attention_backward_reference(
            qkv, wq, wk, sin, cos, out, lse, dout, h, hkv)

    ms = {"fwd": device_ms(fwd, reps=20), "bwd": device_ms(bwd, reps=10)}
    plain_ms = {"fwd": device_ms(plain_fwd, reps=4),
                "bwd": device_ms(plain_bwd, reps=2)}
    got = fused_run(fa, args, h, hkv, kernel=True)
    ref32 = fused_run(fa, [a.float() for a in args], h, hkv, kernel=False)
    err = {n: (g.float() - r).abs().max().item()
           for n, g, r in zip(FUSED_OUTS, got, ref32)}
    del got, ref32
    fwd_lib, sdpa_fwd, prep_fwd = fwd_yardstick_ms(fa, args, h, hkv, reps=20)
    sdpa_fb_ms = sdpa_fwd_bwd_ms(fa, args, h, hkv, reps=10)
    route = route_kernels_ms(lambda: bwd(0))
    fwd_route = route_kernels_ms(lambda: fwd(0))
    bounds = fused_bounds(b, t, h, hkv, c, qkv.element_size())
    from midgpt_tpu_torch.config import get_model_config

    # one launch of each per layer and microbatch of an optimizer step
    per_step = (get_model_config("openwebtext").n_layer
                * TRAIN_SET["g_accum_iters"])
    rec = {"phase": "timing", "kernels": "fused_attention_fwd/bwd",
           "shape": dict(TRAIN_TIMING, dtype="bfloat16"),
           "ms": ms, "plain_ms": plain_ms,
           "launches_per_optimizer_step": {"fwd": per_step, "bwd": per_step},
           "bound_ms": {k: v[0] for k, v in bounds.items()},
           "bound_by": {k: v[1] for k, v in bounds.items()},
           "bytes": {k: v[2] for k, v in bounds.items()},
           "flops": {k: v[3] for k, v in bounds.items()},
           "frac_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
           "library_ms": {"fwd": fwd_lib, "bwd": sdpa_fb_ms},
           "library_note": "fwd: SDPA forward on the normed, roped q/k/v + "
                           "the forward pre-pass (pre-pass kernel, no "
                           "delta), the same function; bwd: SDPA forward + "
                           "backward on them (attention alone); CUDA graphs",
           "sdpa_attention_alone_ms": {"fwd_graph": sdpa_fwd,
                                       "fwd_bwd_graph": sdpa_fb_ms},
           "fwd_prepass_ms": prep_fwd,
           "fwd_route_device_ms_by_kernel": fwd_route,
           "bwd_route_device_ms_by_kernel": route,
           "max_abs_err_vs_plain_f32": err, "gpu": gpu}
    del args, qkv, out, lse, dout
    gc.collect()
    torch.cuda.empty_cache()

    # the forward at one train_long microbatch
    b, t, h, hkv, c = (LONG_TIMING[k] for k in ("b", "t", "h", "hkv", "c"))
    args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=4)
    qkv, wq, wk, sin, cos, _ = args
    long_ms = device_ms(lambda i: fa.fused_attention_fwd(
        qkv, wq, wk, sin, cos, h, hkv), reps=20)
    long_plain = device_ms(lambda i: fa.fused_attention_forward_reference(
        qkv, wq, wk, sin, cos, h, hkv), reps=2)
    got = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    ref32 = fa.fused_attention_forward_reference(
        *(a.float() for a in args[:5]), h, hkv)
    long_err = {n: (g.float() - r).abs().max().item()
                for n, g, r in zip(("out", "lse"), got, ref32)}
    del got, ref32
    long_lib, long_sdpa, long_prep = fwd_yardstick_ms(fa, args, h, hkv,
                                                      reps=20)
    long_bound = fused_bounds(b, t, h, hkv, c, qkv.element_size())["fwd"]
    long_route = route_kernels_ms(lambda: fa.fused_attention_fwd(
        qkv, wq, wk, sin, cos, h, hkv))
    rec["fwd_t2048"] = {
        "shape": dict(LONG_TIMING, dtype="bfloat16"), "ms": long_ms,
        "plain_ms": long_plain, "bound_ms": long_bound[0],
        "bound_by": long_bound[1], "bytes": long_bound[2],
        "flops": long_bound[3], "frac_of_bound": long_bound[0] / long_ms,
        "library_ms": long_lib, "sdpa_fwd_ms": long_sdpa,
        "fwd_prepass_ms": long_prep,
        "route_device_ms_by_kernel": long_route,
        "max_abs_err_vs_plain_f32": long_err}
    del args, qkv
    gc.collect()
    torch.cuda.empty_cache()
    emit(rec)
    return rec


# -- the flash kernels and the shakespeare_char training path -------------


def flash_inputs(b, t, h, hkv, c, dtype, seed=0, layout="contiguous"):
    """q, k, v and an output gradient ``[B, H|Hkv, T, C]``, drawn on the CPU
    from ``seed`` and moved to the card. ``layout="model"`` gives the
    strided views the model passes, which the kernels read in place: q, k
    (RoPE's outputs) and dO ``[B, T, H, C]`` transposed, v a transposed
    view into a packed ``[B, T, (H + 2 Hkv) C]`` projection."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        q = torch.randn(b, h, t, c, generator=gen)
        k = torch.randn(b, hkv, t, c, generator=gen)
        v = torch.randn(b, hkv, t, c, generator=gen)
        dout = torch.randn(b, h, t, c, generator=gen)
        return [a.to(DEVICE, dtype) for a in (q, k, v, dout)]
    q, k, dout = (torch.randn(b, t, n, c, generator=gen).to(DEVICE, dtype)
                  .transpose(1, 2) for n in (h, hkv, h))
    qkv = torch.randn(b, t, (h + 2 * hkv) * c, generator=gen).to(DEVICE, dtype)
    v = qkv[..., (h + hkv) * c:].reshape(b, t, hkv, c).transpose(1, 2)
    return [q, k, v, dout]


def flash_run(fl, args, drop, kernel):
    """``(out, lse, dq, dk, dv, delta)`` (dk, dv per q head) through the
    kernels or the plain versions. Both backward passes read the plain
    forward's lse, and the dq kernel its out, from which it forms delta
    itself (the main path's entry, ``flash_bwd_dq_delta``); dk/dv reads
    the plain delta, so every kernel sees its plain version's inputs."""
    q, k, v, dout = args
    out, lse = fl.flash_forward_reference(q, k, v, True, drop)
    delta = fl.delta_reference(dout, out)
    if kernel:
        fwd = fl.flash_fwd(q, k, v, True, drop)
        dq, written = fl.flash_bwd_dq_delta(q, k, v, dout, lse, out, None,
                                            True, drop)
        return (*fwd, dq, *fl.flash_bwd_dkv(q, k, v, dout, lse, delta, True,
                                            drop), written)
    dq = fl.flash_backward_dq_reference(q, k, v, dout, lse, delta, True, drop)
    return (out, lse, dq, *fl.flash_backward_dkv_reference(
        q, k, v, dout, lse, delta, True, drop), delta)


def flash_readings(got, plain, ref32):
    """Per output, its distance from the plain version over the limit (the
    check passes when every reading is at most 1).

    f32 (``ref32 is None``): each element within ``1e-5 + rel * |plain|``,
    rel 1e-5 for out and lse, 1e-4 for dq, dk, dv (their sums run over T
    twice). bf16: the kernels round P and dS where the plain version
    does, but after sums in another order, so out, dq, dk and dv are held
    by the triangle rule: at most twice as far from the plain version run
    in f32 on the upcast inputs (``ref32``) as the plain bf16 version is.
    lse is computed in f32 from the same upcast q and k by both plain
    versions, so in bf16 too it is held by the f32 rule against
    ``ref32``. delta is formed in f32 by the dq kernel and by the plain
    version from the same O (the plain forward's, in the call's dtype)
    and dO, so it is held by the f32 rule against the plain version of
    the same dtype: within ``1e-5 + 1e-5 |plain|``."""
    out = {}
    for i, name in enumerate(FLASH_OUTS):
        g, p = got[i].float(), plain[i].float()
        if ref32 is None or name in ("lse", "delta"):
            r = p if ref32 is None or name == "delta" else ref32[i]
            rel = 1e-5 if name in ("out", "lse", "delta") else 1e-4
            out[name] = ((g - r).abs() / (1e-5 + rel * r.abs())).max().item()
        else:
            own = (p - ref32[i]).abs().max().item()
            out[name] = (g - ref32[i]).abs().max().item() / (2 * own)
    return out


def flash_cases():
    """``(name, B, T, H, Hkv, C, rate, dtype, layout)`` of each
    flash_kernel case: every geometry of ``FLASH_GEOMS`` at each rate and
    type, then train_char's own microbatch (``CHAR_TIMING``, bf16) on
    contiguous inputs and on the model's strided views."""
    for name, b, t, h, hkv, c in FLASH_GEOMS:
        for rate in FLASH_RATES:
            for dtype in (torch.bfloat16, torch.float32):
                yield name, b, t, h, hkv, c, rate, dtype, "contiguous"
    ch = CHAR_TIMING
    for layout in ("contiguous", "model"):
        yield ("char_microbatch", ch["b"], ch["t"], ch["h"], ch["hkv"],
               ch["c"], ch["rate"], torch.bfloat16, layout)


def phase_flash_kernel(fl) -> float:
    """Each case is held by :func:`flash_readings`; the same rule must
    refuse the kernels' outputs against the plain version of a fault: the
    mask of seed + 1 (with dropout: out, dq, dk, dv, since lse does not
    see the mask) or k and v shifted one row (without: every output).
    Returns the largest bf16-kernel-to-bf16-plain distance seen."""
    worst = 0.0
    up = lambda a: [x.float() for x in a]  # noqa: E731
    for name, b, t, h, hkv, c, rate, dtype, layout in flash_cases():
        drop = fl.Dropout(rate, FLASH_SEED) if rate else None
        args = flash_inputs(b, t, h, hkv, c, dtype, layout=layout)
        got = flash_run(fl, args, drop, kernel=True)
        torch.cuda.synchronize()
        plain = flash_run(fl, args, drop, kernel=False)
        ref32 = (up(flash_run(fl, up(args), drop, kernel=False))
                 if dtype == torch.bfloat16 else None)
        sound = flash_readings(got, plain, ref32)
        if drop is not None:
            fault = "seed + 1"
            fargs, fdrop = args, drop._replace(seed=FLASH_SEED + 1)
            checked = ["out", "dq", "dk", "dv"]
        else:
            fault = "k, v shifted one row"
            fargs = [args[0], *(torch.roll(a, 1, 2)
                                for a in args[1:3]), args[3]]
            fdrop, checked = None, [n for n in FLASH_OUTS if n != "delta"]
        fplain = flash_run(fl, fargs, fdrop, kernel=False)
        fref = (up(flash_run(fl, up(fargs), fdrop, kernel=False))
                if ref32 is not None else None)
        faulted = flash_readings(got, fplain, fref)
        errs = {n: (g.float() - p.float()).abs().max().item()
                for n, g, p in zip(FLASH_OUTS, got, plain)}
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"non-finite flash output: {name}")
        emit({"phase": "flash_kernel", "geometry": name, "B": b,
              "T": t, "H": h, "Hkv": hkv, "C": c, "rate": rate,
              "layout": layout,
              "seed": FLASH_SEED if rate else None,
              "dtype": str(dtype).split(".")[-1],
              "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                       "(out, lse, delta) / 1e-4 (dq, dk, dv)"
                       if ref32 is None else
                       "max |kernel - plain f32| <= 2 x max |plain "
                       "bf16 - plain f32| (lse, delta: the f32 rule)"),
              "sound_err_over_limit": sound, "fault": fault,
              "fault_err_over_limit": faulted,
              "max_abs_err_vs_plain_same_dtype": errs})
        bad = [n for n, x in sound.items() if not x <= 1.0]
        if bad:
            raise AssertionError(
                f"flash kernels disagree with their plain versions: "
                f"{name} {layout} rate={rate} {dtype} {bad}")
        missed = [n for n in checked if not faulted[n] > 1.0]
        if missed:
            raise AssertionError(f"the check passes a fault ({fault})"
                                 f": {name} {layout} {dtype} {missed}")
        if dtype == torch.bfloat16:
            worst = max(worst, *errs.values())
    return worst


def char_expected_launches(cfg) -> tp.Dict[str, int]:
    """Launches of ``train(cfg)`` from step 0 for a config with dropout
    and remat "full": the training steps take the flash kernels, each
    layer's forward twice a microbatch (the checkpointed block is
    recomputed in the backward), dq and dk/dv once; the evals are
    deterministic and take the fused forward, once per layer and eval
    microbatch (two splits at every eval interval, the validation split
    once more at the end)."""
    g, nl = cfg.g_accum_iters, cfg.model.n_layer
    train_mb = cfg.max_steps * g
    evals = len(range(0, cfg.max_steps, cfg.eval_interval))
    eval_mb = (2 * evals + 1) * cfg.eval_batches * g
    return {"flash_fwd": 2 * nl * train_mb, "flash_bwd_dq": nl * train_mb,
            "flash_bwd_dkv": nl * train_mb, "fused_fwd": nl * eval_mb,
            "fused_bwd": 0}


def phase_train_char(fl, fa, gpu):
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.train import train
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        prep = subprocess.run(
            [sys.executable,
             os.path.join(repo, "data", "shakespeare_char", "prepare.py"),
             "--synthetic", "--out_dir", data],
            check=True, capture_output=True, text=True, timeout=300)
        rundir = os.path.join(tmp, "run")
        cfg = get_config("shakespeare_char", rundir=rundir, data_dir=data,
                         seed=SEED, **CHAR_SET)
        fl.flash_fwd.launches = fl.flash_bwd_dq.launches = 0
        fl.flash_bwd_dkv.launches = 0
        fa.fused_attention_fwd.launches = fa.fused_attention_bwd.launches = 0
        t0 = time.perf_counter()
        final = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": fl.flash_fwd.launches,
                    "flash_bwd_dq": fl.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fl.flash_bwd_dkv.launches,
                    "fused_fwd": fa.fused_attention_fwd.launches,
                    "fused_bwd": fa.fused_attention_bwd.launches}
        rows = read_metrics(rundir)
        ckpts = sorted(os.listdir(os.path.join(rundir, "checkpoints")))
    losses = final["losses"]
    want = char_expected_launches(cfg)
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = final["loop_s"] - final["eval_s"] - final["ckpt_s"]
    rec = {
        "phase": "train_char", "config": "shakespeare_char",
        "overrides": CHAR_SET,
        "model": {k: getattr(cfg.model, k) for k in (
            "block_size", "vocab_size", "n_layer", "n_head", "n_embd",
            "dropout", "attn_impl", "remat")},
        "batch_size": cfg.batch_size, "g_accum_iters": cfg.g_accum_iters,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "data": "data/shakespeare_char/prepare.py --synthetic: "
                + prep.stdout.strip().replace("\n", "; "),
        "losses": losses, "val_loss": final["val_loss"],
        "launches": launches, "expected_launches": want,
        "launch_formula": "flash fwd = 2 x n_layer x train microbatches "
                          "(remat recompute), dq = dkv = n_layer x train "
                          "microbatches; fused fwd = n_layer x eval "
                          "microbatches, fused bwd = 0",
        "checkpoints": ckpts, "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / statistics.median(tps),
        "timing_note": "tokens_per_s, mfu: every trained token over "
                       "train()'s loop on the host clock, evals and the "
                       "save included; *_steps_only: the loop less the "
                       "evals and the save; step_ms_median: per-step host "
                       "clock between loss reads (log_interval=1)",
        "flops_per_token": fpt, "peak_flops": peak, "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-5:]) <= losses[0] - 1.0:
        raise AssertionError(f"the loss did not fall by 1 nat: {losses}")
    if cfg.model.remat != "full" or cfg.model.dropout != 0.2:
        raise AssertionError("the char phase must run remat full, dropout")
    if launches != want or min(v for k, v in launches.items()
                               if k != "fused_bwd") == 0:
        raise AssertionError(f"launches {launches} != {want}")
    if ckpts != [f"step_{cfg.max_steps - 1:08d}.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    return rec


def phase_parity_char(fl, gpu):
    """One microbatch (B=16) of the full-width char model in f32 with
    dropout drawn from one key, through the flash kernels and through the
    naive path: both draw the same attention masks (the counter hash) and
    the same residual masks (generators seeded from the same keys), so
    the loss and gradient norm agree to f32 rounding."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import global_norm, loss_fn

    cfg = get_config("shakespeare_char").model
    b, t = 16, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 4).astype(np.int64) % cfg.vocab_size
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = GPT.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    key = fold_in(SEED, 7)

    def run(impl, k):
        model.zero_grad(set_to_none=True)
        before = fl.flash_bwd_dq.launches
        loss = loss_fn(model, x, y, attn_impl=impl, key=k)
        loss.backward()
        norm = global_norm([p.grad.float() for p in model.parameters()])
        used = fl.flash_bwd_dq.launches - before
        if used != (cfg.n_layer if impl == "flash" else 0):
            raise AssertionError(f"{impl}: {used} flash dq launches")
        return loss.item(), norm.item()

    (lf, nf), (ln, nn) = run("flash", key), run("naive", key)
    lo, _ = run("flash", fold_in(SEED, 8))
    ld, _ = run("flash", None)
    del model
    rec = {"phase": "parity_char", "config": "shakespeare_char", "B": b,
           "T": t, "dtype": "float32", "dropout": cfg.dropout,
           "loss_flash": lf, "loss_naive": ln,
           "loss_rel_diff": abs(lf - ln) / abs(ln),
           "grad_norm_flash": nf, "grad_norm_naive": nn,
           "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
           "limits": {"loss": 1e-5, "grad_norm": 1e-4},
           "loss_other_key": lo, "loss_deterministic": ld, "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 flash and naive dropout paths disagree")
    if lo == lf or ld == lf:
        raise AssertionError("the dropout masks do not depend on the key")
    return rec


def flash_bounds(b, t, h, hkv, c, esz):
    """Least times of one call of each kernel, and of the whole backward,
    each the larger of bytes (inputs read once, outputs written once)
    over HBM bandwidth and bf16 operations over the peak rate. The causal
    triangle with its diagonal holds T (T + 1) / 2 score entries a head;
    the forward does two products over it (QK^T, PV), dq three (QK^T,
    dO V^T, dS K), dk/dv four (QK^T, dO V^T, P^T dO, dS^T Q) and the whole
    backward five (dq's and dk/dv's shared ones counted once), 2 C
    operations per entry each. Forward: q, k, v in, out and lse out. dq:
    q, k, v, dO, lse, delta in, dq out; dq_delta (the main path's dq,
    which forms delta): q, k, v, dO, out, lse in, dq and delta out.
    dk/dv: q, k, v, dO, lse, delta in, dk, dv out. The whole backward
    reads q, k, v, out (for delta), dO and lse and writes dq, dk, dv."""
    qa = b * h * t * c * esz  # a [B, H, T, C] activation
    kva = b * hkv * t * c * esz
    rows = b * h * t * 4  # an f32 [B, H, T] row vector
    entries = b * h * t * (t + 1) // 2
    work = {"fwd": (qa + 2 * kva + qa + rows, 2),
            "dq": (2 * qa + 2 * kva + 2 * rows + qa, 3),
            "dq_delta": (3 * qa + 2 * kva + rows + qa + rows, 3),
            "dkv": (2 * qa + 2 * kva + 2 * rows + 2 * kva, 4),
            "bwd": (3 * qa + 2 * kva + rows + qa + 2 * kva, 5)}
    out = {}
    for name, (nbytes, products) in work.items():
        flops = products * 2 * c * entries
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def phase_timing_flash(fl, gpu):
    """The flash kernels at one shakespeare_char microbatch, bf16, rate
    0.2: the forward, dq (given delta, and forming delta as the main path
    runs it) and dk/dv alone and the whole backward (dq forming delta,
    dk/dv), each beside its plain version and bound; one whole backward
    under torch.profiler, whose device kernels must be the dq and dk/dv
    kernels alone (no PyTorch operation forms delta); SDPA with
    ``dropout_p=0.2`` (its own mask, not this one) forward and forward +
    backward as the library's time for the same work. Every time is
    device time from a CUDA graph (:func:`device_ms`); SDPA's dropout
    draws its Philox offsets from the default generator, which graph
    capture supports."""
    import torch.nn.functional as F

    b, t, h, hkv, c, rate = (CHAR_TIMING[k]
                             for k in ("b", "t", "h", "hkv", "c", "rate"))
    q, k, v, dout = flash_inputs(b, t, h, hkv, c, torch.bfloat16, seed=5)
    drop = fl.Dropout(rate, FLASH_SEED)
    out, lse = fl.flash_fwd(q, k, v, True, drop)
    delta = fl.delta_reference(dout, out)

    def bwd(i):
        return fl.flash_bwd(q, k, v, out, lse, dout, None, True, drop)

    def plain_dq_delta(i):
        d = fl.delta_reference(dout, out)
        return fl.flash_backward_dq_reference(q, k, v, dout, lse, d, True,
                                              drop), d

    def plain_bwd(i):
        dq, d = plain_dq_delta(i)
        return dq, fl.flash_backward_dkv_reference(q, k, v, dout, lse, d,
                                                   True, drop)

    ms = {"fwd": device_ms(lambda i: fl.flash_fwd(q, k, v, True, drop),
                           reps=20),
          "dq": device_ms(lambda i: fl.flash_bwd_dq(
              q, k, v, dout, lse, delta, True, drop), reps=20),
          "dq_delta": device_ms(lambda i: fl.flash_bwd_dq_delta(
              q, k, v, dout, lse, out, None, True, drop), reps=20),
          "dkv": device_ms(lambda i: fl.flash_bwd_dkv(
              q, k, v, dout, lse, delta, True, drop), reps=20),
          "bwd": device_ms(bwd, reps=10)}
    plain_ms = {
        "fwd": device_ms(lambda i: fl.flash_forward_reference(
            q, k, v, True, drop), reps=2),
        "dq": device_ms(lambda i: fl.flash_backward_dq_reference(
            q, k, v, dout, lse, delta, True, drop), reps=2),
        "dq_delta": device_ms(plain_dq_delta, reps=2),
        "dkv": device_ms(lambda i: fl.flash_backward_dkv_reference(
            q, k, v, dout, lse, delta, True, drop), reps=2),
        "bwd": device_ms(plain_bwd, reps=1)}
    bwd_kernels = device_kernels(lambda: bwd(0))
    if sorted(bwd_kernels) != ["flash_dkv_tile_kernel", "flash_dq_tile_kernel"]:
        raise AssertionError(f"flash_bwd ran other device work: {bwd_kernels}")
    got = flash_run(fl, [q, k, v, dout], drop, kernel=True)
    ref32 = flash_run(fl, [a.float() for a in (q, k, v, dout)], drop,
                      kernel=False)
    err = {n: (g.float() - r).abs().max().item()
           for n, g, r in zip(FLASH_OUTS, got, ref32)}
    # delta against the plain delta of the same (bf16) forward's out
    err["delta"] = (got[5] - flash_run(fl, [q, k, v, dout], drop,
                                       kernel=False)[5]).abs().max().item()
    sdpa_fwd = device_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=rate), reps=20)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]

    def sdpa_fb(i):
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           dropout_p=rate)
        return torch.autograd.grad(o, leaves, dout)

    sdpa_fb_ms = device_ms(sdpa_fb, reps=10)
    bounds = flash_bounds(b, t, h, hkv, c, q.element_size())
    rec = {"phase": "timing", "kernels": "flash fwd / dq / dkv",
           "shape": dict(CHAR_TIMING, dtype="bfloat16"),
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": {n: x[0] for n, x in bounds.items()},
           "bound_by": {n: x[1] for n, x in bounds.items()},
           "bytes": {n: x[2] for n, x in bounds.items()},
           "flops": {n: x[3] for n, x in bounds.items()},
           "frac_of_bound": {n: bounds[n][0] / ms[n] for n in ms},
           "library_ms": {"sdpa_fwd_dropout": sdpa_fwd,
                          "sdpa_fwd_bwd_dropout": sdpa_fb_ms},
           "bwd_note": "bwd = the dq kernel (forming delta) + dk/dv kernel",
           "bwd_profile_kernels": bwd_kernels,
           "max_abs_err_vs_plain_f32": err, "gpu": gpu}
    emit(rec)
    return rec


# -- the long-context slice: the split backward and the fused RMSNorm ------


def split_run(fa, args, h, hkv, kernel):
    """``(out, lse, dq, dwq, dk_h, dv_h, dwk)``: the forward and the split
    backward through the kernels or the plain versions. Both backward
    passes read the plain forward's lse and its delta = rowsum(dO * O), so
    each split kernel sees the same inputs as its plain version."""
    qkv, wq, wk, sin, cos, dout = args
    o, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                  hkv)
    delta = fa.attention_delta(o, dout, h)
    tail = (lse, delta, dout, h, hkv)
    if kernel:
        fwd = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        return (*fwd, *fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail),
                *fa.fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, *tail))
    return (o, lse,
            *fa.fused_attention_bwd_dq_reference(qkv, wq, wk, sin, cos, *tail),
            *fa.fused_attention_bwd_dkv_reference(qkv, wq, wk, sin, cos,
                                                  *tail))


def prep_readings(fa, args, h, hkv, shifted=None):
    """The bf16 pre-pass kernel against its plain version run in f32 on
    the upcast inputs: q^ and k^ held by :func:`hold` (each element within
    1e-5 plus half a bf16 ulp), delta (an f32 sum over C in another
    order) within 1e-5 + 1e-5 |plain|. Returns each output's (max abs
    err, err / limit), and q^'s err / limit with the kernel run on the
    RoPE tables in ``shifted`` (must exceed 1; None without them)."""
    qkv, wq, wk, sin, cos, dout = args
    out, _ = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    got = fa.fused_attention_bwd_prep(qkv, wq, wk, sin, cos, h, hkv,
                                      out=out, dout=dout)
    ref = fa.fused_attention_bwd_prep_reference(
        qkv.float(), wq, wk, sin, cos, h, hkv, out=out.float(),
        dout=dout.float())
    d_err = (got[2] - ref[2]).abs()
    readings = {"qhat": hold(got[0], ref[0]), "khat": hold(got[1], ref[1]),
                "delta": (d_err.max().item(), (d_err / (
                    1e-5 + 1e-5 * ref[2].abs())).max().item())}
    if shifted is None:
        return readings, None
    fault = fa.fused_attention_bwd_prep(qkv, wq, wk, *shifted, h, hkv)[0]
    return readings, hold(fault, ref[0])[1]


def phase_split_kernel(fa) -> tp.Dict[str, float]:
    """The split route's kernels (the bf16 pre-pass, dq and dk/dv), and the
    fused forward at T=2048 (which had not run there before), against
    their plain versions: each output held by :func:`fused_readings`'
    rule (the pre-pass by :func:`prep_readings`); the same rule must
    refuse every output of the kernels run with the RoPE tables shifted
    by one position. At T=1024 (below the cap) the split route's dqkv,
    dwq and dwk are held against the combined kernel's: in f32 each
    element within 1e-5 + 1e-4 |combined| (the same sums in another
    order); in bf16 their largest distance within twice the plain bf16
    version's largest distance from the plain f32 one (the split kernels
    sum S = Q^ K^T and the combined one S^T = K^ Q^T, each in its own
    order, so ds may round to another bf16 value: the two routes are held
    no further apart than fused_readings lets each be from the f32
    path). Returns the largest bf16-kernel-to-bf16-plain distance of the
    dq and dk/dv kernels' outputs (``"split"``) and of the pre-pass's
    (``"prep"``)."""
    names = ("out", "lse") + SPLIT_OUTS
    worst = {"split": 0.0, "prep": 0.0}
    for name, b, t, h, hkv, c in SPLIT_GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = fused_inputs(b, t, h, hkv, c, dtype)
            got = split_run(fa, args, h, hkv, kernel=True)
            torch.cuda.synchronize()
            plain = split_run(fa, args, h, hkv, kernel=False)
            ref32 = None
            if dtype == torch.bfloat16:
                ref32 = split_run(fa, [a.float() for a in args], h, hkv,
                                  kernel=False)
            sound = fused_readings(got, plain, ref32, names)
            shifted = list(args)
            shifted[3], shifted[4] = (torch.roll(a, 1, 0) for a in args[3:5])
            fault = split_run(fa, shifted, h, hkv, kernel=True)
            faulted = fused_readings(fault, plain, ref32, names)
            errs = {n: (g.float() - p.float()).abs().max().item()
                    for n, g, p in zip(names, got, plain)}
            if dtype == torch.bfloat16:
                prep, prep_fault = prep_readings(fa, args, h, hkv,
                                                 shifted[3:5])
                bad_prep = [n for n, v in prep.items() if not v[1] <= 1.0]
                if bad_prep or not prep_fault > 1.0:
                    raise AssertionError(
                        f"pre-pass kernel: {name} {prep} shifted RoPE "
                        f"{prep_fault}")
            rec = {"phase": "split_kernel", "geometry": name, "B": b, "T": t,
                   "H": h, "Hkv": hkv, "C": c,
                   "dtype": str(dtype).split(".")[-1],
                   "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                            "(out, lse) / 1e-4 (grads)" if ref32 is None else
                            "max |kernel - plain f32| <= 2 x max |plain "
                            "bf16 - plain f32|"),
                   "sound_err_over_limit": sound,
                   "shifted_rope_err_over_limit": faulted,
                   "max_abs_err_vs_plain_same_dtype": errs}
            if dtype == torch.bfloat16:
                rec["prep"] = {"rule": "qhat, khat: 1e-5 + 2^-8 |kernel|; "
                                       "delta: 1e-5 + 1e-5 |plain f32|",
                               "max_abs_err": {k: v[0] for k, v in
                                               prep.items()},
                               "err_over_limit": {k: v[1] for k, v in
                                                  prep.items()},
                               "shifted_rope_qhat_err_over_limit":
                                   prep_fault}
            del got, plain, ref32, fault
            bad = [n for n, v in sound.items() if not v <= 1.0]
            missed = [n for n, v in faulted.items() if not v > 1.0]
            if not bad and not missed:
                rec["vs_combined"] = split_vs_combined(
                    fa, b, SPLIT_VS_COMBINED_T, h, hkv, c, dtype)
            emit(rec)
            if bad:
                raise AssertionError(f"split kernels disagree with their "
                                     f"plain versions: {name} {dtype} {bad}")
            if missed:
                raise AssertionError(f"the check passes shifted RoPE tables: "
                                     f"{name} {dtype} {missed}")
            if dtype == torch.bfloat16:
                worst["split"] = max(worst["split"], *(
                    v for n, v in errs.items() if n in SPLIT_OUTS))
                worst["prep"] = max(worst["prep"],
                                    *(v[0] for v in prep.values()))
            gc.collect()
            torch.cuda.empty_cache()
    return worst


def split_vs_combined(fa, b, t, h, hkv, c, dtype):
    """The split route (pre-pass, dq, dk/dv kernels, the GQA sum) against the
    combined kernel at a T both take; raises past the rule of
    :func:`phase_split_kernel`."""
    args = fused_inputs(b, t, h, hkv, c, dtype, seed=1)
    qkv, wq, wk, sin, cos, dout = args
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    comb = fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout, h,
                                  hkv)
    split = fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out, lse, dout,
                                         h, hkv)
    names = ("dqkv", "dwq", "dwk")
    diff = {n: (a.float() - m.float()).abs().max().item()
            for n, a, m in zip(names, split, comb)}
    if dtype == torch.float32:
        over = {n: ((a - m).abs() / (1e-5 + 1e-4 * m.abs())).max().item()
                for n, a, m in zip(names, split, comb)}
    else:
        plain = fused_run(fa, args, h, hkv, kernel=False)[2:]
        ref32 = fused_run(fa, [a.float() for a in args], h, hkv,
                          kernel=False)[2:]
        over = {n: diff[n] / (2 * (p.float() - r).abs().max().item())
                for n, p, r in zip(names, plain, ref32)}
    if not all(v <= 1.0 for v in over.values()):
        raise AssertionError(f"split and combined kernels disagree at T={t}: "
                             f"{over}")
    return {"T": t, "err_over_limit": over, "max_abs_diff": diff}


def phase_norm_kernel(fn) -> float:
    """The fused RMSNorm kernels against their plain versions: y and dx
    held by :func:`hold` against the plain versions in f32 on the upcast
    inputs (each computes in f32 and rounds once), rstd by the f32 rule;
    [8192, 768] in bf16 and f32, with and without a weight, eps 1e-6 and
    1e-5, and 4099 rows (not a multiple of 32, nor of the kernel's 8 rows
    a block). The same rule must refuse the plain output with its rows
    shifted by one. Returns the largest bf16 y/dx distance."""
    worst = 0.0
    for (n, d) in NORM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for use_weight in ((False, True) if n == NORM_SHAPES[0][0]
                               else (True,)):
                for eps in (NORM_EPS if n == NORM_SHAPES[0][0]
                            else NORM_EPS[:1]):
                    gen = torch.Generator().manual_seed(SEED)
                    x = torch.randn(n, d, generator=gen).to(DEVICE, dtype)
                    w = (1.0 + 0.2 * torch.randn(d, generator=gen)).to(DEVICE)
                    dy = torch.randn(n, d, generator=gen).to(DEVICE, dtype)
                    w = w if use_weight else None
                    y, rstd = fn.fused_rms_norm_fwd(x, w, eps)
                    dx = fn.fused_rms_norm_bwd(x, w, rstd, dy)
                    torch.cuda.synchronize()
                    y32, r32 = fn.fused_rms_norm_forward_reference(
                        x.float(), w, eps)
                    dx32 = fn.fused_rms_norm_backward_reference(
                        x.float(), w, r32, dy.float())
                    readings = {"y": hold(y, y32), "dx": hold(dx, dx32),
                                "rstd": hold(rstd, r32)}
                    fault = hold(y, torch.roll(y32, 1, 0))[1]
                    emit({"phase": "norm_kernel", "N": n, "D": d,
                          "dtype": str(dtype).split(".")[-1],
                          "weight": use_weight, "eps": eps,
                          "rule": "|kernel - plain f32| <= 1e-5 + (bf16: "
                                  "2^-8 |kernel|) per element",
                          "max_abs_err": {k: v[0]
                                          for k, v in readings.items()},
                          "err_over_limit": {k: v[1]
                                             for k, v in readings.items()},
                          "shifted_rows_err_over_limit": fault})
                    bad = [k for k, v in readings.items() if not v[1] <= 1.0]
                    if bad:
                        raise AssertionError(
                            f"norm kernels disagree with their plain "
                            f"versions: {n}x{d} {dtype} w={use_weight} "
                            f"eps={eps} {bad}")
                    if not fault > 1.0:
                        raise AssertionError("the check passes shifted rows")
                    if dtype == torch.bfloat16:
                        worst = max(worst, readings["y"][0],
                                    readings["dx"][0])
    return worst


def long_counters(fa, fn):
    """The launch counters of the long-context path's kernels."""
    return {"fused_fwd": fa.fused_attention_fwd,
            "fused_bwd_combined": fa.fused_attention_bwd,
            "fused_bwd_prep": fa.fused_attention_bwd_prep,
            "fused_bwd_dq": fa.fused_attention_bwd_dq,
            "fused_bwd_dkv": fa.fused_attention_bwd_dkv,
            "rms_norm_fwd": fn.fused_rms_norm_fwd,
            "rms_norm_bwd": fn.fused_rms_norm_bwd}


def long_config(**overrides):
    """``openwebtext`` at a 2048-token context with the fused norm."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config

    cfg = get_config("openwebtext", seed=SEED, **overrides)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **LONG_MODEL))


def phase_train_long(fa, fn, gpu):
    """``train()`` on openwebtext at block_size 2048 with the fused norm:
    the attention backward takes the split kernels (T above the combined
    cap), every RMSNorm the norm kernels; launches counted around the run
    alone."""
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.train import train
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    counters = long_counters(fa, fn)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        rundir = os.path.join(tmp, "run")
        cfg = long_config(rundir=rundir, data_dir=data, **LONG_SET)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        final = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        rows = read_metrics(rundir)
    losses = final["losses"]
    nl, g = cfg.model.n_layer, cfg.g_accum_iters
    fwd_want, _ = expected_launches(cfg)
    train_mb = cfg.max_steps * g
    all_mb = fwd_want // nl
    norms = 2 * nl + 1
    want = {"fused_fwd": fwd_want, "fused_bwd_combined": 0,
            "fused_bwd_prep": nl * train_mb,
            "fused_bwd_dq": nl * train_mb, "fused_bwd_dkv": nl * train_mb,
            "rms_norm_fwd": norms * all_mb, "rms_norm_bwd": norms * train_mb}
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = final["loop_s"] - final["eval_s"] - final["ckpt_s"]
    rec = {
        "phase": "train_long", "config": "openwebtext",
        "model_overrides": LONG_MODEL, "overrides": LONG_SET,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "loss_chunk": cfg.loss_chunk, "remat": final["remat"],
        "losses": losses, "val_loss": final["val_loss"],
        "launches": launches, "expected_launches": want,
        "launch_formula": "fwd = n_layer x (train + eval microbatches); "
                          "pre-pass = dq = dkv = n_layer x train "
                          "microbatches (bf16); combined 0; norm fwd = "
                          "(2 n_layer + 1) x (train "
                          "+ eval microbatches); norm bwd = (2 n_layer + 1) "
                          "x train microbatches",
        "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / statistics.median(tps),
        "tokens_per_s_per_step": tps,
        "timing_note": "as the train phase: tokens_per_s over train()'s "
                       "loop, evals and saves included; *_steps_only "
                       "without them; step_ms_median between loss reads",
        "flops_per_token": fpt, "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-3:]) <= losses[0] - 0.5:
        raise AssertionError(f"the loss did not fall by 0.5 nat: {losses}")
    if final["remat"] != "none":
        raise AssertionError(f"remat resolved to {final['remat']}")
    if launches != want or min(v for k, v in launches.items()
                               if k != "fused_bwd_combined") == 0:
        raise AssertionError(f"launches {launches} != {want}")
    return rec


def set_norm_impl(model, impl: str) -> None:
    """Every RMSNorm of ``model`` to ``impl`` (the weights are untouched)."""
    from midgpt_tpu_torch.models.layers import RMSNorm

    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.impl = impl


def phase_parity_long(fa, fn, gpu):
    """One microbatch (B=4, T=2048) of the full-width model through the
    fused attention (split backward) and the fused norm, and through the
    naive attention and the plain norm: loss and global gradient norm,
    with the limits of the parity phase."""
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, global_norm, loss_fn, make_shadow)

    exp = long_config()
    cfg, chunk = exp.model, effective_loss_chunk(exp)
    b, t = 4, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 4).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = GPT.init(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    counters = long_counters(fa, fn)

    def run(m, impl, bf16=False):
        set_norm_impl(m, "fused" if impl == "fused" else "auto")
        m.zero_grad(set_to_none=True)
        before = {k: f.launches for k, f in counters.items()}
        loss = loss_fn(m, x, y, chunk, attn_impl=impl)
        loss.backward()
        norm = global_norm([p.grad.float() for p in m.parameters()]).item()
        used = {k: f.launches - before[k] for k, f in counters.items()}
        n = cfg.n_layer
        # the f32 split kernels normalise in their walks: no pre-pass
        want = ({"fused_fwd": n, "fused_bwd_combined": 0,
                 "fused_bwd_prep": n if bf16 else 0, "fused_bwd_dq": n,
                 "fused_bwd_dkv": n, "rms_norm_fwd": 2 * n + 1,
                 "rms_norm_bwd": 2 * n + 1} if impl == "fused"
                else {k: 0 for k in counters})
        if used != want:
            raise AssertionError(f"{impl}: launches {used} != {want}")
        m.zero_grad(set_to_none=True)
        return loss.item(), norm

    f32 = {impl: run(model, impl) for impl in ("fused", "naive")}
    gc.collect()
    torch.cuda.empty_cache()
    model16 = make_shadow(model, torch.bfloat16)
    bf16 = {impl: run(model16, impl, bf16=True)
            for impl in ("fused", "naive")}
    del model, model16
    (lf, nf), (ln, nn) = f32["fused"], f32["naive"]
    (lfb, nfb), (lnb, nnb) = bf16["fused"], bf16["naive"]
    rec = {"phase": "parity_long", "config": "openwebtext",
           "model_overrides": LONG_MODEL, "B": b, "T": t,
           "paths": "fused attention (split backward) + fused norm vs naive "
                    "attention + plain norm",
           "f32": {"loss_fused": lf, "loss_naive": ln,
                   "loss_rel_diff": abs(lf - ln) / abs(ln),
                   "grad_norm_fused": nf, "grad_norm_naive": nn,
                   "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
                   "limits": {"loss": 1e-5, "grad_norm": 1e-4}},
           "bf16": {"loss_fused": lfb, "loss_naive": lnb,
                    "loss_fused_to_f32": abs(lfb - ln),
                    "loss_naive_to_f32": abs(lnb - ln),
                    "grad_norm_fused": nfb, "grad_norm_naive": nnb,
                    "grad_norm_fused_to_f32": abs(nfb - nn),
                    "grad_norm_naive_to_f32": abs(nnb - nn),
                    "rule": "fused bf16 within 2 x naive bf16's distance "
                            "from naive f32"},
           "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 fused and naive paths disagree")
    if not (abs(lfb - ln) <= 2 * abs(lnb - ln)
            and abs(nfb - nn) <= 2 * abs(nnb - nn)):
        raise AssertionError("bf16 fused path too far from the f32 path")
    return rec


def phase_serve_norm(fn, pa, serving, GPT, cfg, gpu):
    """The serve cell's model (openwebtext, block 1024, bf16) with
    norm_impl "fused" on the 16 serve requests: the norm kernel launches
    2 n_layer + 1 times a model forward (each decode step and each
    prefill), the backward never; one decode window's logits held to the
    plain-norm model's by window_agreement's rule."""
    import dataclasses

    mcfg = dataclasses.replace(cfg, norm_impl="fused")
    model = GPT.init(mcfg, torch.Generator().manual_seed(SEED), device=DEVICE,
                     dtype=torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    fn.fused_rms_norm_fwd.launches = fn.fused_rms_norm_bwd.launches = 0
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in ps]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm_fwd": fn.fused_rms_norm_fwd.launches,
                "rms_norm_bwd": fn.fused_rms_norm_bwd.launches,
                "paged_decode": pa.paged_decode_attention.launches}
    steps = eng.windows * eng.window
    forwards = steps + eng.prefill_dispatches
    want = {"rms_norm_fwd": (2 * cfg.n_layer + 1) * forwards,
            "rms_norm_bwd": 0, "paged_decode": cfg.n_layer * steps}
    tokens = [finished[r].tokens for r in rids]
    plain = copy.deepcopy(model)
    set_norm_impl(plain, "auto")
    check = window_agreement(model, serving, plain_model=plain)
    del plain
    rec = {"phase": "serve_norm", "config": "openwebtext", "dtype": "bfloat16",
           "norm_impl": "fused", **SERVE, "requests": N_REQUESTS,
           "max_new_tokens": MAX_NEW,
           "tokens": int(sum(len(x) for x in tokens)), "wall_s": wall,
           "tokens_per_s": sum(len(x) for x in tokens) / wall,
           "decode_steps": steps, "prefill_dispatches": eng.prefill_dispatches,
           "model_forwards": forwards, "launches": launches,
           "expected_launches": want,
           "launch_formula": "norm fwd = (2 n_layer + 1) x (decode steps + "
                             "prefills); norm bwd 0; paged decode = n_layer "
                             "x decode steps",
           "window_check_vs_plain_norm_bf16": check, "gpu": gpu}
    emit(rec)
    if not all(len(x) == MAX_NEW for x in tokens):
        raise AssertionError(f"lengths {[len(x) for x in tokens]}")
    if launches != want or launches["rms_norm_fwd"] == 0:
        raise AssertionError(f"launches {launches} != {want}")
    del model, eng
    return rec


def split_bounds(b, t, h, hkv, c, esz):
    """Least times of one dq and one dk/dv launch: the larger of bytes
    (qkv, dO, lse, delta, the tables and LN weights read once; dq, or dk
    and dv per q head, and the [B, H, T/64, C] f32 LN-weight partials
    written once) over HBM bandwidth and bf16 operations over the causal
    triangle (T (T + 1) / 2 entries a head) over the peak rate: three
    products for dq (S, dP, dS K), four for dk/dv (S, dP, P^T dO, dS^T Q),
    2 C operations per entry each."""
    f = (h + 2 * hkv) * c
    act = b * t * h * c * esz
    reads = b * t * f * esz + act + 2 * b * h * t * 4 + 2 * t * c * 4 + 2 * c * 4
    parts = b * h * (t // 64) * c * 4
    entries = b * h * t * (t + 1) // 2
    out = {}
    for name, nbytes, products in (("dq", reads + act + parts, 3),
                                   ("dkv", reads + 2 * act + parts, 4)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * 2 * c * entries / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, products * 2 * c * entries)
    return out


def norm_bounds(n, d, esz, use_weight):
    """Least times of one norm forward and backward: bytes (x read, y
    written, rstd written, w read; x, dy, rstd read, dx written) over HBM
    bandwidth; a few f32 operations an element are far below it."""
    w = 4 * d if use_weight else 0
    out = {}
    for name, nbytes, ops in (("fwd", 2 * n * d * esz + 4 * n + w, 3 * n * d),
                              ("bwd", 3 * n * d * esz + 4 * n + w, 6 * n * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_FLOPS[torch.float32]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     ops)
    return out


def sdpa_fwd_bwd_ms(fa, args, h, hkv, reps):
    """SDPA forward + backward (CUDA graph) on the already normed and
    roped q/k/v of ``args``: attention alone, the yardstick the fused
    kernels' rows use."""
    import torch.nn.functional as F

    qkv, wq, wk, sin, cos, dout = args
    b, t, _ = qkv.shape
    c = dout.shape[-1] // h
    q, k, v = fa._split(qkv, h, hkv)
    leaves = [a.detach().contiguous().requires_grad_() for a in (
        fa._ln_rope(q, wq, sin, cos, fa.EPS)[0].to(qkv.dtype),
        fa._ln_rope(k, wk, sin, cos, fa.EPS)[0].to(qkv.dtype), v)]
    dout_h = dout.reshape(b, t, h, c).transpose(1, 2).contiguous()

    def fb(i):
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=h != hkv)
        return torch.autograd.grad(o, leaves, dout_h)

    return device_ms(fb, reps=reps)


def prep_bound(b, t, h, hkv, c, esz):
    """Least time of one pre-pass launch: bytes (the raw q and k columns
    of qkv, O and dO read once; q^, k^ and delta written; the tables and
    LN weights read) over HBM bandwidth; its LayerNorm, RoPE and the
    delta sum, ~12 f32 operations an element, are far below it."""
    rows = b * t * (h + hkv) * c * esz
    act = b * t * h * c * esz
    nbytes = 2 * rows + 2 * act + b * h * t * 4 + 2 * t * c * 4 + 2 * c * 4
    ops = 12 * b * t * (h + hkv) * c + 2 * b * t * h * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def route_stages(by_kernel: tp.Dict[str, float]) -> tp.Dict[str, float]:
    """:func:`route_kernels_ms`' kernels summed by the split route's stage:
    the pre-pass, the dq kernel, the dk/dv kernel and PyTorch's ops (the
    LN-weight partial sums, the GQA sum)."""
    import re

    pats = {"prep": r"fused_bwd_prep", "dq": r"fused_dq",
            "dkv": r"fused_bwd_tile|fused_dkv"}
    out = dict.fromkeys([*pats, "torch_ops"], 0.0)
    for name, ms in by_kernel.items():
        out[next((k for k, pat in pats.items() if re.search(pat, name)),
                 "torch_ops")] += ms
    return out


def phase_timing_long(fa, fn, gpu):
    """The split route at one train_long microbatch (B=4, T=2048, H=12,
    C=64, bf16) and at the train cell's (B=8, T=1024) beside the combined
    kernel there, and the norm kernels at [8192, 768] bf16 (the rows of
    one train_long microbatch), each beside its plain version, its bound
    and the library's time for the same work (SDPA forward + backward for
    the split kernels, attention alone, and with the pre-pass added;
    F.rms_norm for the norms). Device time from CUDA graphs
    (:func:`device_ms`): the pre-pass, the dq and dk/dv kernels alone
    (given the pre-pass's q^ and k^), and the route whole; the route's
    kernels apart under the profiler."""
    import torch.nn.functional as F

    rec = {"phase": "timing", "kernels": "split route (pre-pass, dq, dkv), "
           "rms norm fwd / bwd", "gpu": gpu}
    split = {}
    for label, shape in (("t2048", LONG_TIMING),
                         ("t1024", TRAIN_TIMING)):
        b, t, h, hkv, c = (shape[k] for k in ("b", "t", "h", "hkv", "c"))
        args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=6)
        qkv, wq, wk, sin, cos, dout = args
        out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        qhat, khat, delta = fa.fused_attention_bwd_prep(
            qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout)
        tail = (lse, delta, dout, h, hkv)
        hats = dict(qhat=qhat, khat=khat)

        def dq(i):
            return fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail,
                                             **hats)

        def route(i):
            return fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out,
                                                lse, dout, h, hkv)

        ms = {"prep": device_ms(lambda i: fa.fused_attention_bwd_prep(
                  qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout),
                  reps=20),
              "dq": device_ms(dq, reps=10),
              "dkv": device_ms(lambda i: fa.fused_attention_bwd_dkv(
                  qkv, wq, wk, sin, cos, *tail, **hats), reps=10)}
        by_kernel = route_kernels_ms(lambda: route(0))
        row = {"shape": dict(shape, dtype="bfloat16"), "ms": ms,
               "route_ms": device_ms(route, reps=10),
               "ms_note": "dq, dkv: the kernels alone, given the pre-pass's "
                          "q^ and k^ (the pre-pass not included); prep: the "
                          "pre-pass with delta; route_ms: "
                          "fused_attention_bwd_split whole (pre-pass, dq, "
                          "dk/dv, the LN-weight partial sums)",
               "route_device_ms_by_kernel": by_kernel,
               "route_device_ms_by_stage": route_stages(by_kernel)}
        if label == "t2048":
            row["plain_ms"] = {
                "prep": device_ms(
                    lambda i: fa.fused_attention_bwd_prep_reference(
                        qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout),
                    reps=2),
                "dq": device_ms(lambda i: fa.fused_attention_bwd_dq_reference(
                    qkv, wq, wk, sin, cos, *tail, **hats), reps=1),
                "dkv": device_ms(
                    lambda i: fa.fused_attention_bwd_dkv_reference(
                        qkv, wq, wk, sin, cos, *tail, **hats), reps=1)}
            got = split_run(fa, args, h, hkv, kernel=True)
            ref32 = split_run(fa, [a.float() for a in args], h, hkv,
                              kernel=False)
            row["max_abs_err_vs_plain_f32"] = {
                n: (g.float() - r).abs().max().item()
                for n, g, r in zip(("out", "lse") + SPLIT_OUTS, got, ref32)}
            del got, ref32
            prep = prep_readings(fa, args, h, hkv)[0]
            row["max_abs_err_vs_plain_f32"].update(
                {k: v[0] for k, v in prep.items()})
            sdpa = sdpa_fwd_bwd_ms(fa, args, h, hkv, reps=5)
            row["library_ms"] = {"sdpa_fwd_bwd": sdpa,
                                 "sdpa_fwd_bwd_plus_prep": sdpa + ms["prep"]}
        else:
            row["combined_bwd_ms"] = device_ms(
                lambda i: fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out,
                                                 lse, dout, h, hkv), reps=10)
            row["split_bwd_ms"] = row["route_ms"]
        bounds = split_bounds(b, t, h, hkv, c, qkv.element_size())
        bounds["prep"] = prep_bound(b, t, h, hkv, c, qkv.element_size())
        # the route's function is the whole backward: five products at
        # least (the combined kernel's count), bytes of its inputs/outputs
        bounds["route"] = fused_bounds(b, t, h, hkv, c,
                                       qkv.element_size())["bwd"]
        times = dict(ms, route=row["route_ms"])
        row.update({"bound_ms": {k: v[0] for k, v in bounds.items()},
                    "bound_by": {k: v[1] for k, v in bounds.items()},
                    "bytes": {k: v[2] for k, v in bounds.items()},
                    "flops": {k: v[3] for k, v in bounds.items()},
                    "frac_of_bound": {k: bounds[k][0] / times[k]
                                      for k in times}})
        split[label] = row
        del args, qkv, out, lse, delta, dout, qhat, khat, hats
        gc.collect()
        torch.cuda.empty_cache()
    rec["split"] = split

    # launches rotate over NORM_BUFS inputs (8 x 25 MB forward, 38 MB
    # backward), more than the 50 MB L2 holds: each launch reads device
    # memory, as in a training step
    n, d = NORM_SHAPES[0]
    eps = NORM_EPS[0]
    gen = torch.Generator().manual_seed(SEED + 7)
    bufs = [tuple(torch.randn(n, d, generator=gen).to(DEVICE, torch.bfloat16)
                  for _ in range(2)) for _ in range(NORM_BUFS)]
    rstds = [fn.fused_rms_norm_fwd(x, None, eps)[1] for x, _ in bufs]
    leaves = [x.detach().requires_grad_() for x, _ in bufs]

    def pick(i):
        j = i % NORM_BUFS
        return bufs[j][0], bufs[j][1], rstds[j], leaves[j]

    ms = {"fwd": device_ms(lambda i: fn.fused_rms_norm_fwd(
              pick(i)[0], None, eps), reps=48),
          "bwd": device_ms(lambda i: fn.fused_rms_norm_bwd(
              pick(i)[0], None, pick(i)[2], pick(i)[1]), reps=48)}
    plain_ms = {"fwd": device_ms(lambda i: fn.fused_rms_norm_forward_reference(
                    pick(i)[0], None, eps), reps=8),
                "bwd": device_ms(
                    lambda i: fn.fused_rms_norm_backward_reference(
                        pick(i)[0], None, pick(i)[2], pick(i)[1]), reps=8)}

    def lib_fwd_bwd(i):
        x, dy, _, xl = pick(i)
        return torch.autograd.grad(F.rms_norm(xl, (d,), eps=eps), xl, dy)

    lib = {"fwd": device_ms(lambda i: F.rms_norm(pick(i)[0], (d,), eps=eps),
                            reps=48),
           "fwd_bwd": device_ms(lib_fwd_bwd, reps=48)}
    lib["bwd"] = lib["fwd_bwd"] - lib["fwd"]
    x, dy = bufs[0]
    y, rstd = fn.fused_rms_norm_fwd(x, None, eps)
    y32, r32 = fn.fused_rms_norm_forward_reference(x.float(), None, eps)
    dx = fn.fused_rms_norm_bwd(x, None, rstd, dy)
    dx32 = fn.fused_rms_norm_backward_reference(x.float(), None, r32,
                                                dy.float())
    bounds = norm_bounds(n, d, x.element_size(), False)
    rec["norm"] = {
        "shape": {"N": n, "D": d, "dtype": "bfloat16", "weight": False},
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "bytes": {k: v[2] for k, v in bounds.items()},
        "frac_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
        "library_ms": lib,
        "library_note": "F.rms_norm forward, and forward + autograd "
                        "backward, each a CUDA graph over the same rotating "
                        "inputs; bwd = their difference",
        "max_abs_err_vs_plain_f32": {
            "y": (y.float() - y32).abs().max().item(),
            "dx": (dx.float() - dx32).abs().max().item()}}
    emit(rec)
    return rec


def compiled_kernels(build, name: str, log: str) -> tp.Dict[str, dict]:
    """Per kernel of one library (``name<C>``): ptxas's registers, shared
    memory and spill bytes from the build log, and the HGMMA (``wgmma``)
    instructions in its SASS (cuobjdump; None where the toolkit lacks
    it)."""
    import re
    import shutil

    types = {"f": "float", "a": "int8_t", "13__nv_bfloat16": "bf16"}
    arg = r"L[ib]\d+E|13__nv_bfloat16|f|a|S\d*_"

    def short(mangled: str) -> str:
        # integer, bool and type template arguments (Li64E, Lb1E, f) kept
        # in order, so that instances of one template stay apart; bools
        # and types spelt as in the source (a substitution, S1_, repeats
        # the type before it)
        m = re.search(r"_cu_[0-9a-f]{8}\d+([A-Za-z_]\w*?_kernel)"
                      rf"I((?:{arg})+)E", mangled)
        if not m:
            return mangled
        args = []
        for a in re.findall(arg, m.group(2)):
            if a.startswith("Lb"):
                args.append("true" if a[2:-1] == "1" else "false")
            elif a.startswith("Li"):
                args.append(a[2:-1])
            else:
                args.append(args[-1] if a.startswith("S") else types[a])
        return f"{m.group(1)}<{', '.join(args)}>"

    out: tp.Dict[str, dict] = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = out.setdefault(short(m.group(1)), {})
        elif cur is not None and "Used" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
        elif cur is not None and "spill" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(st), int(ld)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", build.library_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        cur = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = out.setdefault(short(ln.split("Function :")[1].strip()),
                                     {})
                cur["hgmma"] = 0
            elif cur is not None and "HGMMA" in ln:
                cur["hgmma"] += 1
    return out


def dynamic_smem(build, pa) -> tp.Dict[str, int]:
    """The dynamic shared memory each bf16 wgmma kernel launches with, as
    its launcher computes it (ptxas reports static shared memory only),
    and the paged split kernel's at the serve cells' shapes (openwebtext,
    bf16 pool, PS=16: decode G=1 with R recent rows, verify G T = T =
    speculate + 1)."""
    import ctypes

    fused = build.load("fused_attn").fused_attn_smem_bytes
    flash = build.load("flash").flash_smem_bytes
    for fn in (fused, flash):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2
    out = {}
    for c in (64, 128):
        out[f"fused_fwd_wgmma_kernel<{c}>"] = fused(c, 0)
        out[f"fused_dq_tile_kernel<{c}>"] = fused(c, 1)
        out[f"fused_bwd_tile_kernel<{c}, false>"] = fused(c, 2)
        out[f"fused_bwd_tile_kernel<{c}, true>"] = fused(c, 3)
        out[f"flash_fwd_wgmma_kernel<{c}>"] = flash(c, 0)
        for drop in ("false", "true"):
            out[f"flash_dkv_tile_kernel<{c}, {drop}>"] = flash(c, 2)
            for own in ("false", "true"):
                out[f"flash_dq_tile_kernel<{c}, {drop}, {own}>"] = flash(c, 1)
    tt = SPEC["speculate"] + 1
    for kind, rows, rr in (("decode", 1, R), ("verify", tt, tt)):
        out[f"paged_split_kernel<bf16, bf16, 64> ({kind}, rows {rows})"] = (
            pa.smem_bytes(rows, 64, PS, 2, rr, 2))
    return out


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
    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": build.SOURCES, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": {k: compiled_kernels(build, k, v)
                      for k, v in logs.items()},
          "dynamic_smem_bytes": dynamic_smem(build, pa)})

    kernel_err = phase_kernel(pa)
    cfg = get_model_config("openwebtext")
    model, launches = phase_serve(pa, serving, GPT, cfg)
    del model
    torch.cuda.empty_cache()
    timing = phase_timing(pa, cfg, gpu)
    verify_err = phase_verify_kernel(pa)
    long_err = phase_long_table(pa)
    spec = phase_serve_spec(pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tverify = phase_timing_verify(pa, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    int8_err = phase_kernel_int8(pa)
    serve8 = phase_serve_int8(pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    t8 = phase_timing_int8(pa, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    from midgpt_tpu_torch.ops import fused_attn as fa

    train_kernel_err = phase_train_kernel(fa)
    train = phase_train(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_profile(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    ttrain = phase_timing_train(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    from midgpt_tpu_torch.ops import flash as fl

    flash_err = phase_flash_kernel(fl)
    char = phase_train_char(fl, fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_profile(gpu, "shakespeare_char", CHAR_SET)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_char(fl, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tflash = phase_timing_flash(fl, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    from midgpt_tpu_torch.ops import fused_norm as fn

    split_err = phase_split_kernel(fa)
    norm_err = phase_norm_kernel(fn)
    long = phase_train_long(fa, fn, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_profile(gpu, overrides=LONG_SET, long=True)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_long(fa, fn, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    serve_norm = phase_serve_norm(fn, pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tlong = phase_timing_long(fa, fn, gpu)

    paged_kernels = ("paged_split_kernel<bf16, {}, 64> (splits; each "
                     "(slot, KV head)'s last block merges)")
    kernels = [{
        "name": "paged_decode_attention",
        "kernel": paged_kernels.format("bf16"),
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
        "replaces": "midgpt_tpu/ops/paged_attn.py:302",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "kernel_phase_max_abs_err": kernel_err,
        "long_table_phase_max_abs_err": long_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
    }, {
        "name": "paged_verify_attention",
        "kernel": paged_kernels.format("bf16"),
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
        "replaces": "midgpt_tpu/ops/paged_attn.py:531",
        "launches": spec["verify_kernel_launches"],
        "max_abs_err": tverify["max_abs_err"],
        "verify_kernel_phase_max_abs_err": verify_err,
        "ms": tverify["ms"], "plain_ms": tverify["plain_ms"],
        "bound_ms": tverify["bound_ms"], "bound_by": tverify["bound_by"],
        "library_ms": None,
    }]
    for kind, line, run, counter in (
            ("decode", 302, "int8_off", "decode_launches"),
            ("verify", 531, "int8_on", "verify_launches")):
        kernels.append({
            "name": f"paged_{kind}_attention[int8]",
            "kernel": paged_kernels.format("int8_t"),
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
            "replaces": f"midgpt_tpu/ops/paged_attn.py:{line}",
            "launches": serve8[run][counter],
            "max_abs_err": t8[kind]["max_abs_err"],
            "kernel_int8_phase_max_abs_err": int8_err,
            "ms": t8[kind]["ms"], "plain_ms": t8[kind]["plain_ms"],
            "bound_ms": t8[kind]["bound_ms"],
            "bound_by": t8[kind]["bound_by"], "library_ms": None,
        })
    for kind, name, line, out, kernel in (
            ("fwd", "fused_attention_fwd", 137, "out",
             "fused_fwd_prep_kernel<64> + fused_fwd_wgmma_kernel<64>"),
            ("bwd", "fused_attention_bwd", 444, "dqkv",
             "fused_bwd_prep_kernel<64> + fused_bwd_tile_kernel<64, true> "
             "+ fused_bwd_post_kernel<64>")):
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_attn.cu",
            "replaces": f"midgpt_tpu/ops/fused_attn.py:{line}",
            "launches": train[f"fused_{kind}_launches"],
            "max_abs_err": ttrain["max_abs_err_vs_plain_f32"][out],
            "train_kernel_phase_max_abs_err": train_kernel_err,
            "ms": ttrain["ms"][kind], "plain_ms": ttrain["plain_ms"][kind],
            "bound_ms": ttrain["bound_ms"][kind],
            "bound_by": ttrain["bound_by"][kind],
            "library_ms": ttrain["library_ms"][kind],
        })
    # the forward also at one train_long microbatch (B=4, T=2048)
    kernels[-2]["t2048"] = {k: ttrain["fwd_t2048"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for kind, line, outs, kernel in (
            ("fwd", 156, ("out",), "flash_fwd_wgmma_kernel<64>"),
            ("dq", 300, ("dq", "delta"),
             "flash_dq_tile_kernel<64, true, true> (forms delta)"),
            ("dkv", 367, ("dk", "dv"), "flash_dkv_tile_kernel<64, true>")):
        counter = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
        # the main path's dq forms delta: its time and bound are those of
        # dq_delta; dq given delta stands beside it
        row = "dq_delta" if kind == "dq" else kind
        kernels.append({
            "name": counter, "kernel": kernel, "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/flash.cu",
            "replaces": f"midgpt_tpu/ops/flash.py:{line}",
            "launches": char["launches"][counter],
            "max_abs_err": max(tflash["max_abs_err_vs_plain_f32"][o]
                               for o in outs),
            "flash_kernel_phase_max_abs_err": flash_err,
            "ms": tflash["ms"][row], "plain_ms": tflash["plain_ms"][row],
            "bound_ms": tflash["bound_ms"][row],
            "bound_by": tflash["bound_by"][row],
            "library_ms": (tflash["library_ms"]["sdpa_fwd_dropout"]
                           if kind == "fwd" else None),
        })
        if kind == "dq":
            kernels[-1]["given_delta"] = {
                k: tflash[k]["dq"] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")}
    t2048 = tlong["split"]["t2048"]
    # the split route: the pre-pass (the LN + RoPE, _ln_rope at :91, that
    # the Pallas split kernels run inside their walks), then the two
    # kernels; times exclude the pre-pass, which has its own entry
    for kind, line, kernel, outs in (
            ("prep", 91, "fused_bwd_prep_kernel<64>",
             ("qhat", "khat", "delta")),
            ("dq", 292, "fused_dq_tile_kernel<64>", ("dq",)),
            ("dkv", 365, "fused_bwd_tile_kernel<64, false>",
             ("dk_h", "dv_h"))):
        kernels.append({
            "name": f"fused_attention_bwd_{kind}", "kernel": kernel,
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_attn.cu",
            "replaces": f"midgpt_tpu/ops/fused_attn.py:{line}",
            "launches": long["launches"][f"fused_bwd_{kind}"],
            "max_abs_err": max(t2048["max_abs_err_vs_plain_f32"][n]
                               for n in outs),
            "max_abs_err_lnw_grad": (t2048["max_abs_err_vs_plain_f32"][
                "dwq" if kind == "dq" else "dwk"] if kind != "prep"
                else None),
            "split_kernel_phase_max_abs_err": split_err[
                "prep" if kind == "prep" else "split"],
            "ms": t2048["ms"][kind], "plain_ms": t2048["plain_ms"][kind],
            "bound_ms": t2048["bound_ms"][kind],
            "bound_by": t2048["bound_by"][kind],
            "library_ms": (None if kind == "prep"
                           else t2048["library_ms"]["sdpa_fwd_bwd"]),
        })
    tnorm = tlong["norm"]
    for kind, line in (("fwd", 35), ("bwd", 45)):
        kernels.append({
            "name": f"fused_rms_norm_{kind}", "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_norm.cu",
            "replaces": f"midgpt_tpu/ops/fused_norm.py:{line}",
            "launches": long["launches"][f"rms_norm_{kind}"],
            "serve_norm_launches": serve_norm["launches"][f"rms_norm_{kind}"],
            "max_abs_err": tnorm["max_abs_err_vs_plain_f32"][
                "y" if kind == "fwd" else "dx"],
            "norm_kernel_phase_max_abs_err": norm_err,
            "ms": tnorm["ms"][kind], "plain_ms": tnorm["plain_ms"][kind],
            "bound_ms": tnorm["bound_ms"][kind],
            "bound_by": tnorm["bound_by"][kind],
            "library_ms": tnorm["library_ms"][kind],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
