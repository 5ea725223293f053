"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The paged decode kernel is held, element by element, to its plain
PyTorch version run in f32 on the same inputs upcast (the plain version
upcasts them itself): within 1e-5 (the two sum in different orders) plus,
for a bf16 output, the one final rounding: half a bf16 ulp, at most 2^-8
of the rounded value.

The paged verify kernel shares the decode kernel's body and is held the
same way; a verify row t must equal the decode kernel's step t over the
same pages with the candidate rows as recent rows, bit for bit (the two
sum in the same order). Both split the table into runs of pages and merge
the splits' softmax states in a fixed order: they are held over tables of
many splits and over a 32,768-token one, give the same bits on every
call, and take a 100k-token table (the split's shared memory does not
grow with it) with the bits of the short table over the same live pages.

The fused attention kernels round inside (q, k, P and ds), so in bf16
each output is held by the triangle rule: at most twice as far from the
plain version run in f32 on the upcast inputs as the plain bf16 version
is. In f32 each element is within ``1e-5 + 1e-5 |plain|`` (forward) or
``1e-5 + 1e-4 |plain|`` (backward: three sums over T and the LayerNorm
backward's mean subtraction).

The split backward's dq and dk/dv kernels are held like the combined
one, against their own plain versions given the same lse and delta; the
fused RMSNorm kernels element by element like the paged kernels (1e-5
plus half a bf16 ulp of the output).

The flash kernels (forward, dq, dk/dv) are held the same way, with and
without dropout. Their lse is computed from the same upcast q and k in
f32 by the plain version in either dtype, so in bf16 too it is held by
the f32 rule; the check is checked with the plain version run at seed +
1 (dropout) or with k and v shifted by one row. Both are also run at
their edge shapes: the flash forward's 128-row blocks at T = 64 and 192
(the second warpgroup idles), the combined backward at its cap (T=1024
at C=64, 2048 at C=128, the most dq groups).

The flash dq kernel forms delta = rowsum(dO * O) - dlse for its q tile
and writes it: held to the plain delta in f32 (1e-5 + 1e-5 |plain|),
and dq given that delta equals, bit for bit, dq forming it.

The bf16 flash forward, dq and dk/dv kernels, the bf16 fused forward (its
pre-pass and the flash forward's core), the bf16 combined backward and
the bf16 split route (pre-pass, dq and dk/dv kernels; wgmma) must give
the same bits on every call: two calls on the same inputs are compared
with ``torch.equal``. The split kernels also run at T % 128 == 64 (a
dk/dv block with the middle k tile alone), the fused forward too (a
128-row block whose second warpgroup idles), and the flash kernels
without the causal mask (one k tile a dk/dv block); the fused forward's
own pre-pass counts as the forward's launch, not as a backward pre-pass.

The int8 matmul kernel is held element by element to the plain product
in f32 on the same inputs (x upcast, the codes dequantized): within
2^-14 of ``(|x| @ |codes|) * scale`` (another summation order, the
tensor cores' own rounding) plus, for a bf16 output, half a bf16 ulp; at
the decode, verify and prefill rows, with codes -127 and 127 and po2
scales from 2^-30 to 2^6, bf16 and f32 x, a ragged width and one row.
A QuantLinear call on the card allocates no full-precision copy of its
weight. The engine serves a prefix-cache hit and a chunked prefill on the
card through the paged kernels (and the int8 kernels under int8), with
the cache-off streams (f32). Under load (``openwebtext`` at depth 2, a
pool smaller than the slots' worst case, a fault plan that quarantines
every free page, a cancel) growth evicts and a lone request parks and
resumes, with the page invariants after every step and no page left
held or quarantined; at f32 the streams equal an uncontended run's,
with a bf16 and with an int8 pool.

The tensor axis: the trainer's tensor-parallel modules (a fused-route
block, MHA and GQA; an MoE layer; the vocab-parallel embedding and
chunked loss) on a loopback exchange of 2 and 4 virtual ranks, bf16, held
by the triangle rule to the same module unsharded in f32, the block at
one fused launch a virtual rank; a world of one NCCL rank at ``tensor=1``
runs the sharded step program to the single-card rows bit for bit.

Serving under the tensor axis: the paged decode and verify kernels at a
tensor rank's heads (openwebtext_xl's 4 at tensor 4, llama_7b's 2 in
groups of 4, C 128) and the int8 product at a rank's column- and
row-parallel shapes, held to their plain versions; a loopback engine at
tensor 2 on a small model serves the tp = 1 streams at f32 (greedy,
speculation, int8 weights and pool), every virtual rank's paged kernels
launched.

The pipeline axis: a small model's GPipe stages on the loopback (2 and 4
stages), bf16 held by the triangle rule and f32 by the flash f32 rule to
the same model unpipelined over the same microbatches, its fused
launches counted (the recompute's forward twice); one card's pipelined
step program replays to the unpipelined program at ``g_accum_iters =
M`` bit for bit; two cards at ``pipeline=2`` against one (skipped with
one card).

The trainer's rest: ``PrefetchLoader`` copies each batch to the card on
a side stream and the consumer's batches equal the loader's while its
own stream runs work; an asynchronous save of card tensors snapshots
them into pinned buffers (reused) before it returns; remat "dots" and
"full" give "none"'s loss and gradients bit for bit through the fused
kernels, the forward launched again in the backward.

Spill and the front door: a card pool's pages (bf16, and int8 with their
scale planes) exported to pinned host memory and imported back into
scribbled pages read back bit for bit, the copies queued on the stream;
a spill-mode engine at f32 under pressure faults its spilled prefixes
back through the paged kernels with the ample pool's streams; the front
door's background task steps the engine from a worker thread on the
engine's stream, with the synchronous loop's streams.

The programs: a capture pauses Python's cyclic collector; the sampler
makes new programs when the model's tensors are replaced.

The mesh: the keyed dropout kernel at an element offset (a rank's first
row) equals its plain version there, the index wrapping at 2^32; a
world of one NCCL rank runs the sharded step program (its all-gather,
reduce-scatter and all-reduces captured in the step's graph and counted
a replay) with the single-card program's loss, grad norm, lr, masters
and moments bit for bit; with two cards a world of two on the same
global batches within a bf16 tolerance (skipped with one card).
"""

import dataclasses
import os

import pytest
import torch

from midgpt_tpu_torch.config import ModelConfig, get_model_config
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.serving import FaultPlan, ServingEngine, generate_served

from torch_dist_util import chip_smoke

PS, PMAX, R = 16, 8, 4
LENS = [0, 7, 16, 61, PMAX * PS]  # empty, mid-page, page-aligned, full table


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _pages_home(eng):
    """After a drain: no page held, the allocator and the prefix index
    consistent, and clearing the cold cache frees every page."""
    assert eng.alloc.held_pages == 0
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc)
    cached = eng.alloc.cached_pages
    assert eng.clear_prefix_cache() == cached
    assert eng.alloc.free_pages == eng.alloc.num_pages


def _inputs(dev, hkv, g, c, dtype, lens=LENS, pmax=PMAX, seed=0):
    gen = torch.Generator().manual_seed(seed)
    live = [-(-n // PS) for n in lens]
    num_pages = sum(live) + 2
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    q = f(len(lens), hkv, g, c)
    pk, pv = f(2, num_pages, hkv, c, PS), f(2, num_pages, hkv, c, PS)
    rk, rv = f(len(lens), hkv, R, c), f(len(lens), hkv, R, c)
    bt = torch.full((len(lens), pmax), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen)
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = perm[at : at + n].to(torch.int32)
        at += n
    floats = [a.to(dev, dtype) for a in (q, pk, pv)]
    ints = [bt.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)]
    return floats + ints + [a.to(dev, dtype) for a in (rk, rv)]


def _err_over_tol(got, args, r, layer):
    """Per slot, the max over its elements of |kernel - plain f32| over
    the tolerance: ``[S]``."""
    q, pk, pv, bt, pl, rk, rv = args
    ref32 = pa.paged_decode_attention_reference(
        q.float(), pk.float(), pv.float(), bt, pl, rk.float(), rv.float(),
        r, layer)
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + 1e-5
    return ((got.float() - ref32).abs() / tol).flatten(1).amax(1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv,g,c", [(4, 1, 64), (2, 4, 128), (3, 3, 64)],
                         ids=["mha", "gqa", "gqa3"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, hkv, g, c, r):
    args = _inputs(cuda_device, hkv, g, c, dtype)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(*args, r, 1)
    torch.cuda.synchronize()
    assert pa.paged_decode_attention.launches == before + 1
    ref = pa.paged_decode_attention_reference(*args, r, 1)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (_err_over_tol(got, args, r, 1) <= 1.0).all()
    # the same check refuses an output with each slot's last row dropped,
    # in every slot that had a row to drop
    fault = pa.paged_decode_attention(*args[:4], (args[4] - 1).clamp_min(0),
                                      *args[5:], r, 1)
    live = torch.tensor(LENS, device=cuda_device) > 0
    assert (_err_over_tol(fault, args, r, 1)[live] > 1.0).all()


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_what_it_cannot_take(cuda_device):
    q, pk, pv, bt, pl, rk, rv = _inputs(cuda_device, 2, 1, 64, torch.float32)
    before = pa.paged_decode_attention.launches
    with pytest.raises(ValueError, match="C in"):
        pa.paged_decode_attention(q[..., :32].contiguous(),
                                  pk[..., :32, :].contiguous(),
                                  pv[..., :32, :].contiguous(), bt, pl,
                                  rk[..., :32].contiguous(),
                                  rv[..., :32].contiguous(), 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(
            0, 1), pk, pv, bt, pl, rk, rv, 0, 0)
    assert pa.paged_decode_attention.launches == before
    # a 100k-token table (6250 pages) is taken: the split block's shared
    # memory does not grow with the table, and pads past the live pages
    # are never read, so it gives the short table's bits
    wide = torch.full((bt.shape[0], 6250), pk.shape[1], dtype=torch.int32,
                      device=cuda_device)
    wide[:, :bt.shape[1]] = bt
    short = pa.paged_decode_attention(q, pk, pv, bt, pl, rk, rv, 0, 0)
    assert torch.equal(
        pa.paged_decode_attention(q, pk, pv, wide, pl, rk, rv, 0, 0), short)


@pytest.mark.cuda
def test_engine_decodes_through_the_kernel(cuda_device):
    cfg = ModelConfig(block_size=128, vocab_size=512, n_layer=2, n_head=2,
                      n_embd=128)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    eng = ServingEngine(model, slots=3, window=4, page_size=16,
                        device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    rids = [eng.submit(torch.randint(0, 512, (n,), generator=gen).numpy(), 9)
            for n in (5, 40, 17, 70)]
    pa.paged_decode_attention.launches = 0
    done = eng.run()
    assert pa.paged_decode_attention.launches == (
        cfg.n_layer * eng.window * eng.windows)
    assert all(len(done[r].tokens) == 9 for r in rids)
    _pages_home(eng)


VSTARTS = [0, 7, 16, 61, PMAX * PS - 8]  # empty, partial, aligned, near full


def _verify_inputs(dev, hkv, g, tt, c, dtype, starts=VSTARTS, seed=0,
                   pmax=PMAX):
    gen = torch.Generator().manual_seed(seed)
    live = [-(-(n + tt) // PS) for n in starts]
    num_pages = sum(live) + 2
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    s = len(starts)
    q = f(s, hkv, g, tt, c)
    kc, vc = f(s, hkv, tt, c), f(s, hkv, tt, c)
    pk, pv = f(2, num_pages, hkv, c, PS), f(2, num_pages, hkv, c, PS)
    bt = torch.full((s, pmax), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen)
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = perm[at : at + n].to(torch.int32)
        at += n
    floats = [a.to(dev, dtype) for a in (q, kc, vc, pk, pv)]
    return floats + [bt.to(dev),
                     torch.tensor(starts, dtype=torch.int32, device=dev)]


def _verify_err_over_tol(got, args, layer):
    q, kc, vc, pk, pv, bt, st = args
    ref32 = pa.paged_verify_attention_reference(
        q.float(), kc.float(), vc.float(), pk.float(), pv.float(), bt, st,
        layer)
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + 1e-5
    return ((got.float() - ref32).abs() / tol).flatten(1).amax(1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv,g,c", [(4, 1, 64), (2, 4, 128)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("tt", [1, 5])
def test_paged_verify_kernel_matches_plain(cuda_device, dtype, hkv, g, c, tt):
    args = _verify_inputs(cuda_device, hkv, g, tt, c, dtype)
    before = pa.paged_verify_attention.launches
    got = pa.paged_verify_attention(*args, 1)
    torch.cuda.synchronize()
    assert pa.paged_verify_attention.launches == before + 1
    ref = pa.paged_verify_attention_reference(*args, 1)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert (_verify_err_over_tol(got, args, 1) <= 1.0).all()
    # the check refuses each slot's last resident column dropped
    fault = pa.paged_verify_attention(*args[:6], (args[6] - 1).clamp_min(0),
                                      1)
    live = torch.tensor(VSTARTS, device=cuda_device) > 0
    assert (_verify_err_over_tol(fault, args, 1)[live] > 1.0).all()
    # row t is the decode kernel's step t with the rows as recent rows
    q, kc, vc, pk, pv, bt, st = args
    for r in range(tt):
        step = pa.paged_decode_attention(q[:, :, :, r].contiguous(), pk, pv,
                                         bt, st, kc, vc, r, 1)
        assert torch.equal(got[:, :, :, r], step)


@pytest.mark.cuda
def test_paged_verify_kernel_refuses_what_it_cannot_take(cuda_device):
    args = _verify_inputs(cuda_device, 2, 4, 8, 128, torch.float32)
    q, kc, vc, pk, pv, bt, st = args
    before = pa.paged_verify_attention.launches
    with pytest.raises(ValueError, match="C in"):
        pa.paged_verify_attention(*(a[..., :32].contiguous() for a in
                                    (q, kc, vc)),
                                  pk[..., :32, :].contiguous(),
                                  pv[..., :32, :].contiguous(), bt, st, 0)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        pa.paged_verify_attention(q.half(), kc.half(), vc.half(), pk.half(),
                                  pv.half(), bt, st, 0)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_verify_attention(q.transpose(0, 1).contiguous().transpose(
            0, 1), kc, vc, pk, pv, bt, st, 0)
    with pytest.raises(ValueError, match="self rows"):
        pa.paged_verify_attention(q, kc[:, :, :4], vc, pk, pv, bt, st, 0)
    assert pa.paged_verify_attention.launches == before
    # a 100k-token table is taken, with the short table's bits
    wide = torch.full((bt.shape[0], 6250), pk.shape[1], dtype=torch.int32,
                      device=cuda_device)
    wide[:, :bt.shape[1]] = bt
    short = pa.paged_verify_attention(q, kc, vc, pk, pv, bt, st, 0)
    assert torch.equal(pa.paged_verify_attention(q, kc, vc, pk, pv, wide, st,
                                                 0), short)


@pytest.mark.cuda
def test_engine_speculates_through_the_verify_kernel(cuda_device):
    """Greedy f32 spec-on streams equal spec-off on the card, every
    dispatch a verify dispatch through the kernel."""
    cfg = ModelConfig(block_size=128, vocab_size=512, n_layer=2, n_head=2,
                      n_embd=128)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    motif = torch.randint(0, 512, (4,), generator=gen)
    prompts = [torch.randint(0, 512, (n,), generator=gen).numpy()
               for n in (5, 40, 17)] + [motif.repeat(10).numpy()]
    kw = dict(slots=3, page_size=16, device=cuda_device)
    off = generate_served(model, prompts, 12, **kw)
    pa.paged_verify_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    eng = ServingEngine(model, speculate=4, **kw)
    rids = [eng.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
    done = eng.run()
    assert pa.paged_decode_attention.launches == 0
    assert pa.paged_verify_attention.launches == (
        cfg.n_layer * eng.verify_dispatches) > 0
    for r, ref in zip(rids, off):
        assert done[r].tokens == ref.tolist()
    _pages_home(eng)


# tables of many splits (four pages of 16 a split): empty, one token, a
# split boundary -1, at and +1, mid-table, the full table
SPLIT_PMAX = 40
SPLIT_LENS = [0, 1, 63, 64, 65, 301, SPLIT_PMAX * PS]
LONG_PMAX = 2048  # 32,768 tokens
LONG_LENS = [LONG_PMAX * PS, 9001, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv,g,c", [(4, 1, 64), (2, 4, 128)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("table", ["splits", "long"])
def test_paged_kernels_match_plain_over_split_tables(cuda_device, dtype, hkv,
                                                     g, c, table):
    """Decode (both recent rows) and verify (T=5) over a table of ten
    splits and over a 32,768-token table, held to the plain version; the
    verify rows equal the decode steps bit for bit."""
    pmax, lens = ((SPLIT_PMAX, SPLIT_LENS) if table == "splits"
                  else (LONG_PMAX, LONG_LENS))
    args = _inputs(cuda_device, hkv, g, c, dtype, lens=lens, pmax=pmax)
    for r in (0, R - 1):
        got = pa.paged_decode_attention(*args, r, 1)
        assert (_err_over_tol(got, args, r, 1) <= 1.0).all()
    tt = 5
    starts = [min(n, pmax * PS - tt) for n in lens]
    vargs = _verify_inputs(cuda_device, hkv, g, tt, c, dtype, starts=starts,
                           pmax=pmax)
    got = pa.paged_verify_attention(*vargs, 1)
    torch.cuda.synchronize()
    assert (_verify_err_over_tol(got, vargs, 1) <= 1.0).all()
    q, kc, vc, pk, pv, bt, st = vargs
    for r in range(tt):
        step = pa.paged_decode_attention(q[:, :, :, r].contiguous(), pk, pv,
                                         bt, st, kc, vc, r, 1)
        assert torch.equal(got[:, :, :, r], step)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_bf16_kernels_are_deterministic(cuda_device, kind):
    """Two calls on the same inputs give the same bits: the splits' states
    merge in a fixed order, no atomics."""
    if kind == "decode":
        args = _inputs(cuda_device, 2, 4, 128, torch.bfloat16,
                       lens=SPLIT_LENS, pmax=SPLIT_PMAX)
        first, again = (pa.paged_decode_attention(*args, R - 1, 1)
                        for _ in range(2))
    else:
        starts = [min(n, SPLIT_PMAX * PS - 5) for n in SPLIT_LENS]
        args = _verify_inputs(cuda_device, 2, 4, 5, 128, torch.bfloat16,
                              starts=starts, pmax=SPLIT_PMAX)
        first, again = (pa.paged_verify_attention(*args, 1)
                        for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, again)


# -- the int8 branch of the paged kernels -----------------------------------


def _int8_case(dev, kind, hkv, g, c, dtype):
    """Decode (r = R - 1) or verify (T = 5) inputs over an int8 pool: the
    float inputs' pages quantized, each (layer, page, KV head) on its own
    po2 grid (``po2_ceil(absmax / 127)``), and bf16 self rows. Returns
    ``(q, pages, planes, bt, lens, rows)``."""
    from midgpt_tpu_torch.quant import po2_ceil_exact

    if kind == "decode":
        q, pk, pv, bt, lens, rk, rv = _inputs(dev, hkv, g, c, dtype)
    else:
        q, rk, rv, pk, pv, bt, lens = _verify_inputs(dev, hkv, g, 5, c,
                                                     dtype)
    planes = [po2_ceil_exact(x.float().abs().amax((-1, -2)) / 127.0)
              for x in (pk, pv)]
    pages = [torch.round(x.float() / p[..., None, None]).to(torch.int8)
             for x, p in zip((pk, pv), planes)]
    return q, pages, planes, bt, lens, [x.to(torch.bfloat16) for x in (rk, rv)]


def _int8_call(kind, fn, q, pages, planes, bt, lens, rows):
    """``fn`` (a wrapper or a plain version) at layer 1 with each slot's
    scales gathered from ``planes``; with ``planes`` None ``pages`` is a
    float pool and no scales are passed."""
    layer = 1
    scales = [] if planes is None else [
        p[layer][bt.long().clamp(0, p.shape[1] - 1)] for p in planes]
    if kind == "decode":
        return fn(q, *pages, bt, lens, *rows, R - 1, layer, *scales)
    return fn(q, *rows, *pages, bt, lens, layer, *scales)


def _int8_fns(kind):
    if kind == "decode":
        return pa.paged_decode_attention, pa.paged_decode_attention_reference
    return pa.paged_verify_attention, pa.paged_verify_attention_reference


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv,g,c", [(4, 1, 64), (2, 4, 128)],
                         ids=["mha", "gqa"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_paged_kernels_match_plain(cuda_device, kind, dtype, hkv, g, c):
    """Each int8 branch against its plain version run in f32 on the same
    codes and scales, held as the float branch is; the same check refuses
    the plain version with each slot's first page's scale doubled and
    with the codes read without their scales."""
    q, pages, planes, bt, lens, rows = _int8_case(cuda_device, kind, hkv, g,
                                                  c, dtype)
    kernel, plain = _int8_fns(kind)
    before = kernel.launches
    got = _int8_call(kind, kernel, q, pages, planes, bt, lens, rows)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + 1e-5

    def err_over_tol(planes_):
        ref32 = _int8_call(kind, plain, q.float(), pages, planes_, bt, lens,
                           [x.float() for x in rows])
        return ((got.float() - ref32).abs() / tol).flatten(1).amax(1)

    assert (err_over_tol(planes) <= 1.0).all()
    live = lens > 0
    doubled = [p.clone() for p in planes]
    for p in doubled:
        p[1, bt[live, 0].long()] *= 2.0
    for fault in (doubled, [torch.ones_like(p) for p in planes]):
        assert (err_over_tol(fault)[live] > 1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_int8_branch_is_the_float_branch_on_dequantized_pages(
        cuda_device, kind, dtype):
    """Dequantizing is exact, so the int8 branch equals, bit for bit, the
    float branch run on an f32 pool holding the dequantized pages with
    the bf16 self rows upcast."""
    q, pages, planes, bt, lens, rows = _int8_case(cuda_device, kind, 2, 4,
                                                  128, dtype)
    kernel, _ = _int8_fns(kind)
    got = _int8_call(kind, kernel, q, pages, planes, bt, lens, rows)
    dense = [x.float() * p[..., None, None] for x, p in zip(pages, planes)]
    ref = _int8_call(kind, kernel, q, dense, None, bt, lens,
                     [x.float() for x in rows])
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_engine_serves_int8_through_the_int8_kernels(cuda_device):
    """int8 weights and an int8 pool on the card: spec-off through the
    decode kernel's int8 branch (launches = n_layer x decode steps), the
    same streams at another window, and spec-on through the verify
    kernel's int8 branch (launches = n_layer x verify dispatches) with
    the spec-off streams (f32)."""
    cfg = ModelConfig(block_size=128, vocab_size=512, n_layer=2, n_head=2,
                      n_embd=128)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    motif = torch.randint(0, 512, (4,), generator=gen)
    prompts = [torch.randint(0, 512, (n,), generator=gen).numpy()
               for n in (5, 40, 17)] + [motif.repeat(10).numpy()]
    kw = dict(slots=3, page_size=16, device=cuda_device, quant="int8",
              kv_quant="int8")
    pa.paged_decode_attention.launches = 0
    eng = ServingEngine(model, window=4, **kw)
    assert eng.pool.k.dtype == torch.int8
    rids = [eng.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
    off = eng.run()
    assert pa.paged_decode_attention.launches == (
        cfg.n_layer * eng.window * eng.windows) > 0
    off = [off[r].tokens for r in rids]
    assert [x.tolist() for x in generate_served(model, prompts, 12, window=2,
                                                **kw)] == off
    pa.paged_verify_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    eng = ServingEngine(model, speculate=4, **kw)
    rids = [eng.submit(p, 12, seed=i) for i, p in enumerate(prompts)]
    done = eng.run()
    assert pa.paged_decode_attention.launches == 0
    assert pa.paged_verify_attention.launches == (
        cfg.n_layer * eng.verify_dispatches) > 0
    assert [done[r].tokens for r in rids] == off
    _pages_home(eng)


# -- fused QK-LayerNorm + RoPE + attention (forward and combined backward) --

FUSED_GEOMS = [(2, 256, 4, 4, 64), (2, 256, 4, 2, 128), (1, 128, 2, 1, 128)]
FUSED_IDS = ["mha64", "gqa128", "mqa128"]
# the combined backward's cap at each width (fused_attn.bwd_cap): the
# longest walks of its tile kernel, with the most dq groups
FUSED_CAP_GEOMS = [(1, 1024, 2, 2, 64), (1, 2048, 4, 2, 128)]
FUSED_CAP_IDS = ["mha64_t1024", "gqa128_t2048"]
# T % 128 == 64: the bf16 forward's last 128-row block has one q tile, its
# second warpgroup idles
FUSED_ODD_GEOMS = [(2, 192, 4, 4, 64), (1, 320, 4, 2, 128)]
FUSED_ODD_IDS = ["mha64_t192", "gqa128_t320"]


def _fused_inputs(dev, b, t, h, hkv, c, dtype, seed=0):
    from midgpt_tpu_torch.models.layers import rope_tables
    from midgpt_tpu_torch.ops.fused_attn import rope_full_tables

    gen = torch.Generator().manual_seed(seed)
    f = (h + 2 * hkv) * c
    qkv = torch.randn(b, t, f, generator=gen)
    wq = 1.0 + 0.1 * torch.randn(c, generator=gen)
    wk = 1.0 + 0.1 * torch.randn(c, generator=gen)
    dout = torch.randn(b, t, h * c, generator=gen)
    sin, cos = (torch.from_numpy(a) for a in rope_tables(c, t))
    sin, cos = rope_full_tables(sin, cos)
    return (qkv.to(dev, dtype), wq.to(dev), wk.to(dev), sin.to(dev),
            cos.to(dev), dout.to(dev, dtype))


def _fused_run(fa, args, h, hkv, kernel):
    """(out, lse, dqkv, dwq, dwk) through the kernels or the plain
    versions, on the same device."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", FUSED_GEOMS + FUSED_CAP_GEOMS + FUSED_ODD_GEOMS,
                         ids=FUSED_IDS + FUSED_CAP_IDS + FUSED_ODD_IDS)
def test_fused_attention_kernels_match_plain(cuda_device, dtype, geom):
    from midgpt_tpu_torch.ops import fused_attn as fa

    b, t, h, hkv, c = geom
    args = _fused_inputs(cuda_device, b, t, h, hkv, c, dtype)
    before = (fa.fused_attention_fwd.launches, fa.fused_attention_bwd.launches)
    got = _fused_run(fa, args, h, hkv, kernel=True)
    torch.cuda.synchronize()
    assert (fa.fused_attention_fwd.launches,
            fa.fused_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    plain = _fused_run(fa, args, h, hkv, kernel=False)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.isfinite(g).all()
    if dtype == torch.float32:
        # forward: two f32 sums in different orders; backward: three sums
        # over T and the LN backward's mean subtraction, hence 10x looser
        for i, (g, p) in enumerate(zip(got, plain)):
            rel = 1e-5 if i < 2 else 1e-4
            assert ((g - p).abs() <= 1e-5 + rel * p.abs()).all(), i
    else:
        # the kernels round inside (q, k, P, ds): each output may be at
        # most twice as far from the plain version run in f32 on the
        # upcast inputs as the plain bf16 version is
        args32 = [a.float() for a in args]
        ref = _fused_run(fa, args32, h, hkv, kernel=False)
        for i, (g, p, r) in enumerate(zip(got, plain, ref)):
            own = (p.float() - r).abs().max().item()
            assert (g.float() - r).abs().max().item() <= 2 * own, i


@pytest.mark.cuda
@pytest.mark.parametrize("geom", FUSED_GEOMS + FUSED_CAP_GEOMS + FUSED_ODD_GEOMS,
                         ids=FUSED_IDS + FUSED_CAP_IDS + FUSED_ODD_IDS)
def test_fused_attention_bf16_kernels_are_deterministic(cuda_device, geom):
    """The two-launch bf16 forward and the three-launch combined backward
    give the same bits on every call: dq partials per group summed in
    group order, LN-weight partials summed in a fixed order, no float
    atomics."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    b, t, h, hkv, c = geom
    args = _fused_inputs(cuda_device, b, t, h, hkv, c, torch.bfloat16)
    first = _fused_run(fa, args, h, hkv, kernel=True)
    again = _fused_run(fa, args, h, hkv, kernel=True)
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse", "dqkv", "dwq", "dwk"), first, again):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fused_forward_counts_one_forward_and_no_backward_prepass(
        cuda_device, dtype):
    """The forward route (bf16: its own pre-pass into q^ and k^ and the
    forward core, one C call) reads one forward launch on the counters,
    and no backward pre-pass or other backward launch."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    fns = (fa.fused_attention_fwd, fa.fused_attention_bwd_prep,
           fa.fused_attention_bwd, fa.fused_attention_bwd_dq,
           fa.fused_attention_bwd_dkv)
    qkv, wq, wk, sin, cos, _ = _fused_inputs(cuda_device, 2, 256, 4, 4, 64,
                                             dtype)
    before = [f.launches for f in fns]
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, 4, 4)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 0, 0, 0, 0]
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


@pytest.mark.cuda
def test_fused_attention_kernels_refuse_what_they_cannot_take(cuda_device):
    from midgpt_tpu_torch.ops import fused_attn as fa

    qkv, wq, wk, sin, cos, _ = _fused_inputs(cuda_device, 1, 128, 2, 2, 64,
                                             torch.float32)
    before = (fa.fused_attention_fwd.launches, fa.fused_attention_bwd.launches)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fa.fused_attention_fwd(qkv.half(), wq, wk, sin, cos, 2, 2)
    with pytest.raises(ValueError, match="C in"):
        fa.fused_attention_fwd(qkv[..., :192].contiguous(), wq[:32],
                               wk[:32], sin[:, :32].contiguous(),
                               cos[:, :32].contiguous(), 2, 2)
    with pytest.raises(ValueError, match="multiple"):
        fa.fused_attention_fwd(qkv[:, :96].contiguous(), wq, wk, sin[:96],
                               cos[:96], 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_fwd(torch.cat([qkv, qkv], 1)[:, ::2], wq, wk,
                               sin, cos, 2, 2)
    lse = torch.zeros(1, 2, 128, device=cuda_device)
    dout = torch.zeros(1, 128, 128, device=cuda_device)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, lse[:, :1], lse,
                                  dout, 2, 2)
    with pytest.raises(ValueError, match="dout"):
        fa.fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, lse, lse,
                                   dout.bfloat16(), 2, 2)
    with pytest.raises(ValueError, match="contiguous rows"):
        fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, lse, lse, dout, 2,
                                  2, out=dout.transpose(0, 1))
    assert (fa.fused_attention_fwd.launches,
            fa.fused_attention_bwd.launches) == before


@pytest.mark.cuda
def test_train_step_runs_through_the_fused_kernels(cuda_device):
    """One optimizer step (2 microbatches, f32 compute) on the card with
    attn_impl "auto" launches each kernel once per layer and microbatch,
    and gives the CPU plain path's loss within 1e-5 relative."""
    from midgpt_tpu_torch.config import ExperimentConfig
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.train import (
        init_state, make_lr_schedule, make_shadow, train_step)

    cfg = ExperimentConfig(
        model=ModelConfig(block_size=128, vocab_size=512, n_layer=2,
                          n_head=2, n_embd=128, remat="none"),
        batch_size=4, g_accum_iters=2, warmup_steps=0, compute_dtype="float32")
    toks = torch.randint(0, 512, (2, 2, 129),
                         generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = init_state(cfg, dev)
        shadow = make_shadow(state.model, torch.float32)
        x, y = toks[..., :-1].to(dev), toks[..., 1:].to(dev)
        before = (fa.fused_attention_fwd.launches,
                  fa.fused_attention_bwd.launches)
        loss, _ = train_step(state, shadow, x, y, cfg,
                             make_lr_schedule(cfg)(0))
        losses[dev.type] = loss.item()
        after = (fa.fused_attention_fwd.launches,
                 fa.fused_attention_bwd.launches)
        n = cfg.model.n_layer * cfg.g_accum_iters if dev.type == "cuda" else 0
        assert after == (before[0] + n, before[1] + n)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])


# -- flash attention (forward, dq, dk/dv) with counter-hash dropout ---------

FLASH_GEOMS = [(2, 256, 4, 4, 64), (2, 256, 4, 2, 64), (1, 128, 2, 2, 128)]
FLASH_IDS = ["mha64", "gqa64", "mha128"]
# the bf16 forward's edges: a block of two 64-row warpgroups whose second
# one idles (T = 64, 192) and a single k tile (T = 64)
FLASH_EDGE_GEOMS = [(2, 64, 4, 4, 64), (2, 192, 4, 4, 64), (2, 64, 4, 2, 64),
                    (2, 192, 4, 2, 64)]
FLASH_EDGE_IDS = ["mha64_t64", "mha64_t192", "gqa64_t64", "gqa64_t192"]
FLASH_OUTS = ("out", "lse", "dq", "dk", "dv")


def _flash_inputs(dev, b, t, h, hkv, c, dtype, seed=0, layout="contiguous"):
    """q, k, v, dout ``[B, H|Hkv, T, C]``. ``layout="model"`` gives the
    strided views the model passes: q, k and dout ``[B, T, H, C]``
    transposed, v a transposed view into a packed ``[B, T, (H + 2 Hkv)
    C]`` projection."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        q = torch.randn(b, h, t, c, generator=gen)
        k = torch.randn(b, hkv, t, c, generator=gen)
        v = torch.randn(b, hkv, t, c, generator=gen)
        dout = torch.randn(b, h, t, c, generator=gen)
        return [a.to(dev, dtype) for a in (q, k, v, dout)]
    q, k, dout = (torch.randn(b, t, n, c, generator=gen).to(dev, dtype)
                  .transpose(1, 2) for n in (h, hkv, h))
    qkv = torch.randn(b, t, (h + 2 * hkv) * c, generator=gen).to(dev, dtype)
    v = qkv[..., (h + hkv) * c:].reshape(b, t, hkv, c).transpose(1, 2)
    return [q, k, v, dout]


def _flash_run(fl, args, drop, kernel, causal=True):
    """(out, lse, dq, dk, dv) of the kernels or the plain versions; both
    backward passes read the plain forward's lse and delta, so each
    kernel sees the same inputs as its plain version."""
    q, k, v, dout = args
    out, lse = fl.flash_forward_reference(q, k, v, causal, drop)
    delta = (dout.float() * out.float()).sum(-1)
    if kernel:
        got = fl.flash_fwd(q, k, v, causal, drop)
        dq = fl.flash_bwd_dq(q, k, v, dout, lse, delta, causal, drop)
        dk, dv = fl.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, drop)
        return (*got, dq, dk, dv)
    dq = fl.flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                        drop)
    dk, dv = fl.flash_backward_dkv_reference(q, k, v, dout, lse, delta,
                                             causal, drop)
    return out, lse, dq, dk, dv


def _flash_err_over_limit(got, plain, ref32):
    """Per output, its distance from the plain version over the limit."""
    out = []
    for i, (g, p) in enumerate(zip(got, plain)):
        if ref32 is None or FLASH_OUTS[i] == "lse":
            rel = 1e-5 if i < 2 else 1e-4
            r = p.float() if ref32 is None else ref32[i]
            out.append(((g.float() - r).abs() / (1e-5 + rel * r.abs()))
                       .max().item())
        else:
            own = (p.float() - ref32[i]).abs().max().item()
            out.append((g.float() - ref32[i]).abs().max().item() / (2 * own))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", FLASH_GEOMS + FLASH_EDGE_GEOMS,
                         ids=FLASH_IDS + FLASH_EDGE_IDS)
def test_flash_kernels_match_plain(cuda_device, dtype, geom, rate):
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    args = _flash_inputs(cuda_device, b, t, h, hkv, c, dtype)
    drop = fl.Dropout(rate, -12345, row_off=64, bh_off=3) if rate else None
    counts = (fl.flash_fwd.launches, fl.flash_bwd_dq.launches,
              fl.flash_bwd_dkv.launches)
    got = _flash_run(fl, args, drop, kernel=True)
    torch.cuda.synchronize()
    assert (fl.flash_fwd.launches, fl.flash_bwd_dq.launches,
            fl.flash_bwd_dkv.launches) == tuple(n + 1 for n in counts)
    plain = _flash_run(fl, args, drop, kernel=False)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.isfinite(g).all()
    ref32 = None
    if dtype == torch.bfloat16:
        ref32 = [a.float() for a in _flash_run(fl, [a.float() for a in args],
                                                drop, kernel=False)]
    assert max(_flash_err_over_limit(got, plain, ref32)) <= 1.0
    # the same rule refuses a fault: another seed's mask, or k and v one
    # row off (lse does not depend on the mask)
    if drop is not None:
        fault_drop = drop._replace(seed=drop.seed + 1)
        fault_args = args
        checked = ["out", "dq", "dk", "dv"]
    else:
        fault_drop = None
        fault_args = [args[0], *(torch.roll(a, 1, 2) for a in args[1:3]),
                      args[3]]
        checked = list(FLASH_OUTS)
    fplain = _flash_run(fl, fault_args, fault_drop, kernel=False)
    fref = None if ref32 is None else [
        a.float() for a in _flash_run(fl, [a.float() for a in fault_args],
                                      fault_drop, kernel=False)]
    faulted = dict(zip(FLASH_OUTS, _flash_err_over_limit(got, fplain, fref)))
    assert all(faulted[n] > 1.0 for n in checked), faulted


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("geom", FLASH_GEOMS + FLASH_EDGE_GEOMS,
                         ids=FLASH_IDS + FLASH_EDGE_IDS)
def test_flash_bf16_forward_is_deterministic(cuda_device, geom, rate):
    """The bf16 forward gives the same out and lse bits on every call."""
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    q, k, v, _ = _flash_inputs(cuda_device, b, t, h, hkv, c, torch.bfloat16)
    drop = fl.Dropout(rate, -12345, row_off=64, bh_off=3) if rate else None
    first = fl.flash_fwd(q, k, v, True, drop)
    again = fl.flash_fwd(q, k, v, True, drop)
    torch.cuda.synchronize()
    for name, x, y in zip(("out", "lse"), first, again):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", FLASH_GEOMS + FLASH_EDGE_GEOMS,
                         ids=FLASH_IDS + FLASH_EDGE_IDS)
def test_flash_kernels_match_plain_non_causal(cuda_device, dtype, geom, rate):
    """``causal=False`` (a ring hop's off-diagonal tile: every column
    visible, the dropout mask at global row and column anchors): each
    kernel held to its plain version as in test_flash_kernels_match_plain;
    the bf16 dk/dv kernel then walks one k tile a block over every q
    tile. The same rule refuses the causal plain version."""
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    args = _flash_inputs(cuda_device, b, t, h, hkv, c, dtype, seed=1)
    drop = (fl.Dropout(rate, -12345, row_off=t, col_off=64, bh_off=3)
            if rate else None)
    got = _flash_run(fl, args, drop, kernel=True, causal=False)
    torch.cuda.synchronize()
    plain = _flash_run(fl, args, drop, kernel=False, causal=False)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.isfinite(g).all()
    ref32 = None
    if dtype == torch.bfloat16:
        ref32 = [a.float() for a in _flash_run(
            fl, [a.float() for a in args], drop, kernel=False, causal=False)]
    assert max(_flash_err_over_limit(got, plain, ref32)) <= 1.0
    fplain = _flash_run(fl, args, drop, kernel=False, causal=True)
    fref = None if ref32 is None else [
        a.float() for a in _flash_run(fl, [a.float() for a in args], drop,
                                      kernel=False, causal=True)]
    faulted = dict(zip(FLASH_OUTS, _flash_err_over_limit(got, fplain, fref)))
    assert all(v > 1.0 for v in faulted.values()), faulted


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("geom", FLASH_GEOMS + FLASH_EDGE_GEOMS,
                         ids=FLASH_IDS + FLASH_EDGE_IDS)
def test_flash_bf16_dkv_is_deterministic(cuda_device, geom, rate, causal):
    """The bf16 dk/dv kernel gives the same dk and dv bits on every call:
    each block owns its k tiles' rows, no atomics."""
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    q, k, v, dout = _flash_inputs(cuda_device, b, t, h, hkv, c,
                                  torch.bfloat16, seed=2)
    drop = fl.Dropout(rate, -12345, row_off=64, bh_off=3) if rate else None
    out, lse = fl.flash_forward_reference(q, k, v, causal, drop)
    delta = (dout.float() * out.float()).sum(-1)
    first = fl.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, drop)
    again = fl.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, drop)
    torch.cuda.synchronize()
    for name, x, y in zip(("dk", "dv"), first, again):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("geom", FLASH_GEOMS + FLASH_EDGE_GEOMS,
                         ids=FLASH_IDS + FLASH_EDGE_IDS)
def test_flash_bf16_dq_is_deterministic(cuda_device, geom, rate, causal):
    """The bf16 dq kernel gives the same bits on every call, given delta
    and forming it (dq and the delta it writes); given the delta it
    wrote, it gives the dq it gave forming it."""
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    q, k, v, dout = _flash_inputs(cuda_device, b, t, h, hkv, c,
                                  torch.bfloat16, seed=4)
    drop = fl.Dropout(rate, -12345, row_off=64, bh_off=3) if rate else None
    out, lse = fl.flash_forward_reference(q, k, v, causal, drop)
    delta = fl.delta_reference(dout, out)
    first, again = (fl.flash_bwd_dq(q, k, v, dout, lse, delta, causal, drop)
                    for _ in range(2))
    formed = [fl.flash_bwd_dq_delta(q, k, v, dout, lse, out, None, causal,
                                    drop) for _ in range(2)]
    given = fl.flash_bwd_dq(q, k, v, dout, lse, formed[0][1], causal, drop)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(formed[0][0], formed[1][0])
    assert torch.equal(formed[0][1], formed[1][1])
    assert torch.equal(given, formed[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dlse", [False, True], ids=["no_dlse", "dlse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", FLASH_GEOMS, ids=FLASH_IDS)
def test_flash_dq_kernel_forms_delta(cuda_device, dtype, dlse, causal, geom):
    """The delta the dq kernel forms from O, dO and dlse against the plain
    delta, in f32 within 1e-5 + 1e-5 |plain|; its dq held to the plain dq
    on the plain delta as in test_flash_kernels_match_plain; one launch,
    counted on flash_bwd_dq."""
    from midgpt_tpu_torch.ops import flash as fl

    b, t, h, hkv, c = geom
    q, k, v, dout = _flash_inputs(cuda_device, b, t, h, hkv, c, dtype, seed=5)
    drop = fl.Dropout(0.2, -12345, row_off=64, bh_off=3)
    out, lse = fl.flash_forward_reference(q, k, v, causal, drop)
    wl = (torch.randn(b, h, t, generator=torch.Generator().manual_seed(6))
          .to(cuda_device) if dlse else None)
    before = fl.flash_bwd_dq.launches
    dq, delta = fl.flash_bwd_dq_delta(q, k, v, dout, lse, out, wl, causal,
                                      drop)
    torch.cuda.synchronize()
    assert fl.flash_bwd_dq.launches == before + 1
    ref = fl.delta_reference(dout, out, wl)
    assert delta.dtype == torch.float32 and delta.shape == ref.shape
    assert ((delta - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()
    plain = fl.flash_backward_dq_reference(q, k, v, dout, lse, ref, causal,
                                           drop)
    if dtype == torch.float32:
        assert ((dq - plain).abs() <= 1e-5 + 1e-4 * plain.abs()).all()
    else:
        ref32 = fl.flash_backward_dq_reference(
            *(a.float() for a in (q, k, v, dout)), lse, ref, causal, drop)
        own = (plain.float() - ref32).abs().max()
        assert (dq.float() - ref32).abs().max() <= 2 * own


@pytest.mark.cuda
def test_flash_kernels_match_plain_on_the_models_views(cuda_device):
    """bf16 with dropout, on the strided views the model passes (read in
    place by the kernels) and on their contiguous copies: both held by
    the triangle rule, and the two agree bit for bit."""
    from midgpt_tpu_torch.ops import flash as fl

    args = _flash_inputs(cuda_device, 8, 256, 6, 6, 64, torch.bfloat16,
                         seed=3, layout="model")
    assert not args[2].is_contiguous()
    drop = fl.Dropout(0.2, -12345)
    got = _flash_run(fl, args, drop, kernel=True)
    plain = _flash_run(fl, args, drop, kernel=False)
    ref32 = [a.float() for a in _flash_run(fl, [a.float() for a in args],
                                            drop, kernel=False)]
    assert max(_flash_err_over_limit(got, plain, ref32)) <= 1.0
    dense = _flash_run(fl, [a.contiguous() for a in args], drop, kernel=True)
    for g, d in zip(got, dense):
        assert torch.equal(g, d)


@pytest.mark.cuda
def test_auto_on_the_card_launches_flash_or_raises(cuda_device):
    """``attn_impl="auto"`` on a CUDA tensor whose shape the fused kernels
    refuse (T % 128 != 0) takes the flash kernels: where they tile (T %
    64 == 0) and where they do not (T = 96 and 250, padded to the tile by
    the dispatch, and then within 1e-4 of the largest logit of the naive
    path in f32); it raises for a head size they do not take (C = 32).
    It never runs the naive path."""
    from midgpt_tpu_torch.ops import flash as fl

    cfg = ModelConfig(block_size=256, vocab_size=64, n_layer=2, n_head=2,
                      n_embd=128, remat="none", attn_impl="auto")
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device)
    naive = GPT.init(dataclasses.replace(cfg, attn_impl="naive"),
                     torch.Generator().manual_seed(0), device=cuda_device)
    tok = torch.randint(0, 64, (2, 256), device=cuda_device)
    for t in (192, 96, 250):
        before = fl.flash_fwd.launches
        with torch.no_grad():
            out = model(tok[:, :t])
            ref = naive(tok[:, :t])
        assert fl.flash_fwd.launches == before + cfg.n_layer
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (t, err)
    narrow = GPT.init(dataclasses.replace(cfg, n_head=4),
                      torch.Generator().manual_seed(0), device=cuda_device)
    before = fl.flash_fwd.launches
    with pytest.raises(ValueError, match="C in"), torch.no_grad():
        narrow(tok[:, :96])
    assert fl.flash_fwd.launches == before


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_cannot_take(cuda_device):
    from midgpt_tpu_torch.ops import flash as fl

    q, k, v, _ = _flash_inputs(cuda_device, 1, 128, 2, 2, 64, torch.float32)
    before = fl.flash_fwd.launches
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fl.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="C in"):
        fl.flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="multiple"):
        fl.flash_fwd(q[:, :, :96], k[:, :, :96], v[:, :, :96])
    with pytest.raises(ValueError, match="divisible"):
        fl.flash_fwd(q[:, :1].expand(1, 3, 128, 64), k, v)
    assert fl.flash_fwd.launches == before
    # strided views are read in place or copied, never refused
    qt = torch.randn(1, 128, 2, 64, device=cuda_device).transpose(1, 2)
    out, _ = fl.flash_fwd(qt, k, v)
    ref, _ = fl.flash_forward_reference(qt, k, v)
    assert ((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()


@pytest.mark.cuda
def test_train_step_runs_through_the_flash_kernels(cuda_device):
    """f32, attn_impl "flash", no dropout: the card's loss within 1e-5
    relative of the CPU plain path's, one launch of each kernel per layer
    and microbatch. With dropout 0.2 and remat "full" under "auto": the
    forward launches twice per layer and microbatch (the recompute), the
    backward kernels once, and the fused kernels not at all."""
    from midgpt_tpu_torch.config import ExperimentConfig
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.train import (
        init_state, make_lr_schedule, make_shadow, train_step)

    def counts():
        return (fl.flash_fwd.launches, fl.flash_bwd_dq.launches,
                fl.flash_bwd_dkv.launches, fa.fused_attention_fwd.launches)

    model = ModelConfig(block_size=128, vocab_size=65, n_layer=2, n_head=2,
                        n_embd=128, remat="none", attn_impl="flash")
    cfg = ExperimentConfig(model=model, batch_size=4, g_accum_iters=2,
                           warmup_steps=0, compute_dtype="float32")
    toks = torch.randint(0, 65, (2, 2, 129),
                         generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        state = init_state(cfg, dev)
        shadow = make_shadow(state.model, torch.float32)
        x, y = toks[..., :-1].to(dev), toks[..., 1:].to(dev)
        before = counts()
        loss, _ = train_step(state, shadow, x, y, cfg,
                             make_lr_schedule(cfg)(0))
        losses[dev.type] = loss.item()
        n = model.n_layer * cfg.g_accum_iters if dev.type == "cuda" else 0
        assert counts() == (before[0] + n, before[1] + n, before[2] + n,
                            before[3])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])

    drop = dataclasses.replace(cfg, compute_dtype="bfloat16",
                               model=dataclasses.replace(
                                   model, dropout=0.2, remat="full",
                                   attn_impl="auto"))
    state = init_state(drop, cuda_device)
    shadow = make_shadow(state.model, torch.bfloat16)
    x, y = toks[..., :-1].to(cuda_device), toks[..., 1:].to(cuda_device)
    before = counts()
    loss, _ = train_step(state, shadow, x, y, drop, 1e-3, step_key=fold_in(0, 1))
    n = model.n_layer * cfg.g_accum_iters
    assert counts() == (before[0] + 2 * n, before[1] + n, before[2] + n,
                        before[3])
    assert torch.isfinite(loss)


# -- the split fused backward (T above the combined cap) and fused RMSNorm --

SPLIT_GEOMS = [(2, 512, 4, 4, 64), (1, 512, 4, 2, 128), (1, 256, 2, 1, 128)]


def _split_run(fa, args, h, hkv, kernel):
    """(dq, dwq, dk_h, dv_h, dwk) through the split kernels or their plain
    versions, both from the plain forward's lse and delta."""
    qkv, wq, wk, sin, cos, dout = args
    out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                    hkv)
    delta = fa.attention_delta(out, dout, h)
    tail = (lse, delta, dout, h, hkv)
    if kernel:
        return (*fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail),
                *fa.fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, *tail))
    return (*fa.fused_attention_bwd_dq_reference(qkv, wq, wk, sin, cos, *tail),
            *fa.fused_attention_bwd_dkv_reference(qkv, wq, wk, sin, cos,
                                                  *tail))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=["mha64", "gqa128", "mqa128"])
def test_split_attention_kernels_match_plain(cuda_device, dtype, geom):
    from midgpt_tpu_torch.ops import fused_attn as fa

    b, t, h, hkv, c = geom
    args = _fused_inputs(cuda_device, b, t, h, hkv, c, dtype)
    before = (fa.fused_attention_bwd_dq.launches,
              fa.fused_attention_bwd_dkv.launches)
    got = _split_run(fa, args, h, hkv, kernel=True)
    torch.cuda.synchronize()
    assert (fa.fused_attention_bwd_dq.launches,
            fa.fused_attention_bwd_dkv.launches) == (before[0] + 1,
                                                     before[1] + 1)
    plain = _split_run(fa, args, h, hkv, kernel=False)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.isfinite(g).all()
    if dtype == torch.float32:
        for i, (g, p) in enumerate(zip(got, plain)):
            assert ((g - p).abs() <= 1e-5 + 1e-4 * p.abs()).all(), i
    else:
        ref = _split_run(fa, [a.float() for a in args], h, hkv, kernel=False)
        for i, (g, p, r) in enumerate(zip(got, plain, ref)):
            own = (p.float() - r).abs().max().item()
            assert (g.float() - r).abs().max().item() <= 2 * own, i


SPLIT_LONG_GEOMS = [(1, 2048, 4, 4, 64), (1, 2048, 4, 2, 128)]
SPLIT_ODD_GEOMS = [(1, 320, 4, 4, 64), (2, 192, 4, 2, 128), (1, 64, 2, 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SPLIT_LONG_GEOMS, ids=["mha64", "gqa128"])
def test_split_bf16_kernels_are_deterministic(cuda_device, geom):
    """The bf16 pre-pass, dq and dk/dv kernels at T=2048 give the same
    bits on every call: every sum runs in a fixed order, no atomics."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    b, t, h, hkv, c = geom
    args = _fused_inputs(cuda_device, b, t, h, hkv, c, torch.bfloat16)
    first = _split_run(fa, args, h, hkv, kernel=True)
    again = _split_run(fa, args, h, hkv, kernel=True)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dwq", "dk_h", "dv_h", "dwk"), first, again):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("geom", SPLIT_ODD_GEOMS,
                         ids=["mha64_t320", "gqa128_t192", "mqa128_t64"])
def test_split_bf16_kernels_match_plain_at_odd_tile_counts(cuda_device,
                                                           geom):
    """T % 128 == 64: the wrappers called directly, held by the triangle
    rule as test_split_attention_kernels_match_plain holds them; given the
    pre-pass's q^ and k^ they give the same bits as without."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    b, t, h, hkv, c = geom
    args = _fused_inputs(cuda_device, b, t, h, hkv, c, torch.bfloat16)
    got = _split_run(fa, args, h, hkv, kernel=True)
    qkv, wq, wk, sin, cos, dout = args
    qhat, khat, _ = fa.fused_attention_bwd_prep(qkv, wq, wk, sin, cos, h,
                                                hkv)
    out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                    hkv)
    tail = (lse, fa.attention_delta(out, dout, h), dout, h, hkv)
    given = (*fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail,
                                        qhat=qhat, khat=khat),
             *fa.fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, *tail,
                                         qhat=qhat, khat=khat))
    torch.cuda.synchronize()
    plain = _split_run(fa, args, h, hkv, kernel=False)
    ref = _split_run(fa, [a.float() for a in args], h, hkv, kernel=False)
    for i, (g, p, r, gv) in enumerate(zip(got, plain, ref, given)):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.isfinite(g).all()
        assert torch.equal(g, gv), i
        own = (p.float() - r).abs().max().item()
        assert (g.float() - r).abs().max().item() <= 2 * own, i


@pytest.mark.cuda
def test_split_route_launches_the_prepass_once(cuda_device):
    """The bf16 split route: one pre-pass launch (q^, k^ and delta), one
    dq and one dk/dv launch, no combined backward; finite gradients."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    h = hkv = 2
    qkv, wq, wk, sin, cos, dout = _fused_inputs(cuda_device, 1, 2048, h, hkv,
                                                64, torch.bfloat16)
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    fns = (fa.fused_attention_bwd_prep, fa.fused_attention_bwd_dq,
           fa.fused_attention_bwd_dkv, fa.fused_attention_bwd)
    before = [f.launches for f in fns]
    grads = fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out, lse,
                                         dout, h, hkv)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [1, 1, 1, 0]
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_route_through_fused_attention_qkv(cuda_device, dtype):
    """T=2048 at C=64 is above the combined cap (1024): the forward, the
    dq and the dk/dv kernel run once each, the combined backward never,
    and the gradients are the split plain versions' (held as above)."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    h = hkv = 2
    args = _fused_inputs(cuda_device, 1, 2048, h, hkv, 64, dtype)
    qkv, wq, wk, sin, cos, dout = args
    assert fa.takes_split(2048, 64)

    def counts():
        return (fa.fused_attention_fwd.launches,
                fa.fused_attention_bwd.launches,
                fa.fused_attention_bwd_dq.launches,
                fa.fused_attention_bwd_dkv.launches)

    before = counts()
    leaves = [a.detach().requires_grad_() for a in (qkv, wq, wk)]
    out = fa.fused_attention_qkv(*leaves, sin, cos, h, hkv)
    out.backward(dout)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1], before[2] + 1,
                        before[3] + 1)

    def plain_grads(a):  # MHA: dk_h, dv_h are dk, dv
        dq, dwq, dk, dv, dwk = _split_run(fa, a, h, hkv, kernel=False)
        return torch.cat([dq, dk, dv], -1), dwq, dwk

    plain = plain_grads(args)
    ref = plain_grads([a.float() for a in args])
    for g, p, r in zip((a.grad for a in leaves), plain, ref):
        assert g.shape == p.shape and torch.isfinite(g).all()
        if dtype == torch.float32:
            assert ((g - p).abs() <= 1e-5 + 1e-4 * p.abs()).all()
        else:
            own = (p.float() - r).abs().max().item()
            assert (g.float() - r).abs().max().item() <= 2 * own


def _norm_inputs(dev, n, d, dtype, use_weight, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=gen)
    w = 1.0 + 0.2 * torch.randn(d, generator=gen)
    dy = torch.randn(n, d, generator=gen)
    return (x.to(dev, dtype), w.to(dev) if use_weight else None,
            dy.to(dev, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("use_weight", [False, True], ids=["no_w", "w"])
@pytest.mark.parametrize("n,d,eps", [(1000, 768, 1e-6), (37, 128, 1e-5),
                                     (4096, 4096, 1e-6)])
def test_fused_norm_kernels_match_plain(cuda_device, dtype, use_weight, n, d,
                                        eps):
    """y and dx element by element within 1e-5 plus half a bf16 ulp of the
    output against the plain versions in f32 on the upcast inputs; rstd
    within 1e-5 relative; the same check refuses the plain output with its
    rows shifted by one."""
    from midgpt_tpu_torch.ops import fused_norm as fn

    x, w, dy = _norm_inputs(cuda_device, n, d, dtype, use_weight)
    before = (fn.fused_rms_norm_fwd.launches, fn.fused_rms_norm_bwd.launches)
    y, rstd = fn.fused_rms_norm_fwd(x, w, eps)
    dx = fn.fused_rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert (fn.fused_rms_norm_fwd.launches,
            fn.fused_rms_norm_bwd.launches) == (before[0] + 1, before[1] + 1)
    y32, r32 = fn.fused_rms_norm_forward_reference(x.float(), w, eps)
    dx32 = fn.fused_rms_norm_backward_reference(x.float(), w, r32, dy.float())
    rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    for got, ref in ((y, y32), (dx, dx32)):
        assert got.dtype == dtype and got.shape == ref.shape
        tol = 1e-5 + rel * got.float().abs()
        assert ((got.float() - ref).abs() <= tol).all()
    assert ((rstd - r32).abs() <= 1e-5 * r32).all()
    shifted = torch.roll(y32, 1, 0)
    assert not ((y.float() - shifted).abs() <= 1e-5 + rel * y.float().abs()
                ).all()


@pytest.mark.cuda
def test_fused_norm_kernels_refuse_what_they_cannot_take(cuda_device):
    from midgpt_tpu_torch.ops import fused_norm as fn

    x, w, dy = _norm_inputs(cuda_device, 8, 256, torch.float32, True)
    before = (fn.fused_rms_norm_fwd.launches, fn.fused_rms_norm_bwd.launches)
    with pytest.raises(ValueError, match="D % 128"):
        fn.fused_rms_norm_fwd(x[:, :192].contiguous(), None, 1e-6)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        fn.fused_rms_norm_fwd(x.half(), None, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        fn.fused_rms_norm_fwd(x.t().contiguous().t(), None, 1e-6)
    with pytest.raises(ValueError, match="weight"):
        fn.fused_rms_norm_fwd(x, w[:128], 1e-6)
    with pytest.raises(ValueError, match="rstd"):
        fn.fused_rms_norm_bwd(x, w, torch.ones(7, device=cuda_device), dy)
    assert (fn.fused_rms_norm_fwd.launches,
            fn.fused_rms_norm_bwd.launches) == before


@pytest.mark.cuda
def test_model_with_fused_norm_launches_the_norm_kernels(cuda_device):
    """A GPT with norm_impl "fused" (2 layers, width 128): one forward
    launches the norm kernel 2 n_layer + 1 times, a backward the backward
    kernel as often; the logits equal the plain norms' within 1e-5 of the
    largest (f32)."""
    from midgpt_tpu_torch.ops import fused_norm as fn

    kw = dict(block_size=128, vocab_size=256, n_layer=2, n_head=2,
              n_embd=128, remat="none")
    fused = GPT.init(ModelConfig(**kw, norm_impl="fused"),
                     torch.Generator().manual_seed(0), device=cuda_device)
    plain = GPT.init(ModelConfig(**kw), torch.Generator().manual_seed(0),
                     device=cuda_device)
    tok = torch.randint(0, 256, (2, 128),
                        generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    before = (fn.fused_rms_norm_fwd.launches, fn.fused_rms_norm_bwd.launches)
    out = fused(tok)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    n = 2 * kw["n_layer"] + 1
    assert (fn.fused_rms_norm_fwd.launches,
            fn.fused_rms_norm_bwd.launches) == (before[0] + n, before[1] + n)
    with torch.no_grad():
        ref = plain(tok)
    assert (out.detach() - ref).abs().max() <= 1e-5 * ref.abs().max()


# -- the int8 weight product (csrc/int8_matmul.cu) --------------------------

# every instance of the kernel's plan: the GEMV at mt 1 .. 6 (M <= 48) and
# the wgmma one (M > 48), with and without K splits, blocks looping over
# tiles (the heads), ragged edges; the instances' boundary (M = 48, 49),
# N below a tile and N % 16 != 0 at both, K = 8 at both, and a K that no
# split divides evenly at both
MM_SHAPES = [(8, 768, 2304), (40, 768, 768), (512, 3072, 768),
             (8, 768, 50304), (1, 64, 65), (33, 136, 200), (16, 768, 2304),
             (32, 768, 768), (32, 3072, 768), (64, 768, 3072),
             (512, 768, 2304), (100, 136, 200), (1024, 768, 50304),
             (48, 768, 2304), (49, 768, 768), (40, 768, 50304),
             (40, 136, 40), (64, 768, 40), (8, 8, 2304), (512, 8, 768),
             (8, 3080, 768), (512, 3144, 768)]
MM_IDS = ["decode_wqkv", "verify_wo", "prefill_wdown", "decode_head",
          "one_row_ragged", "odd", "prefill16_wqkv", "prefill32_wo",
          "prefill32_wdown", "prefill64_wup", "prefill_wqkv", "odd_wgmma",
          "prefill1024_head", "gemv48_wqkv", "wgmma49_wo", "verify_head",
          "gemv_narrow_ragged", "wgmma_narrow_ragged", "gemv_k8",
          "wgmma_k8", "gemv_uneven_splits", "wgmma_uneven_splits"]


def _int8_operands(dev, m, k, n, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    codes = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    codes[0, 0], codes[-1, -1] = -127, 127
    exps = torch.randint(-14, -4, (n,), generator=gen)
    exps[0], exps[-1] = -30, 6
    x = torch.randn(m, k, generator=gen)
    return (x.to(dev, dtype), codes.to(dev),
            torch.pow(2.0, exps.float()).to(dev))


def _int8_err_over_tol(got, x, codes, scale):
    ref32 = (x.float() @ codes.float()) * scale
    size = (x.float().abs() @ codes.float().abs()) * scale
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + 2.0 ** -14 * size + 1e-37
    return ((got.float() - ref32).abs() / tol).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", MM_SHAPES, ids=MM_IDS)
def test_int8_matmul_kernel_matches_plain(cuda_device, dtype, m, k, n):
    from midgpt_tpu_torch.ops import int8_matmul as im

    torch.backends.cuda.matmul.allow_tf32 = False
    x, codes, scale = _int8_operands(cuda_device, m, k, n, dtype)
    before = im.int8_matmul.launches
    got = im.int8_matmul(x[None], codes, scale)[0]  # leading dims go along
    again = im.int8_matmul(x, codes, scale)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 2
    assert got.shape == (m, n) and got.dtype == dtype
    assert torch.equal(got, again)  # the split sums in a fixed order
    assert _int8_err_over_tol(got, x, codes, scale) <= 1.0
    # the rule refuses a doubled scale and a dropped row of codes
    doubled = scale * torch.where(torch.arange(n, device=cuda_device) == 0,
                                  2.0, 1.0)
    assert _int8_err_over_tol(got, x, codes, doubled) > 1.0
    assert _int8_err_over_tol(got, x[:, 1:], codes[1:], scale) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 16, 24, 32, 40, 48, 49, 64, 512])
def test_int8_matmul_kernel_rounds_as_plain_under_absmax_scales(
        cuda_device, dtype, m):
    """Integer x makes every sum exact in f32 whatever its order, so the
    kernel must equal the plain version bit for bit, also with scales
    that are no powers of two (``quantize_model(mode="absmax")``'s): the
    sum rounded to x's dtype, then times the scale."""
    from midgpt_tpu_torch.ops import int8_matmul as im
    from midgpt_tpu_torch.quant import quantize_per_channel

    mmb = torch.backends.cuda.matmul
    saved = (mmb.allow_tf32, mmb.allow_bf16_reduced_precision_reduction)
    mmb.allow_tf32 = mmb.allow_bf16_reduced_precision_reduction = False
    try:
        gen = torch.Generator().manual_seed(m)
        w = torch.randn(768, 2304, generator=gen)
        codes, scale = quantize_per_channel(w, mode="absmax")
        assert not torch.equal(torch.exp2(torch.log2(scale).round()), scale)
        x = torch.randint(-4, 5, (m, 768), generator=gen).to(cuda_device,
                                                             dtype)
        codes, scale = codes.to(cuda_device), scale.to(cuda_device)
        got = im.int8_matmul(x, codes, scale)
        assert torch.equal(got, im.int8_matmul_reference(x, codes, scale))
    finally:
        mmb.allow_tf32, mmb.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.cuda
def test_int8_matmul_kernel_refuses_what_it_cannot_take(cuda_device):
    from midgpt_tpu_torch.ops import int8_matmul as im

    x, codes, scale = _int8_operands(cuda_device, 8, 64, 96, torch.bfloat16)
    for args in ((x.half(), codes, scale),  # no fp16 path
                 (x[:, :60], codes[:60], scale),  # K % 8 != 0
                 (x, codes.float(), scale),  # codes not int8
                 (x, codes, scale[:-1]),  # scale of another width
                 (x, codes.cpu(), scale),  # another device
                 (x, codes.t().contiguous().t(), scale)):  # not contiguous
        with pytest.raises(ValueError):
            im.int8_matmul(*args)


@pytest.mark.cuda
def test_quant_linear_allocates_no_full_precision_weight(cuda_device):
    """The product reads the codes: a call's peak allocation is its
    output, never a bf16 copy of the 3072 x 3072 weight (18.9 MB)."""
    from midgpt_tpu_torch.quant import QuantLinear

    x, codes, scale = _int8_operands(cuda_device, 8, 3072, 3072,
                                     torch.bfloat16)
    lin = QuantLinear(codes, scale)
    lin(x)  # the first call builds and loads the kernel
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = lin(x)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1 << 20
    assert _int8_err_over_tol(y, x, codes, scale) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_engine_prefix_hits_and_chunks_on_the_card(cuda_device, quant):
    """Shared-prefix traffic on the card: the cache-on runs, one-pass and
    in chunks of 8, hit the shared pages and serve the cache-off streams
    (f32 model); decode launches = n_layer x decode steps, and under
    int8 the int8 matmul launches = projections x model forwards."""
    from midgpt_tpu_torch.ops import int8_matmul as im
    from midgpt_tpu_torch.quant import QuantLinear

    cfg = ModelConfig(block_size=256, vocab_size=512, n_layer=2, n_head=2,
                      n_embd=128)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=cuda_device)
    gen = torch.Generator().manual_seed(2)
    sys_prompt = torch.randint(0, 512, (40,), generator=gen)
    prompts = [torch.cat([sys_prompt, torch.randint(0, 512, (n,),
                                                    generator=gen)]).numpy()
               for n in (3, 9, 17, 30, 5)]
    kw = dict(slots=2, page_size=16, window=4, device=cuda_device)
    if quant:
        kw.update(quant="int8", kv_quant="int8")
    runs = {}
    for name, extra in (("off", dict(prefix_cache=False)), ("on", {}),
                        ("chunk8", dict(prefill_chunk=8))):
        eng = ServingEngine(model, **kw, **extra)
        pa.paged_decode_attention.launches = 0
        im.int8_matmul.launches = 0
        rids = [eng.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
        done = eng.run()
        runs[name] = [done[r].tokens for r in rids]
        assert pa.paged_decode_attention.launches == (
            cfg.n_layer * eng.window * eng.windows) > 0
        per_forward = sum(isinstance(m, QuantLinear)
                          for m in eng.model.modules())
        assert im.int8_matmul.launches == per_forward * (
            eng.window * eng.windows + eng.prefill_dispatches)
        st = eng.stats()
        if name != "off":
            assert st["prefill_tokens_saved"] > 0
        _pages_home(eng)
    assert runs["on"] == runs["off"] == runs["chunk8"]


def _drain_checked(eng, cancel_step=None):
    """Step ``eng`` until it drains, the page invariants after every step;
    after step ``cancel_step`` the request in slot 1 is cancelled. Returns
    the cancelled id (or None)."""
    cancelled = None
    for step in range(1, 2001):
        if not eng.has_work:
            break
        eng.step()
        eng.alloc.check()
        eng.index.check(eng.alloc)
        if step == cancel_step:
            cancelled = eng.slot_req[1].rid
            assert eng.cancel(cancelled)
    assert not eng.has_work
    assert eng.alloc.quarantined_pages == 0 and not eng.parked
    _pages_home(eng)
    return cancelled


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float", "int8"])
def test_engine_under_pressure_on_the_card(cuda_device, kv_quant):
    """``openwebtext`` at depth 2 (full width), 6 requests on 4 slots and
    36 pages (the worst case is 256), every free page quarantined at step
    3 for 3 steps, one running request cancelled after step 2: growth
    evicts; the longest prompt alone, its free pages quarantined from
    step 2 to 11, parks and resumes. Pages come home after both, none
    quarantined; decode launches = n_layer x decode steps. The model in
    bf16 and in f32, over a bf16 (f32) or an int8 pool: at f32 the
    streams equal an uncontended run's."""
    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in (40, 90, 150, 200, 260, 300)]
    kw = dict(slots=4, window=4, page_size=16, device=cuda_device,
              kv_quant=kv_quant)
    for dtype in (torch.bfloat16, torch.float32):
        model = GPT.init(cfg, torch.Generator().manual_seed(0),
                         device=cuda_device, dtype=dtype)
        roomy = ServingEngine(model, **kw)
        rids = [roomy.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
        done = roomy.run()
        ref = [done[r].tokens for r in rids]
        assert roomy.evictions == 0
        eng = ServingEngine(model, num_pages=36, fault_hook=FaultPlan.parse(
            "3:exhaust@0:all:3").hook(0), **kw)
        rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
        pa.paged_decode_attention.launches = 0
        cancelled = _drain_checked(eng, cancel_step=2)
        assert pa.paged_decode_attention.launches == (
            cfg.n_layer * eng.window * eng.windows)
        assert eng.evictions >= 1 and eng.faults_injected == 1
        assert eng.lookup(cancelled).outcome == "cancelled"
        served = [i for i, r in enumerate(rids) if r != cancelled]
        assert all(len(eng.lookup(rids[i]).tokens) == 24 for i in served)
        lone = ServingEngine(model, num_pages=36, fault_hook=FaultPlan.parse(
            "2:exhaust@0:all:10").hook(0), **kw)
        rid = lone.submit(prompts[-1], 24, seed=len(prompts) - 1)
        _drain_checked(lone)
        assert lone.overload_parks >= 1
        if dtype == torch.float32:
            for i in served:
                assert eng.lookup(rids[i]).tokens == ref[i]
            assert lone.lookup(rid).tokens == ref[-1]


# -- the trainer's rest: prefetch, async saves, remat "dots" ---------------


@pytest.mark.cuda
def test_prefetch_copies_on_a_side_stream(cuda_device):
    """``PrefetchLoader`` with ``device_transform``: every batch reaches the
    card as int64 equal to the loader's, copied on a stream other than
    the consumer's, and stays equal while the consumer's stream runs
    work that reuses the allocator (each batch is ``record_stream`` ed
    onto it)."""
    import numpy as np

    from midgpt_tpu_torch.data import Loader, PrefetchLoader, device_transform

    toks = np.random.default_rng(0).integers(0, 50000, 400_000).astype(
        np.uint16)
    ref = Loader(toks, 1024, (2, 8), 1234)
    transform, finish = device_transform(cuda_device)
    pre = PrefetchLoader(Loader(toks, 1024, (2, 8), 1234), transform,
                         finish).start()
    try:
        for _ in range(6):
            x, y = pre.next()
            assert x.device.type == "cuda" and x.dtype == torch.int64
            busy = torch.randn(2048, 2048, device=cuda_device)
            for _ in range(4):  # the consumer's own work, queued behind
                busy = busy @ busy / 2048
            rx, ry = ref.next()
            assert torch.equal(x.cpu(), torch.from_numpy(rx).long())
            assert torch.equal(y.cpu(), torch.from_numpy(ry).long())
        assert pre.state_dict()["step"] == 6
    finally:
        pre.stop()


@pytest.mark.cuda
def test_async_save_of_card_tensors(cuda_device, tmp_path):
    """A save of card tensors snapshots them before it returns: the
    tensors changed right after ``save`` leave the file as it was; the
    buffers are pinned and reused by the next save."""
    from midgpt_tpu_torch.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path), keep=2, save_interval_steps=1)
    w = torch.arange(1 << 20, dtype=torch.float32, device=cuda_device)
    assert ck.save(0, {"w": w}, {"step": 0})
    w.add_(1.0)  # after the snapshot, while the write may still run
    buf = ck._buffers["/w"]
    assert buf.is_pinned()
    assert ck.save(1, {"w": w}, {"step": 1})
    assert ck._buffers["/w"] is buf
    ck.close()
    first, _ = ck.restore(0, map_location="cpu")
    second, _ = ck.restore(1, map_location="cpu")
    assert torch.equal(first["w"], torch.arange(1 << 20).float())
    assert torch.equal(second["w"], torch.arange(1 << 20).float() + 1)


@pytest.mark.cuda
def test_remat_dots_through_the_fused_kernels(cuda_device):
    """A 2-layer model (width 128, 2 heads of 64, T=128, f32) through the
    fused kernels: remat "dots" and "full" give "none"'s loss and
    gradients bit for bit; under both the fused forward runs again in
    the backward (2 n_layer launches a step), the backward once."""
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.train import loss_fn

    # the embedding's backward accumulates without atomics only so
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kw = dict(block_size=128, vocab_size=256, n_layer=2, n_head=2,
                  n_embd=128, attn_impl="fused")
        tok = torch.randint(0, 256, (2, 129),
                            generator=torch.Generator().manual_seed(1)).to(
            cuda_device)
        out = {}
        for remat in ("none", "dots", "full"):
            model = GPT.init(ModelConfig(**kw, remat=remat),
                             torch.Generator().manual_seed(0),
                             device=cuda_device)
            before = (fa.fused_attention_fwd.launches,
                      fa.fused_attention_bwd.launches)
            loss = loss_fn(model, tok[:, :-1], tok[:, 1:], 32)
            loss.backward()
            torch.cuda.synchronize()
            out[remat] = (loss.item(),
                          [p.grad.clone() for p in model.parameters()],
                          (fa.fused_attention_fwd.launches - before[0],
                           fa.fused_attention_bwd.launches - before[1]))
        assert out["none"][2] == (2, 2)
        for remat in ("dots", "full"):
            assert out[remat][0] == out["none"][0]
            assert all(torch.equal(a, b)
                       for a, b in zip(out[remat][1], out["none"][1]))
            assert out[remat][2] == (4, 2)
    finally:
        torch.use_deterministic_algorithms(False)


# -- cold-page spill and the front door on the card --------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_spill_round_trip_of_a_card_pool_is_byte_exact(cuda_device, quant):
    """``export_pages`` of three pages lands in pinned host memory (the
    copies queued, then the stream synchronized before the host reads);
    the pages are scribbled over on the card, and ``import_pages`` puts
    them back bit for bit, scale planes with them."""
    from midgpt_tpu_torch.serving import (PagedKVPool, export_pages,
                                          import_pages)

    gen = torch.Generator().manual_seed(5)
    shape = (12, 9, 12, 64, 16)  # openwebtext's [L, NP, Hkv, C, PS]
    if quant:
        k, v = (torch.randint(-127, 128, shape, generator=gen,
                              dtype=torch.int8) for _ in range(2))
        sk, sv = (torch.exp2(torch.randint(-9, -3, shape[:3],
                                           generator=gen).float())
                  for _ in range(2))
        planes = [k, v, sk, sv]
    else:
        planes = [torch.randn(shape, generator=gen).to(torch.bfloat16)
                  for _ in range(2)]
    planes = [a.to(cuda_device) for a in planes]
    pool = PagedKVPool(*planes[:2], 16, *(planes[2:] or [None, None]))
    before = [a.clone() for a in planes]
    ids = [7, 2, 4]
    payload = export_pages(pool, ids)
    host = [a for a in payload if a is not None]
    assert all(a.device.type == "cpu" and a.is_pinned() for a in host)
    for a in planes:
        a[:, ids] = 0  # the ids are recycled: queued after the export
    torch.cuda.current_stream().synchronize()
    for a, b in zip(host, before):
        assert torch.equal(a, b[:, ids].cpu())
    import_pages(pool, [1, 8, 0], *payload)
    for a, b in zip(planes, before):
        got, want = a[:, [1, 8, 0]], b[:, ids]
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(torch.int16)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        import_pages(pool, [1, 8], *payload)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
def test_engine_spills_and_faults_back_on_the_card(cuda_device, kv_quant):
    """``openwebtext`` at depth 2 (full width, f32): six 64-token system
    prompts, each served, then served again with a new 16-token turn on
    a pool that holds two requests: the first round's cold prefixes spill,
    the second faults them back (prefetch off: one import a page; on:
    batched) through the paged kernels, with the ample pool's streams."""
    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device, dtype=torch.float32)
    gen = torch.Generator().manual_seed(9)
    sys = [torch.randint(0, cfg.vocab_size, (64,), generator=gen)
           for _ in range(6)]
    turn = lambda: torch.randint(0, cfg.vocab_size, (16,),  # noqa: E731
                                 generator=gen)
    rounds = [[torch.cat([p, turn()]).numpy() for p in sys]
              for _ in range(2)]
    kw = dict(slots=2, window=4, page_size=16, prefill_chunk=32,
              device=cuda_device, kv_quant=kv_quant)

    def serve(eng):
        out = []
        for r in rounds:
            rids = [eng.submit(p, 16, seed=i) for i, p in enumerate(r)]
            while eng.has_work:
                eng.step()
                eng.alloc.check()
                eng.index.check(eng.alloc, eng._spill_store)
            out.append([eng.lookup(x).tokens for x in rids])
        return out

    ref = serve(ServingEngine(model, **kw))
    for prefetch in ("off", "on"):
        eng = ServingEngine(model, num_pages=14, spill="on",
                            spill_prefetch=prefetch, **kw)
        pa.paged_decode_attention.launches = 0
        assert serve(eng) == ref
        st = eng.stats()
        assert st["spilled_pages"] > 0 and st["spill_faultback_pages"] > 0
        assert (st["spill_prefetch_pages"] > 0) == (prefetch == "on")
        assert pa.paged_decode_attention.launches == (
            cfg.n_layer * eng.window * eng.windows)


@pytest.mark.cuda
def test_frontdoor_background_driver_on_the_card(cuda_device):
    """The front door's background task steps a card engine from a
    worker thread on the engine's stream (here a side stream, so the
    thread must make it current): the streams equal the synchronous
    loop's, and the decode kernel ran."""
    import asyncio

    from midgpt_tpu_torch.serving import AsyncFrontDoor

    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device, dtype=torch.float32)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
               for n in (20, 70, 130, 33, 250)]
    kw = dict(slots=2, window=4, page_size=16, device=cuda_device)
    eng = ServingEngine(model, **kw)
    rids = [eng.submit(p, 20, seed=i) for i, p in enumerate(prompts)]
    done = eng.run()
    ref = [done[r].tokens for r in rids]

    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        eng = ServingEngine(model, **kw)
    assert eng.stream == side

    async def go():
        async with AsyncFrontDoor(eng, check_invariants=True) as fd:
            streams = [await fd.submit(p, 20, seed=i)
                       for i, p in enumerate(prompts)]

            async def consume(st):
                return [t async for t in st]

            return await asyncio.gather(*(consume(s) for s in streams))

    pa.paged_decode_attention.launches = 0
    assert asyncio.run(go()) == ref
    assert pa.paged_decode_attention.launches == (
        cfg.n_layer * eng.window * eng.windows) > 0


# -- the serving cluster on the card -------------------------------------------


def _cluster_model(dev, dtype):
    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)
    return cfg, GPT.init(cfg, torch.Generator().manual_seed(0), device=dev,
                         dtype=dtype)


def _cluster_prompts(cfg, lens=(20, 70, 130, 33, 250, 16, 90, 48)):
    gen = torch.Generator().manual_seed(11)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
            for n in lens]


@pytest.mark.cuda
def test_cluster_replicas_stream_as_one_engine_on_the_card(cuda_device):
    """``openwebtext`` at depth 2 (full width, bf16): two replicas on one
    card, stepped in turn and (under a watchdog that never trips) on the
    cluster's worker threads, give one engine's streams request for
    request (each replica decodes at the same M = slots); the decode
    kernel ran n_layer x the replicas' decode steps and left its tickets
    zero; pages home on both."""
    from midgpt_tpu_torch.serving import ServingCluster

    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    prompts = _cluster_prompts(cfg)
    kw = dict(slots=4, window=4, page_size=16, device=cuda_device)
    eng = ServingEngine(model, **kw)
    rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
    done = eng.run()
    ref = [done[r].tokens for r in rids]
    for watchdog in (None, 600.0):
        cl = ServingCluster(model, replicas=2, dispatch_timeout_s=watchdog,
                            **kw)
        assert (cl._pool is None) == (watchdog is None)
        pa.paged_decode_attention.launches = 0
        crids = [cl.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
        cl.run()
        assert [cl.finished[r].tokens for r in crids] == ref
        assert pa.paged_decode_attention.launches == cfg.n_layer * sum(
            e.window * e.windows for e in cl.engines) > 0
        assert all(e.tokens_generated for e in cl.engines)
        torch.cuda.synchronize()
        tickets = pa._TICKETS[torch.cuda.current_device()]
        assert int(tickets.abs().sum()) == 0
        for e in cl.engines:
            _pages_home(e)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_handoff_export_import_is_byte_exact_on_the_card(cuda_device,
                                                          kv_quant):
    """A prefill-role engine's prefilled slot exported (pinned host
    copies queued on its stream, an event after them) and imported into
    a decode-role engine on another stream: the destination's pages,
    scale planes and logits row equal the source's bit for bit, with no
    host synchronize between; the imported request decodes the
    monolithic engine's stream."""
    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    prompt = _cluster_prompts(cfg, (150,))[0]
    kw = dict(slots=2, window=4, page_size=16, device=cuda_device,
              kv_quant=kv_quant)
    mono = ServingEngine(model, **kw)
    r = mono.submit(prompt, 16, seed=0)
    ref = mono.run()[r].tokens
    src = ServingEngine(model, role="prefill", **kw)
    src.submit(prompt, 16, seed=0)
    while not src.handoff_ready_slots():
        src.step()
    (s,) = src.handoff_ready_slots()
    n = -(-int(src.pooled_len[s]) // 16)
    ids = [int(x) for x in src.bt[s, :n]]
    planes = lambda e: [e.pool.k, e.pool.v] + (  # noqa: E731
        [e.pool.scale_k, e.pool.scale_v] if kv_quant else [])
    before = [a[:, ids].clone() for a in planes(src)] + [
        src.logits[s].clone()]
    rec = src.export_request(s)
    assert rec.ready is not None and rec.k.is_pinned()
    assert rec.nbytes == sum(a.nbytes for a in (rec.k, rec.v,
                                                rec.logits_row)) + (
        rec.sk.nbytes + rec.sv.nbytes if kv_quant else 0)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        dst = ServingEngine(model, role="decode", **kw)
    with dst.on_stream():
        rid = dst.import_request(rec)
    (t,) = dst._active_slots()
    got_ids = [int(x) for x in dst.bt[t, :n]]
    side.synchronize()
    bits = lambda a: a.view(torch.int16) if a.dtype == torch.bfloat16 \
        else a  # noqa: E731
    got = [a[:, got_ids] for a in planes(dst)] + [dst.logits[t]]
    for a, b in zip(got, before):
        assert torch.equal(bits(a), bits(b))
    with dst.on_stream():
        dst.run()
    assert dst.finished[rid].tokens == ref


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_handoff_import_aliases_a_resident_prefix_on_the_card(cuda_device,
                                                              kv_quant):
    """Two prompts share a 128-token prefix. The first is handed off from
    a prefill-role engine to a decode-role engine on another stream; the
    second, exported while the source stream is still busy (its copies to
    pinned memory not yet run), lands with the destination's index
    already holding the prefix: those 8 pages are aliased, only the rest
    come from the payload, and every page, scale plane and the logits row
    equal the source's bit for bit, with no host synchronize between. The
    stream equals a monolithic engine's that served the same two prompts
    in the same order."""
    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    gen = torch.Generator().manual_seed(12)
    pre, ta, tb = (torch.randint(0, cfg.vocab_size, (n,), generator=gen)
                   for n in (128, 40, 40))
    a, b = torch.cat([pre, ta]).numpy(), torch.cat([pre, tb]).numpy()
    kw = dict(slots=2, window=4, page_size=16, device=cuda_device,
              kv_quant=kv_quant)
    mono = ServingEngine(model, **kw)
    mono.submit(a, 16, seed=0)
    mono.run()
    r = mono.submit(b, 16, seed=1)
    ref = mono.run()[r].tokens
    src = ServingEngine(model, role="prefill", **kw)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        dst = ServingEngine(model, role="decode", telemetry=True, **kw)
    planes = lambda e: [e.pool.k, e.pool.v] + (  # noqa: E731
        [e.pool.scale_k, e.pool.scale_v] if kv_quant else [])
    bits = lambda x: x.view(torch.int16) if x.dtype == torch.bfloat16 \
        else x  # noqa: E731
    prefix_ids = None
    for prompt, seed in ((a, 0), (b, 1)):
        src.submit(prompt, 16, seed=seed)
        while not src.handoff_ready_slots():
            src.step()
        (s,) = src.handoff_ready_slots()
        n = -(-int(src.pooled_len[s]) // 16)
        ids = [int(x) for x in src.bt[s, :n]]
        before = [x[:, ids].clone() for x in planes(src)] + [
            src.logits[s].clone()]
        # the export's copies queue behind ~tens of ms of device time
        torch.cuda._sleep(50_000_000)
        rec = src.export_request(s)
        with dst.on_stream():
            rid = dst.import_request(rec)
        (t,) = dst._active_slots()
        got_ids = [int(x) for x in dst.bt[t, :n]]
        side.synchronize()
        got = [x[:, got_ids] for x in planes(dst)] + [dst.logits[t]]
        for x, y in zip(got, before):
            assert torch.equal(bits(x), bits(y))
        (ev,) = [e for e in dst.telemetry.events if e.kind == "handoff"
                 and e.rid == rid and e.data["direction"] == "import"]
        if prefix_ids is None:
            assert ev.data["aliased"] == 0
            prefix_ids = got_ids[:8]
        else:
            assert ev.data["aliased"] == 8 and got_ids[:8] == prefix_ids
            assert ev.data["imported"] == n - 8
        with dst.on_stream():
            dst.run()
    assert dst.finished[rid].tokens == ref
    torch.cuda.synchronize()
    _pages_home(dst)
    # a host view that is not contiguous would be packed on the host ahead
    # of the export's copies: import_pages refuses it for the card
    from midgpt_tpu_torch.serving.paged import import_pages

    cut = lambda x: None if x is None else x[:, 1:]  # noqa: E731
    with pytest.raises(ValueError, match="contiguous"):
        import_pages(dst.pool, list(range(n - 1)), cut(rec.k), cut(rec.v),
                     cut(rec.sk), cut(rec.sv))


@pytest.mark.cuda
def test_kernel_load_is_one_build_across_threads(cuda_device, tmp_path,
                                                 monkeypatch):
    """Threads that reach an unbuilt kernel at once (a cluster's replica
    workers) build it once and load one library: ``load`` holds a lock,
    and the partial file is named by thread as well as process."""
    import threading

    from midgpt_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setitem(build._LOADED, "fused_norm", None)
    build._LOADED.pop("fused_norm")
    starts = []
    real = build._start_build

    def counted(name):
        job = real(name)
        starts.append(job)
        return job

    monkeypatch.setattr(build, "_start_build", counted)
    gate = threading.Barrier(4)
    libs = []

    def worker():
        gate.wait()
        libs.append(build.load("fused_norm"))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert len(starts) == 1 and starts[0] is not None
    assert str(threading.get_ident()) not in starts[0][1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        os.path.basename(build.library_path("fused_norm"))]


# -- the engine's one-dispatch programs (CUDA graphs) --------------------------


def _engine_tensors(eng):
    p = eng.pool
    return [t for t in (eng.logits, p.k, p.v, p.scale_k, p.scale_v)
            if t is not None]


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]) if t.dtype.is_floating_point else t


def _dispatch_captures(eng):
    """Captured decode window and verify programs (every prefill chunk
    bucket is a program of its own beside them)."""
    return sum(p.graph is not None for k, p in eng._programs.items()
               if k[0] != "prefill_chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("speculate", [0, 3], ids=["window", "verify"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_program_replay_equals_the_eager_body(cuda_device, speculate,
                                              kv_quant):
    """``openwebtext`` at depth 2 (bf16; int8 weights and pool too), a
    sampled engine two steps in: one dispatch replayed from its CUDA
    graph and the same dispatch's body run eagerly from the same state
    give the same packed results, logits and pages bit for bit; a warm
    replay dispatches no aten op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    quant = dict(quant="int8", kv_quant="int8") if kv_quant else {}
    eng = ServingEngine(model, slots=4, window=4, page_size=16,
                        speculate=speculate, temperature=0.8, top_k=50,
                        seed=3, device=cuda_device, **quant)
    for i, p in enumerate(_cluster_prompts(cfg)[:4]):
        eng.submit(p, 24, seed=i)
    eng.step()
    eng.step()
    assert _dispatch_captures(eng) == 1
    assert eng.graph_captures == len(eng._programs) > 1
    eng._ensure_growth()
    kind = "verify" if speculate else "decode_window"
    body = eng._verify_body if speculate else eng._decode_body
    prog = eng._program(kind)
    extra = {}
    if speculate:
        drafts, n_draft, probs = eng._draft(eng._decoding_slots())
        extra = dict(drafts=drafts, n_draft=n_draft, probs=probs)
    start = [t.clone() for t in _engine_tensors(eng)]
    eng._load(prog, **extra)
    prog.run(body)
    out = prog.read()
    replayed = [t.clone() for t in _engine_tensors(eng)]
    for t, s in zip(_engine_tensors(eng), start):
        t.copy_(s)
    eng._load(prog, **extra)
    prog.run_eager(body)
    assert (prog.read() == out).all()
    for a, b in zip(_engine_tensors(eng), replayed):
        assert torch.equal(_bits(a), _bits(b))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        prog.run(body)
    assert Count.n == 0


@pytest.mark.cuda
def test_captures_pause_the_garbage_collector(cuda_device):
    """A program's warm-up and capture run with Python's cyclic collector
    paused (a collection inside a capture could free a dead engine's
    graph, CUDA calls a capture forbids), and it runs again after."""
    import gc

    import numpy as np

    from midgpt_tpu_torch.serving.programs import Program

    seen = []

    def body(x, probs):
        seen.append(gc.isenabled())
        return x["x"] + 1

    prog = Program(("gc",), cuda_device, [("x", (4,), torch.int32)],
                   quiet=lambda x: None)
    prog.load(x=np.arange(4, dtype=np.int32))
    prog.run(body)
    assert seen == [False, False] and gc.isenabled()
    assert prog.read().tolist() == [1, 2, 3, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("speculate", [0, 3], ids=["window", "verify"])
def test_launch_counters_count_replays(cuda_device, speculate):
    """A served run counts n_layer paged launches a decode step (or a
    verify dispatch) as the eager body does: the capture's record once per
    replay, the warm-up call and the capture itself not at all."""
    from midgpt_tpu_torch.serving.programs import Program

    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    prompts = _cluster_prompts(cfg)
    kernel = (pa.paged_verify_attention if speculate
              else pa.paged_decode_attention)
    counts, streams = [], []
    for eager in (False, True):
        run = Program.run
        if eager:
            Program.run = Program.run_eager
        try:
            eng = ServingEngine(model, slots=4, window=4, page_size=16,
                                speculate=speculate, device=cuda_device)
            kernel.launches = 0
            rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
            done = eng.run()
        finally:
            Program.run = run
        per = eng.verify_dispatches if speculate else (
            eng.window * eng.windows)
        assert kernel.launches == cfg.n_layer * per > 0
        counts.append(kernel.launches)
        streams.append([done[r].tokens for r in rids])
        if not eager:
            (prog,) = [p for k, p in eng._programs.items()
                       if k[0] != "prefill_chunk"]
            assert prog.replay_launches[kernel] == cfg.n_layer * (
                1 if speculate else eng.window)
            assert prog.warmup_launches == prog.replay_launches
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_capture_survives_another_replicas_worker(cuda_device):
    """Captures on replica workers: a cluster under a watchdog steps both
    replicas on worker threads at once, each capturing its program there,
    with one engine's streams; and an engine captures its first window
    while another thread keeps queueing, allocating, reading back and
    waiting on its own stream, as a replica's worker does (the capture is
    thread-local; a device-wide synchronize would invalidate it, and no
    serving path makes one)."""
    import threading

    from midgpt_tpu_torch.serving import ServingCluster

    cfg, model = _cluster_model(cuda_device, torch.bfloat16)
    prompts = _cluster_prompts(cfg)
    kw = dict(slots=4, window=4, page_size=16, device=cuda_device)
    eng = ServingEngine(model, **kw)
    rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
    done = eng.run()
    ref = [done[r].tokens for r in rids]
    cl = ServingCluster(model, replicas=2, dispatch_timeout_s=600.0, **kw)
    crids = [cl.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
    cl.run()
    assert [cl.finished[r].tokens for r in crids] == ref
    assert [_dispatch_captures(e) for e in cl.engines] == [1, 1]

    stop = threading.Event()
    busy = []

    def other():
        side = torch.cuda.Stream()
        # a generator of its own: the default one is registered with
        # every capture, and advancing it while one runs raises
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        with torch.cuda.stream(side):
            while not stop.is_set():
                x = torch.randn(512, 512, device=cuda_device, generator=gen)
                busy.append(float((x @ x).sum()))  # a synchronizing read
                side.synchronize()

    worker = threading.Thread(target=other)
    worker.start()
    try:
        eng = ServingEngine(model, **kw)
        rids = [eng.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
        done = eng.run()
    finally:
        stop.set()
        worker.join()
    assert busy and _dispatch_captures(eng) == 1
    assert [done[r].tokens for r in rids] == ref


# -- the trainer's dispatch programs: keyed dropout, the flash seed by
# pointer, the step program and the K-step window ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,offset", [(64 * 256 * 384, 0), (1000003, 0),
                                      (4099, 1)],
                         ids=["char", "odd", "misaligned"])
def test_keyed_dropout_kernel_equals_plain(cuda_device, dtype, n, offset):
    """Bit for bit the plain version, forward and backward; another key
    another mask; a graph replay reads the key's current value."""
    from midgpt_tpu_torch.ops import dropout as kd

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    buf = torch.randn(n + offset, generator=gen, device=cuda_device).to(dtype)
    x = buf[offset:]
    key = torch.tensor(0x0123456789ABCDE, device=cuda_device)
    before = kd.keyed_dropout.launches
    got = kd.keyed_dropout(x, key, 0.2)
    assert kd.keyed_dropout.launches == before + 1
    assert torch.equal(got, kd.keyed_dropout_reference(x, key, 0.2))
    assert not torch.equal(got, kd.keyed_dropout_reference(x, key + 1, 0.2))
    leaf = x.detach().requires_grad_()
    dy = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    kd.dropout(leaf, key, 0.2).backward(dy)
    assert torch.equal(leaf.grad, kd.keyed_dropout_reference(dy, key, 0.2))
    static = key.clone()
    kd.keyed_dropout(x, static, 0.2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = kd.keyed_dropout(x, static, 0.2)
    for k in (3, 1 << 40):
        static.fill_(k)
        graph.replay()
        assert torch.equal(y, kd.keyed_dropout_reference(x, static, 0.2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernels_read_the_seed_from_device_memory(cuda_device, dtype):
    """The forward's keep-mask read off its output (q = 0, v = I,
    non-causal) is the counter hash of the seed at the call's anchors;
    an int seed and the same seed as a tensor give the same bits for the
    three kernels; a graph replay after the seed tensor is rewritten
    equals eager launches at the new seed."""
    from midgpt_tpu_torch.ops import flash as fl

    b, h, t = 2, 3, 64
    q = torch.zeros(b, h, t, t, device=cuda_device, dtype=dtype)
    v = torch.eye(t, device=cuda_device, dtype=dtype).expand(
        b, h, t, t).contiguous()
    seed = torch.tensor(-12345 & 0xFFFFFFFF, device=cuda_device)
    heads = (7 + torch.arange(b, device=cuda_device)[:, None] * h
             + torch.arange(h, device=cuda_device)[None, :])
    ar = torch.arange(t, device=cuda_device)
    out, _ = fl.flash_fwd(q, q, v, False,
                          fl.Dropout(0.2, seed, 4096, 192, 7, h))
    want = fl._keep_mask(-12345, heads, 4096 + ar, 192 + ar, 0.8)
    assert torch.equal(out != 0, want)
    args = _flash_inputs(cuda_device, 2, 256, 4, 2, 64, dtype, seed=3)
    by_int = _flash_run(fl, args, fl.Dropout(0.2, -12345), kernel=True)
    by_tensor = _flash_run(fl, args, fl.Dropout(0.2, seed), kernel=True)
    for a, c in zip(by_int, by_tensor):
        assert torch.equal(a, c)
    static = seed.clone()
    drop = fl.Dropout(0.2, static)
    _flash_run(fl, args, drop, kernel=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = _flash_run(fl, args, drop, kernel=True)
    for s in (5, 1 << 31):
        static.fill_(s)
        graph.replay()
        eager = _flash_run(fl, args, fl.Dropout(0.2, s), kernel=True)
        for a, c in zip(outs, eager):
            assert torch.equal(a, c)


def _program_case(cuda_device, k, **model_kw):
    from midgpt_tpu_torch.config import ExperimentConfig
    from midgpt_tpu_torch.train import init_state, make_shadow

    model = ModelConfig(**{**dict(block_size=256, vocab_size=65, n_layer=2,
                                  n_head=2, n_embd=128, dropout=0.2,
                                  remat="full", attn_impl="auto"),
                           **model_kw})
    cfg = ExperimentConfig(model=model, batch_size=8, g_accum_iters=2,
                           warmup_steps=2, lr_decay_steps=20)
    state = init_state(cfg, cuda_device)
    shadow = make_shadow(state.model, torch.bfloat16)
    toks = torch.randint(0, 65, (k, 2, 4, 257), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    return cfg, state, shadow, toks[..., :-1], toks[..., 1:]


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw", [{}, dict(dropout=0.0, remat="dots"),
                                      dict(dropout=0.0, mlp="moe",
                                           moe_experts=4)],
                         ids=["flash_dropout", "fused_dots", "fused_moe"])
def test_step_program_replays_equal_the_eager_body(cuda_device, model_kw):
    """A depth-4 program run twice from the same init: once through its
    graph (warm-up, capture, replays), once as the eager body alone; the
    stacked loss, grad norm and lr, the masters and the moments bit for
    bit, and the kernels' launches equal."""
    from midgpt_tpu_torch.ops import dropout as kd
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.train import (
        make_lr_schedule, step_body, step_keys, step_scalars)
    from midgpt_tpu_torch.train_programs import StepProgram

    kernels = (fl.flash_fwd, fl.flash_bwd_dq, fl.flash_bwd_dkv,
               fa.fused_attention_fwd, fa.fused_attention_bwd,
               kd.keyed_dropout)
    res = {}
    for mode in ("graph", "eager"):
        cfg, state, shadow, xs, ys = _program_case(cuda_device, 4, **model_kw)
        prog = StepProgram(cfg, cuda_device, 4)
        prog.bind(state)
        before = [f.launches for f in kernels]
        rows = []
        for w in range(2):
            prog.load(step_scalars(cfg, make_lr_schedule(cfg), 4 * w,
                                   state.step, 4), step_keys(cfg, 4 * w, 4),
                      xs, ys)
            for _ in range(4):
                body = lambda: step_body(prog, state, shadow, cfg)  # noqa
                if mode == "graph":
                    prog.run(body)
                else:
                    body()
            rows.append(prog.read(4))
            state.step += 4
        if mode == "graph":
            assert prog.graph is not None and prog.capture_ms > 0
        res[mode] = (rows, [p.detach().clone() for p in
                            state.model.parameters()] + state.mu + state.nu,
                     [f.launches - b for f, b in zip(kernels, before)])
    (rg, tg, lg), (re_, te, le) = res["graph"], res["eager"]
    for a, c in zip(rg, re_):
        assert (a == c).all()
    for a, c in zip(tg, te):
        assert torch.equal(a, c)
    assert lg == le and any(lg)


@pytest.mark.cuda
def test_train_k4_equals_k1_on_the_card(cuda_device, tmp_path):
    """``train()`` with dropout at K=1 and K=4 over 10 steps: every logged
    step's loss, lr and grad norm bit for bit, the same val loss, 10 and
    3 dispatches, equal kernel launches (and the shapes' counts)."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.ops import dropout as kd
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.train import train
    from midgpt_tpu_torch.utils.metrics import read_metrics

    gen = torch.Generator().manual_seed(0)
    for split in ("train", "val"):
        write_tokens(str(tmp_path / "data" / f"{split}.bin"),
                     torch.randint(0, 65, (50_000,), generator=gen).numpy())
    runs = {}
    for k in (1, 4):
        cfg = get_config("shakespeare_char", rundir=str(tmp_path / f"k{k}"),
                         data_dir=str(tmp_path / "data"), max_steps=10,
                         warmup_steps=2, lr_decay_steps=10, eval_interval=8,
                         eval_batches=1, ckpt_interval=1000, log_interval=1,
                         batch_size=16, steps_per_dispatch=k)
        fl.flash_bwd_dq.launches = kd.keyed_dropout.launches = 0
        final = train(cfg)
        logged = {r["step"]: (r["loss/optimized"], r["lr"], r["grad_norm"])
                  for r in read_metrics(cfg.rundir) if "loss/optimized" in r}
        runs[k] = (final, logged, fl.flash_bwd_dq.launches,
                   kd.keyed_dropout.launches)
    (f1, l1, d1, k1), (f4, l4, d4, k4) = runs[1], runs[4]
    assert sorted(l1) == list(range(1, 10)) and l1 == l4
    assert f1["losses"] == f4["losses"] and f1["val_loss"] == f4["val_loss"]
    assert (f1["train_dispatches"], f4["train_dispatches"]) == (10, 3)
    # dropout: 13 sites forward, 13 backward, and the 6 attention-output
    # sites again in remat "full"'s recompute (it stops at the last tensor
    # the backward needs, before the MLP output's site)
    assert (d1, k1) == (d4, k4) and d1 == 10 * 6 and k1 == 10 * 32


# -- the last one-card programs: every prefill chunk bucket and the
# fixed-batch sampler -----------------------------------------------------


def _prefill_engine(dev, cfg_name, kv_quant, slots=2):
    cfg = dataclasses.replace(get_model_config(cfg_name), n_layer=2)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=dev,
                     dtype=torch.bfloat16)
    eng = ServingEngine(model, slots=slots, page_size=16, device=dev,
                        kv_quant=kv_quant)
    gen = torch.Generator(device=dev).manual_seed(1)
    p = eng.pool
    if kv_quant:
        for plane in (p.k, p.v):
            plane.copy_(torch.randint(-127, 128, plane.shape, generator=gen,
                                      device=dev, dtype=torch.int8))
        for plane in (p.scale_k, p.scale_v):
            plane.copy_(torch.exp2(torch.randint(-9, -5, plane.shape,
                                                 generator=gen, device=dev)
                                   .float()))
    else:
        for plane in (p.k, p.v):
            plane.copy_(torch.randn(plane.shape, generator=gen, device=dev))
    eng.logits.copy_(torch.randn(eng.logits.shape, generator=gen, device=dev))
    return cfg, eng


def _chunk_inputs(cfg, eng, bucket, start, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    real_n = min(bucket - 3, cfg.block_size - start)
    bt = np.full((eng.pmax,), eng._sentinel, np.int32)
    n = -(-(start + real_n) // eng.page_size)
    bt[:n] = rng.permutation(eng.alloc.num_pages)[:n]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :real_n] = rng.integers(0, cfg.vocab_size, real_n)
    return dict(start=start, real_n=real_n, tokens=toks, bt=bt)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_name", ["openwebtext", "openwebtext_moe"],
                         ids=["dense", "moe"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf16", "int8"])
def test_prefill_replay_equals_the_eager_body(cuda_device, cfg_name,
                                              kv_quant):
    """Every bucket (16 .. 1024 tokens at page size 16) and class, at
    start 0, mid-page and page-aligned, from one state: a replay of the
    chunk's program and its body run eagerly leave every page, the
    scale planes and the logits bit for bit alike; the chunk wrote its
    slot's logits row and pages; a warm replay dispatches no aten op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, eng = _prefill_engine(cuda_device, cfg_name, kv_quant)
    buckets = eng.warm_prefill(cfg.block_size)
    assert buckets == [16 << i for i in range(7)]
    for bucket in buckets:
        for start in (0, 13, 32):
            x = _chunk_inputs(cfg, eng, bucket, start, bucket + start)
            prog = eng._prefill_program(bucket, start > 0)
            body = eng._prefill_body(start > 0)
            before = [t.clone() for t in _engine_tensors(eng)]
            prog.load(slot=1, **x)
            prog.run(body)
            replayed = [t.clone() for t in _engine_tensors(eng)]
            assert not torch.equal(replayed[0][1], before[0][1])
            assert torch.equal(replayed[0][0], before[0][0])
            for t, s in zip(_engine_tensors(eng), before):
                t.copy_(s)
            prog.load(slot=1, **x)
            prog.run_eager(body)
            for a, b in zip(_engine_tensors(eng), replayed):
                assert torch.equal(_bits(a), _bits(b)), (bucket, start)

            class Count(TorchDispatchMode):
                n = 0

                def __torch_dispatch__(self, func, types, args=(),
                                       kwargs=None):
                    Count.n += 1
                    return func(*args, **(kwargs or {}))

            with Count():
                prog.run(body)
            assert Count.n == 0


@pytest.mark.cuda
def test_prefill_loads_back_to_back_keep_their_inputs(cuda_device):
    """Six chunks of one program for six slots, each loaded while the
    stream still sleeps behind the earlier ones (nothing read between):
    every slot's pages and logits row equal a run that waits after each
    chunk. The ring of pinned mirrors waits only where it wraps."""
    cfg, eng = _prefill_engine(cuda_device, "openwebtext", None, slots=6)
    prog = eng._prefill_program(64, False)
    body = eng._prefill_body(False)
    inputs = []
    for slot in range(6):
        x = _chunk_inputs(cfg, eng, 64, 0, slot)
        x["bt"][:4] = range(4 * slot, 4 * slot + 4)  # disjoint pages
        inputs.append(x)
    state = [t.clone() for t in _engine_tensors(eng)]
    prog.load(slot=0, **inputs[0])
    prog.run(body)  # the capture
    for t, s in zip(_engine_tensors(eng), state):
        t.copy_(s)
    torch.cuda.synchronize()
    for slot, x in enumerate(inputs):
        prog.load(slot=slot, **x)
        prog.run(body)
        torch.cuda.synchronize()
    waited = [t.clone() for t in _engine_tensors(eng)]
    for t, s in zip(_engine_tensors(eng), state):
        t.copy_(s)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    for slot, x in enumerate(inputs):
        prog.load(slot=slot, **x)
        prog.run(body)
    torch.cuda.synchronize()
    for a, b in zip(_engine_tensors(eng), waited):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_warm_prefill_captures_every_bucket_and_writes_nothing(cuda_device):
    """``warm_prefill`` captures both classes of every bucket and leaves
    the pool and the logits bit for bit; a served trace after it (the
    prefix cache on, chunks of 48) captures no prefill program, and its
    streams equal those of every program run eagerly."""
    from midgpt_tpu_torch.serving.programs import Program

    cfg, eng = _prefill_engine(cuda_device, "openwebtext", None)
    before = [t.clone() for t in _engine_tensors(eng)]
    buckets = eng.warm_prefill(300)
    assert buckets == [16, 32, 64, 128, 256, 512]
    for a, b in zip(_engine_tensors(eng), before):
        assert torch.equal(_bits(a), _bits(b))
    assert eng.graph_captures == 2 * len(buckets)
    prompts = _cluster_prompts(cfg)
    streams = []
    for eager in (False, True):
        run = Program.run
        if eager:
            Program.run = Program.run_eager
        try:
            e = ServingEngine(eng.model, slots=4, page_size=16,
                              prefill_chunk=48, device=cuda_device)
            e.warm_prefill(300)
            made = e.graph_captures
            rids = [e.submit(p, 16, seed=i) for i, p in enumerate(prompts)]
            done = e.run()
        finally:
            Program.run = run
        assert e.prefill_dispatches > len(prompts)
        if not eager:
            assert e.graph_captures == made + 1  # the decode window
        streams.append([done[r].tokens for r in rids])
        _pages_home(e)
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,sliding,chunk", [
    (100, 40, "exact", 16), (1000, 40, "exact", 16), (1000, 40, "kv", 16)],
    ids=["partial_chunks", "exact_reforward", "kv_slides"])
def test_sampler_replays_equal_the_eager_bodies(cuda_device, p, n, sliding,
                                                chunk):
    """``generate`` at depth 2 (bf16, B=4): the tokens of the programs'
    replays equal their bodies run eagerly bit for bit, sampled and
    greedy; a second call replays with no aten op between its copy in
    and its read; launches equal the eager bodies'."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from midgpt_tpu_torch import sampling
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.serving.programs import Program

    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device=cuda_device,
                     dtype=torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (4, p),
                           generator=torch.Generator().manual_seed(2)).numpy()
    kernels = (fl.flash_fwd, fa.fused_attention_fwd)
    for kw in (dict(temperature=0.0), dict(temperature=0.8, top_k=50)):
        out = {}
        for eager in (False, True):
            run = Program.run
            if eager:
                Program.run = Program.run_eager
            try:
                before = [k.launches for k in kernels]
                toks = sampling.generate(model, prompt, n, seed=5,
                                         sliding=sliding, chunk_len=chunk,
                                         device=cuda_device, **kw)
                out[eager] = (toks.cpu(), [k.launches - b for k, b in
                                           zip(kernels, before)])
            finally:
                Program.run = run
        assert torch.equal(out[False][0], out[True][0]), kw
        assert out[False][1] == out[True][1]
    progs = list(sampling._SAMPLERS.values())[-1]
    assert all(prog.graph is not None for prog in progs.programs())

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    progs.load(prompt, 7)
    with Count():
        progs.run()
    assert Count.n == 0
    assert torch.equal(progs.read(), sampling.generate(
        model, prompt, n, seed=7, sliding=sliding, chunk_len=chunk,
        device=cuda_device, temperature=0.8, top_k=50))


@pytest.mark.cuda
def test_sampler_programs_follow_the_models_tensors(cuda_device):
    """A model whose tensors are replaced between two ``generate`` calls
    (``load_state_dict(..., assign=True)``, the old ones freed) samples
    with its new weights: the second call captures new programs, whose
    tokens equal those of a model that held these weights from the
    start. Replaying the first call's graphs would read the freed
    tensors."""
    from midgpt_tpu_torch import sampling

    cfg = dataclasses.replace(get_model_config("openwebtext"), n_layer=2)

    def make(seed):
        return GPT.init(cfg, torch.Generator().manual_seed(seed),
                        device=cuda_device, dtype=torch.bfloat16)

    model, other = make(0), make(1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 100),
                           generator=torch.Generator().manual_seed(2)).numpy()
    kw = dict(temperature=0.0, chunk_len=16, device=cuda_device)
    first = sampling.generate(model, prompt, 40, **kw).cpu()
    old = list(sampling._SAMPLERS.values())[-1]
    model.load_state_dict(
        {k: v.clone() for k, v in other.state_dict().items()}, assign=True)
    torch.cuda.synchronize()
    got = sampling.generate(model, prompt, 40, **kw).cpu()
    new = list(sampling._SAMPLERS.values())[-1]
    assert new is not old and old.key not in sampling._SAMPLERS
    want = sampling.generate(other, prompt, 40, **kw).cpu()
    assert torch.equal(got, want)
    assert not torch.equal(first, want)



# -- the data-parallel / FSDP trainer: world 1 over NCCL, world 2 where two
# cards are ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 5 * 384, (1 << 32) - 100],
                         ids=["zero", "row", "wraps"])
def test_keyed_dropout_kernel_at_an_offset(cuda_device, offset):
    from midgpt_tpu_torch.ops import dropout as kd

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(4099, generator=gen, device=cuda_device).bfloat16()
    key = torch.tensor(0x0123456789ABCDE, device=cuda_device)
    got = kd.keyed_dropout(x, key, 0.2, offset)
    assert torch.equal(got, kd.keyed_dropout_reference(x, key, 0.2, offset))
    if offset:
        assert not torch.equal(got, kd.keyed_dropout(x, key, 0.2))


def _mesh_windows(cfg, state, shadow, xs, ys, dev, mesh=None):
    """Two windows of 4 steps through a depth-4 program's graph: the
    stacked rows, and the program."""
    from midgpt_tpu_torch.train import (
        make_lr_schedule, step_body, step_keys, step_scalars)
    from midgpt_tpu_torch.train_programs import StepProgram

    prog = StepProgram(cfg, dev, 4, mesh)
    prog.bind(state)
    rows = []
    for w in range(2):
        prog.load(step_scalars(cfg, make_lr_schedule(cfg), 4 * w,
                               state.step, 4), step_keys(cfg, 4 * w, 4),
                  xs, ys)
        for _ in range(4):
            prog.run(lambda: step_body(prog, state, shadow, cfg))
        rows.append(prog.read(4))
        state.step += 4
    assert prog.graph is not None
    return rows, prog


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw", [{}, dict(dropout=0.0, remat="dots")],
                         ids=["flash_dropout", "fused_dots"])
def test_one_rank_nccl_step_program_equals_single_card(cuda_device, tmp_path,
                                                       model_kw):
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.ops import launches
    from midgpt_tpu_torch.parallel import create_mesh, sharding
    from midgpt_tpu_torch.train import init_sharded_state

    cfg, state, shadow, xs, ys = _program_case(cuda_device, 4, **model_kw)
    ref_rows, _ = _mesh_windows(cfg, state, shadow, xs, ys, cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = create_mesh(MeshConfig())
        sharded = init_sharded_state(cfg, mesh, cuda_device)
        before = sharding.collective_launches()
        rows, prog = _mesh_windows(cfg, sharded, sharded.shadow, xs, ys,
                                   cuda_device, mesh)
        after = sharding.collective_launches()
        items = sharded.items()
    finally:
        dist.destroy_process_group()
    for a, c in zip(rows, ref_rows):
        assert (a == c).all()
    ref = state.items()
    for key in ("params", "mu", "nu"):
        for n, t in ref[key].items():
            assert torch.equal(items[key][n], t.cpu()), (key, n)
    # beside the mean loss and the grad norm, the one-rank tensor group's
    # all-reduces (the model's tensor sums, the QK-norm gradients')
    # captured in the replay
    reduces = chip_smoke().tensor_all_reduces(cfg)
    rec = launches.names(prog.replay_launches)
    assert (rec["sharding.all_gather"], rec["sharding.reduce_scatter"],
            rec["sharding.all_reduce"]) == (1, 1, reduces)
    # the warm-up's eager step and 7 replays (the capture launches nothing)
    assert {k: after[k] - before[k] for k in after} == {
        "all_gather": 8, "reduce_scatter": 8, "all_reduce": 8 * reduces,
        "send_recv": 0, "all_to_all": 0}


def _two_card_worker(rank, store, out, model_kw):
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel import batch_rows, create_mesh
    from midgpt_tpu_torch.train import init_sharded_state

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=2, device_id=dev)
    try:
        cfg, _, _, xs, ys = _program_case(dev, 4, **model_kw)
        mesh = create_mesh(MeshConfig())
        state = init_sharded_state(cfg, mesh, dev)
        sl = batch_rows(xs.shape[2], mesh)
        state.shadow.set_batch_offset(sl.start)
        rows, _ = _mesh_windows(cfg, state, state.shadow,
                                xs[:, :, sl].contiguous(),
                                ys[:, :, sl].contiguous(), dev, mesh)
        if rank == 0:
            torch.save(rows, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("model_kw", [{}, dict(dropout=0.0, remat="dots")],
                         ids=["flash_dropout", "fused_dots"])
def test_two_card_step_program_matches_one(cuda_device, tmp_path, model_kw):
    """A world of two NCCL ranks (one a card) on the same global batches
    as the single-card program: loss and grad norm within 1e-2 (each
    rank's bf16 gradients accumulate over its own rows before the f32
    reduction)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL runs one rank a card")
    import torch.multiprocessing as mp

    cfg, state, shadow, xs, ys = _program_case(cuda_device, 4, **model_kw)
    ref_rows, _ = _mesh_windows(cfg, state, shadow, xs, ys, cuda_device)
    out = str(tmp_path / "rows.pt")
    mp.spawn(_two_card_worker, args=(str(tmp_path / "store"), out, model_kw),
             nprocs=2, join=True)
    rows = torch.load(out, weights_only=False)
    for a, c in zip(rows, ref_rows):
        np_a, np_c = a[:, :2], c[:, :2]
        assert (abs(np_a - np_c) <= 1e-2 * abs(np_c)).all(), (a, c)


# -- sequence parallelism: the sliced residual mask, an off-diagonal ring
# hop, ring attention in a world-1 NCCL step program ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,s,i", [((4, 256, 384), 2, 1),
                                       ((4, 256, 384), 4, 3),
                                       ((3, 12, 7), 4, 2)],
                         ids=["vector_half", "vector_quarter", "scalar"])
def test_keyed_dropout_kernel_on_a_sequence_slice(cuda_device, dtype, shape,
                                                  s, i):
    """A sequence rank's ``[B, T/S, D]`` slice under (offset, inner,
    inner_stride): bit for bit its plain version and the whole rows' mask
    at its columns (rows of 128 x 384 elements take the vector loop, rows
    of 3 x 7 the one-element loop)."""
    from midgpt_tpu_torch.ops import dropout as kd

    b, t, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    whole = torch.randn(b, t, d, generator=gen, device=cuda_device).to(dtype)
    key = torch.tensor(0x0123456789ABCDE, device=cuda_device)
    tl = t // s
    x = whole[:, i * tl:(i + 1) * tl].contiguous()
    off = 2 * t * d + i * tl * d  # batch row 2 of the global batch
    got = kd.keyed_dropout(x, key, 0.2, off, tl * d, t * d)
    assert torch.equal(got, kd.keyed_dropout_reference(x, key, 0.2, off,
                                                       tl * d, t * d))
    full = kd.keyed_dropout(whole, key, 0.2, 2 * t * d)
    assert torch.equal(got, full[:, i * tl:(i + 1) * tl])
    assert not torch.equal(got, kd.keyed_dropout(x, key, 0.2, off))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_off_diagonal_ring_hop_matches_plain(cuda_device, rate):
    """One ring hop off the diagonal (q chunk 2 against kv chunk 0 of 4:
    non-causal, col_off != row_off) with a nonzero lse cotangent, bf16,
    through the flash kernels against their plain version in f32 on the
    upcast inputs by the triangle rule (out, lse by the f32 rule, dq, dk,
    dv)."""
    from midgpt_tpu_torch.ops import flash as fl

    b, tc, h, hkv, c = 2, 256, 4, 2, 64
    q, k, v, dout = _flash_inputs(cuda_device, b, tc, h, hkv, c,
                                  torch.bfloat16, seed=5)
    gen = torch.Generator().manual_seed(6)
    dlse = torch.randn(b, h, tc, generator=gen).to(cuda_device)
    drop = (fl.Dropout(rate, 77, row_off=2 * tc, col_off=0, bh_off=h,
                       n_head_total=h) if rate else None)

    def run(args, kernel):
        leaves = [a.detach().requires_grad_() for a in args]
        if kernel:
            out, lse = fl._FlashLSE.apply(*leaves, False, drop)
        else:
            out, lse = fl.flash_forward_reference(*leaves, False, drop)
        grads = torch.autograd.grad((out.float() * dout.float()).sum()
                                    + (lse * dlse).sum(), leaves)
        return (out, lse, *grads)

    got = run((q, k, v), True)
    plain = run((q, k, v), False)
    ref32 = [x.float() for x in run([a.float() for a in (q, k, v)], False)]
    for name, g, p, r in zip(("out", "lse", "dq", "dk", "dv"), got, plain,
                             ref32):
        assert torch.isfinite(g).all(), name
        if name == "lse":
            assert ((g - r).abs() / (1e-5 + 1e-5 * r.abs())).max() <= 1.0
        else:
            own = (p.float() - r).abs().max()
            assert (g.float() - r).abs().max() <= 2 * own, name
    # the hop's anchors matter: the diagonal's column anchor is refused
    if drop is not None:
        drop = drop._replace(col_off=2 * tc)
        wrong = run((q, k, v), False)
        assert (got[0].float() - wrong[0].float()).abs().max() > 2 * (
            plain[0].float() - ref32[0]).abs().max()


@pytest.mark.cuda
def test_one_rank_nccl_ring_program_equals_flash(cuda_device, tmp_path):
    """attn_impl="ring" (and "ulysses") in a world-1 NCCL step program
    equals attn_impl="flash" bit for bit: at one sequence index both are
    one flash call."""
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.parallel import create_mesh
    from midgpt_tpu_torch.train import init_sharded_state

    rows, launches = {}, {}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = create_mesh(MeshConfig(fsdp=1, sequence=1))
        for impl in ("flash", "ring", "ulysses"):
            cfg, _, _, xs, ys = _program_case(cuda_device, 4, attn_impl=impl)
            state = init_sharded_state(cfg, mesh, cuda_device)
            before = fl.flash_fwd.launches
            rows[impl], prog = _mesh_windows(cfg, state, state.shadow, xs,
                                             ys, cuda_device, mesh)
            launches[impl] = (fl.flash_fwd.launches - before,
                              dict(prog.replay_launches))
            assert prog.replay_launches[fl.flash_fwd] > 0
    finally:
        dist.destroy_process_group()
    for impl in ("ring", "ulysses"):
        for a, c in zip(rows[impl], rows["flash"]):
            assert (a == c).all(), impl
        assert launches[impl] == launches["flash"]


# -- the tensor axis: the loopback on one card, and a tensor=1 world of one --


def _tensor_case(kind, cuda_device, dtype, tp=None):
    """A small module of ``kind`` (a fused-route block, an MoE layer or
    the embedding with the chunked loss) in ``dtype`` on the card, held
    as ``tp`` loopback tensor shards (None: unsharded), and its outputs
    and gradients after one forward and backward (parameter gradients in
    the full layout)."""
    from midgpt_tpu_torch.models.gpt import (
        Block, MoEMLP, _rope_tables_full, shard_tensor)
    from midgpt_tpu_torch.models.layers import Embedding
    from midgpt_tpu_torch.ops.loss import chunked_softmax_xent
    from midgpt_tpu_torch.parallel.sharding import tensor_dim, tensor_unshard
    from midgpt_tpu_torch.parallel.tensor import (
        LoopbackTensorExchange, held_shard)

    cfg = ModelConfig(block_size=256, vocab_size=512, n_layer=1, n_head=4,
                      n_kv_head=4 if kind != "gqa" else 2, n_embd=512,
                      mlp="swiglu" if kind == "gqa" else
                      ("moe" if kind == "moe" else "gelu"), moe_experts=4,
                      remat="none")
    gen = torch.Generator().manual_seed(0)
    if kind == "embed_loss":
        module, prefix = Embedding.init(512, 512, 512 ** -0.5, gen), "wte."
    elif kind == "moe":
        module, prefix = MoEMLP.init(cfg, gen), "blocks.0.mlp."
    else:
        module, prefix = Block.init(cfg, gen), "blocks.0."
    ex = None if tp is None else LoopbackTensorExchange(tp)
    if ex is not None:
        shard_tensor(module, ex, cfg, prefix)
    module = module.to(cuda_device, dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 256, 512, generator=gen).to(cuda_device, dtype)
    dout = torch.randn(2, 256, 512, generator=gen).to(cuda_device, dtype)
    ids = torch.randint(0, 512, (2, 2, 256), generator=gen).to(cuda_device)
    x.requires_grad_()
    params = dict(module.named_parameters())
    if kind == "embed_loss":
        emb = module(ids[0])
        loss = chunked_softmax_xent(x, module.weight.t(), ids[1], chunk_t=64,
                                    tensor=ex)
        roots, seeds = [emb, loss], [dout, torch.ones_like(loss)]
        outs = {"embed": emb, "loss": loss}
    else:
        rope = _rope_tables_full(128, 256, cfg.rope_base, cuda_device)
        out = module(x, rope, "auto") if kind != "moe" else module(x)[0]
        roots, seeds, outs = [out], [dout], {"out": out}
    grads = torch.autograd.grad(roots, [x, *params.values()], seeds)
    # the loss's x is the head's input (chip_smoke's dh)
    outs["dh" if kind == "embed_loss" else "dx"] = grads[0]
    for (n, p), g in zip(params.items(), grads[1:]):
        dim = tensor_dim(prefix + n)
        if ex is not None and dim is not None:
            g = tensor_unshard(prefix + n, [held_shard(g, j, ex, dim)
                                            for j in range(tp)], cfg)
        outs["d " + n] = g
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tp", [
    ("mha", 2), ("mha", 4), ("gqa", 2), ("moe", 2), ("moe", 4),
    ("embed_loss", 2), ("embed_loss", 4),
])
def test_loopback_tensor_shards_hold_to_the_unsharded_module(cuda_device,
                                                             kind, tp):
    """The trainer's tensor-parallel modules on a loopback exchange (every
    virtual rank's shard in one process), bf16 through the kernels: each
    output and gradient within ``chip_smoke.tensor_bf16_factor`` times
    the unsharded module's bf16 distance from its f32 run (the tensor
    phase's rule); the block's attention takes the fused kernels at H /
    tp heads (the GQA block's Hkv = 2 splits two ways at most)."""
    from midgpt_tpu_torch.ops import fused_attn as fa

    factor = chip_smoke().tensor_bf16_factor
    ref32 = _tensor_case(kind, cuda_device, torch.float32)
    own = _tensor_case(kind, cuda_device, torch.bfloat16)
    before = fa.fused_attention_fwd.launches
    got = _tensor_case(kind, cuda_device, torch.bfloat16, tp)
    torch.cuda.synchronize()
    if kind in ("mha", "gqa"):
        assert fa.fused_attention_fwd.launches - before == tp
    for k, r in ref32.items():
        limit = factor(tp, k) * (own[k].float()
                                 - r.float()).abs().max().item()
        assert (got[k].float() - r.float()).abs().max().item() <= limit, k


@pytest.mark.cuda
def test_one_rank_nccl_tensor1_program_equals_single_card(cuda_device,
                                                          tmp_path):
    """A world of one NCCL rank at ``tensor=1`` (the tensor axis's code
    path with one shard: the whole model computing through a one-rank
    tensor group) runs the sharded step program to the single-card rows
    bit for bit, its tensor all-reduces captured in the replay."""
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.ops import launches
    from midgpt_tpu_torch.parallel import create_mesh
    from midgpt_tpu_torch.train import init_sharded_state

    cfg, state, shadow, xs, ys = _program_case(cuda_device, 4, dropout=0.0)
    ref_rows, _ = _mesh_windows(cfg, state, shadow, xs, ys, cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = create_mesh(MeshConfig(fsdp=-1, tensor=1))
        assert mesh.tp_size == 1 and mesh.tensor_group is not None
        sharded = init_sharded_state(cfg, mesh, cuda_device)
        assert sharded.shadow.tensor.size == 1
        rows, prog = _mesh_windows(cfg, sharded, sharded.shadow, xs, ys,
                                   cuda_device, mesh)
    finally:
        dist.destroy_process_group()
    for a, c in zip(rows, ref_rows):
        assert (a == c).all()
    rec = launches.names(prog.replay_launches)
    assert rec["sharding.all_reduce"] == chip_smoke().tensor_all_reduces(cfg)


# -- the pipeline axis: GPipe stages on the loopback, and the one-card
# pipelined step program --------------------------------------------------


def _pipe_case(cuda_device, dtype, stages, n_micro=None):
    """A small model (fused-route attention, 4 layers) in ``dtype`` on the
    card, one microstep of 8 rows: through ``stages`` loopback stages
    (None: unpipelined, each microbatch's loss backward in turn) in
    ``n_micro`` microbatches. The last stage's ln_f output, the summed
    loss and every parameter gradient."""
    from midgpt_tpu_torch.models.gpt import GPT, pipeline_loss
    from midgpt_tpu_torch.parallel.pipeline import LoopbackPipe
    from midgpt_tpu_torch.train import head_loss

    cfg = ModelConfig(block_size=256, vocab_size=512, n_layer=4, n_head=2,
                      n_embd=256, remat="none")
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device, dtype=dtype)
    toks = torch.randint(0, 512, (8, 257), generator=torch.Generator()
                         .manual_seed(1)).to(cuda_device)
    x, y = toks[:, :-1], toks[:, 1:]
    tail, hs = head_loss(model, 64), []

    def head(h, t):
        hs.append(h.detach())
        return tail(h, t)

    if stages is None:
        bm = 8 // n_micro
        loss = torch.zeros((), device=cuda_device)
        for m in range(n_micro):
            lm = head(model.hidden(x[m * bm:(m + 1) * bm]),
                      y[m * bm:(m + 1) * bm])
            lm.backward()
            loss = loss + lm.detach()
    else:
        model.pipeline = LoopbackPipe(stages)
        loss = pipeline_loss(model, x, y, head, n_micro)
    outs = {"loss": loss, "h": torch.cat(hs)}
    outs.update({"d " + n: p.grad for n, p in model.named_parameters()})
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 4])
def test_loopback_pipeline_holds_to_the_unpipelined_model(cuda_device,
                                                          stages):
    """The GPipe schedule over the model's stages on one card (every
    stage on the loopback, JAX's auto M microbatches), bf16 through the
    fused kernels: the last stage's output, the loss and every gradient
    within twice the unpipelined bf16 run's distance from its f32 run
    (the pipeline phase's rule), in f32 within the flash phases' f32
    rule of the unpipelined f32 run; each microbatch launches the fused
    forward 2 L / S times on a stage before the last (the forward and its
    recompute), L / S on the last, and the backward L / S times."""
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.parallel.pipeline import microbatches

    m = microbatches(8, stages)
    ref32 = _pipe_case(cuda_device, torch.float32, None, m)
    own = _pipe_case(cuda_device, torch.bfloat16, None, m)
    got32 = _pipe_case(cuda_device, torch.float32, stages, m)
    before = (fa.fused_attention_fwd.launches,
              fa.fused_attention_bwd.launches)
    got = _pipe_case(cuda_device, torch.bfloat16, stages, m)
    torch.cuda.synchronize()
    assert (fa.fused_attention_fwd.launches - before[0],
            fa.fused_attention_bwd.launches - before[1]) == (
        m * (2 * 4 - 4 // stages), m * 4)
    for k, r in ref32.items():
        r = r.float()
        limit = 2 * (own[k].float() - r).abs().max().item()
        assert (got[k].float() - r).abs().max().item() <= limit, k
        rel = 1e-4 if k.startswith("d") else 1e-5
        u = max(1.0, r.abs().max().item())
        assert ((got32[k] - r).abs() <= 1e-5 * u + rel * r.abs()).all(), k


def _pipe_program(cuda_device, stages, g):
    """Two windows of a depth-4 step program (CUDA graph) of a small model
    at ``g`` microbatches of 8 / g rows, on one card's loopback of
    ``stages`` stages (1: unpipelined): the stacked rows and the state."""
    from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig
    from midgpt_tpu_torch.parallel import single_device_mesh
    from midgpt_tpu_torch.train import bind_mesh, init_state, make_shadow

    model = ModelConfig(block_size=256, vocab_size=65, n_layer=4, n_head=2,
                        n_embd=128, dropout=0.0, remat="none",
                        attn_impl="auto")
    cfg = ExperimentConfig(model=model, batch_size=8, g_accum_iters=g,
                           warmup_steps=2, lr_decay_steps=20,
                           mesh=MeshConfig(pipeline=stages))
    state = init_state(cfg, cuda_device)
    shadow = make_shadow(state.model, torch.bfloat16)
    bind_mesh(shadow, single_device_mesh(), 0, stages)
    toks = torch.randint(0, 65, (4, 8, 257), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    xs = toks[..., :-1].reshape(4, g, 8 // g, 256)
    ys = toks[..., 1:].reshape(4, g, 8 // g, 256)
    rows, prog = _mesh_windows(cfg, state, shadow, xs, ys, cuda_device)
    return rows, state, prog


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [2, 4])
def test_pipelined_step_program_equals_g_accum_m(cuda_device, stages):
    """One card's trainer at ``pipeline=S`` (every stage on the loopback,
    M = min(2 S, 8) microbatches of 8 / M rows) replays its CUDA graph to
    the unpipelined program's rows at ``g_accum_iters = M`` bit for bit:
    losses, grad norms, lrs, masters and moments."""
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.parallel.pipeline import microbatches

    m = microbatches(8, stages)
    rows, state, prog = _pipe_program(cuda_device, stages, 1)
    ref_rows, ref_state, _ = _pipe_program(cuda_device, 1, m)
    for a, c in zip(rows, ref_rows):
        assert (a == c).all()
    for key in ("params", "mu", "nu"):
        ours, ref = state.items()[key], ref_state.items()[key]
        for n, t in ref.items():
            assert torch.equal(ours[n], t), (key, n)
    assert prog.replay_launches[fa.fused_attention_fwd] == m * (
        2 * 4 - 4 // stages)
    assert prog.replay_launches[fa.fused_attention_bwd] == m * 4


def _two_card_pipe_worker(rank, store, out):
    import dataclasses

    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig
    from midgpt_tpu_torch.parallel import create_mesh
    from midgpt_tpu_torch.train import bind_mesh, init_sharded_state

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                            world_size=2, device_id=dev)
    try:
        cfg, _, _, xs, ys = _program_case(dev, 4, dropout=0.0)
        cfg = dataclasses.replace(cfg, mesh=MeshConfig(fsdp=1, pipeline=2))
        mesh = create_mesh(cfg.mesh)
        state = init_sharded_state(cfg, mesh, dev)
        bind_mesh(state.shadow, mesh, 0)
        rows, _ = _mesh_windows(cfg, state, state.shadow, xs, ys, dev, mesh)
        if rank == 0:
            torch.save(rows, out)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_card_pipeline_program_matches_one(cuda_device, tmp_path):
    """Two NCCL ranks at ``pipeline=2`` (a stage a card, the P2P hand-offs
    captured in the step's graph) on the same batches as the single-card
    program: loss and grad norm within 1e-2 (the stages' M microbatches
    accumulate their bf16 gradients in other sums than the two
    microbatches of one card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL runs one rank a card")
    import torch.multiprocessing as mp

    cfg, state, shadow, xs, ys = _program_case(cuda_device, 4, dropout=0.0)
    ref_rows, _ = _mesh_windows(cfg, state, shadow, xs, ys, cuda_device)
    out = str(tmp_path / "rows.pt")
    mp.spawn(_two_card_pipe_worker, args=(str(tmp_path / "store"), out),
             nprocs=2, join=True)
    rows = torch.load(out, weights_only=False)
    for a, c in zip(rows, ref_rows):
        assert (abs(a[:, :2] - c[:, :2]) <= 1e-2 * abs(c[:, :2])).all(), (
            a, c)


# -- serving under the tensor axis ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 4)],
                         ids=["xl_tp4", "llama_tp4"])
@pytest.mark.parametrize("tt", [None, 5], ids=["decode", "verify"])
def test_paged_kernels_at_tensor_rank_shapes(cuda_device, hkv, g, tt):
    """The paged decode and verify kernels at a tensor rank's heads (C
    128): openwebtext_xl's Hkv 4 at tensor 4, llama_7b's Hkv 2 in groups
    of 4, bf16, held to the plain version in f32."""
    if tt is None:
        args = _inputs(cuda_device, hkv, g, 128, torch.bfloat16)
        got = pa.paged_decode_attention(*args, R - 1, 1)
        ratio = _err_over_tol(got, args, R - 1, 1)
    else:
        args = _verify_inputs(cuda_device, hkv, g, tt, 128, torch.bfloat16)
        got = pa.paged_verify_attention(*args, 1)
        ratio = _verify_err_over_tol(got, args, 1)
    assert (ratio <= 1.0).all(), ratio


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("k,n", [(2048, 1536), (512, 2048), (2048, 12576)],
                         ids=["wqkv_col", "wo_row", "head_col"])
def test_int8_matmul_at_tensor_rank_shapes(cuda_device, m, k, n):
    """The int8 product at a rank's column-parallel (N / 4) and
    row-parallel (K / 4) shapes of openwebtext_xl, bf16 rows, held to the
    plain product in f32 by chip_smoke's rule."""
    from midgpt_tpu_torch.ops.int8_matmul import int8_matmul

    cs = chip_smoke()
    codes, scale = cs.int8_weights(k, n, seed=m + n)
    x = torch.randn(m, k, device=cuda_device, dtype=torch.bfloat16)
    _, ratio = cs.hold_matmul(int8_matmul(x, codes, scale), x, codes, scale)
    assert ratio <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"speculate": 3},
                                {"quant": "int8", "kv_quant": "int8"}],
                         ids=["greedy", "spec", "int8"])
def test_loopback_engine_at_tp2_serves_tp1_streams(cuda_device, kw):
    """A tensor-parallel engine on one card (a loopback mesh of 2) at f32:
    the tp = 1 engine's greedy streams, every virtual rank's paged
    kernels launched (twice tp = 1's launches), the programs replayed as
    CUDA graphs."""
    from midgpt_tpu_torch.parallel.mesh import loopback_mesh

    cfg = ModelConfig(block_size=128, vocab_size=512, n_layer=2, n_head=4,
                      n_embd=256)
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, 512, (n,), generator=gen).numpy()
               for n in (5, 40, 17, 70)]
    runs = []
    for mesh in (None, loopback_mesh(2, cuda_device)):
        eng = ServingEngine(model, slots=2, window=4, page_size=16,
                            device=cuda_device, cache_dtype=torch.float32,
                            mesh=mesh, **kw)
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        rids = [eng.submit(p, 9, seed=i) for i, p in enumerate(prompts)]
        done = eng.run()
        runs.append(([done[r].tokens for r in rids],
                     pa.paged_decode_attention.launches,
                     pa.paged_verify_attention.launches, eng))
    (s1, d1, v1, e1), (s2, d2, v2, e2) = runs
    assert s1 == s2
    assert e2.tp == 2 and e2.graph_captures > 0
    steps = e2.window * (e2.windows - e2.verify_dispatches)
    assert d2 == 2 * cfg.n_layer * steps
    assert v2 == 2 * cfg.n_layer * e2.verify_dispatches
    _pages_home(e2)
