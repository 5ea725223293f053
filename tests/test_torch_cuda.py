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
"""

import dataclasses

import pytest
import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.serving import ServingEngine, generate_served

PS, PMAX, R = 16, 8, 4
LENS = [0, 7, 16, 61, PMAX * PS]  # empty, mid-page, page-aligned, full table


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


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
    assert eng.alloc.free_pages == eng.alloc.num_pages


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
    assert eng.alloc.free_pages == eng.alloc.num_pages


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
    assert eng.alloc.free_pages == eng.alloc.num_pages


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
    refuse (T % 128 != 0) takes the flash kernels wherever they tile (T %
    64 == 0) and raises otherwise; it never runs the naive path."""
    from midgpt_tpu_torch.ops import flash as fl

    cfg = ModelConfig(block_size=192, vocab_size=64, n_layer=2, n_head=2,
                      n_embd=128, remat="none", attn_impl="auto")
    model = GPT.init(cfg, torch.Generator().manual_seed(0),
                     device=cuda_device)
    tok = torch.randint(0, 64, (2, 192), device=cuda_device)
    before = fl.flash_fwd.launches
    with torch.no_grad():
        out = model(tok)
    assert fl.flash_fwd.launches == before + cfg.n_layer
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="tile"), torch.no_grad():
        model(tok[:, :96])
    assert fl.flash_fwd.launches == before + cfg.n_layer


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
