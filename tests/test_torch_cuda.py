"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. ``tests/conftest.py`` imports JAX, so on such a
machine run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held, element by element, to its plain PyTorch version run
in f32 on the same inputs upcast (the plain version upcasts them itself):
within 1e-5 (the two sum in different orders) plus, for a bf16 output,
the one final rounding: half a bf16 ulp, at most 2^-8 of the rounded
value.
"""

import pytest
import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.serving import ServingEngine

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
    wide = torch.full((bt.shape[0], 6250), pk.shape[1], dtype=torch.int32,
                      device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        pa.paged_decode_attention(q, pk, pv, wide, pl, rk, rv, 0, 0)
    assert pa.paged_decode_attention.launches == before


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
