"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``midgpt_tpu.ops.paged_attn.paged_decode_attention``
(float pools). One decode step's attention for every slot: each
(slot, KV head) attends over the pages its block table lists, up to its
ragged ``pooled_len``, plus the decode window's recent rows ``0..r``,
with one flat f32 softmax over ``[pool | recent]``.

- :func:`paged_decode_attention_reference` is the plain PyTorch version.
  It mirrors the JAX decode choreography op for op
  (``models/gpt.py`` ``Attention.decode_paged_at``): gather the slot's
  pages through the block table (pad ids clipped, then masked), f32
  upcast multiply-sums, the additive mask, then a division by sqrt(C),
  f32 probabilities through the value sums, one cast at the end.
- :func:`paged_decode_attention` is what the model calls. For tensors on
  the CPU it runs the plain version; for CUDA tensors it launches the
  hand-written kernel (``csrc/paged_decode.cu``) or raises. It never
  falls back. ``paged_decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

# Dynamic shared memory one block may ask for on an H100 (227 KB per
# block), less 9 KB kept for the kernel's static shared memory (the value
# pass's partial sums and the reduction scratch).
SMEM_LIMIT = 227 * 1024 - 9 * 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention_reference(
    q: torch.Tensor,  # [S, Hkv, G, C] post-norm/rope queries, compute dtype
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS]
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32 block tables (pads = NP sentinel)
    pooled_len: torch.Tensor,  # [S] int32 resident tokens per slot
    rk_l: torch.Tensor,  # [S, Hkv, R, C] recent K rows of this layer
    rv_l: torch.Tensor,
    r: int,  # step index within the window; rows 0..r are valid
    layer: int,
) -> torch.Tensor:  # [S, Hkv, G, C] in q's dtype
    s, hkv, g, c = q.shape
    num_pages, ps = pool_k.shape[1], pool_k.shape[-1]
    pmax = bt.shape[1]
    w = pmax * ps
    rr = rk_l.shape[2]
    f32 = torch.float32
    # the block-table gather, pads clipped into range (their columns are
    # masked below, and clipped pages hold finite values)
    idx = bt.long().clamp(0, num_pages - 1)

    def gathered(pool):  # -> [S, Hkv, C, W] in page order
        pages = pool[layer][idx]  # [S, Pmax, Hkv, C, PS]
        return pages.permute(0, 2, 3, 1, 4).reshape(s, hkv, c, w)

    ck, cv = gathered(pool_k), gathered(pool_v)
    cols = torch.arange(w, device=q.device)
    mask_pool = torch.where(
        cols[None, :] < pooled_len[:, None].long(), 0.0, -math.inf
    ).to(f32)  # [S, W]
    ridx = torch.arange(rr, device=q.device)
    mask_rec = torch.where(ridx <= r, 0.0, -math.inf).to(f32)  # [R]
    qg = q.reshape(s, hkv, g, 1, c)
    qcw = qg.transpose(-1, -2)  # [S, Hkv, G, C, 1]
    s_pool = (qcw.to(f32) * ck[:, :, None].to(f32)).sum(-2)  # [S, Hkv, G, W]
    s_rec = (qg.to(f32) * rk_l[:, :, None].to(f32)).sum(-1)  # [S, Hkv, G, R]
    s_all = torch.cat(
        [s_pool + mask_pool[:, None, None, :], s_rec + mask_rec], dim=-1
    )
    probs = torch.softmax(s_all / math.sqrt(c), dim=-1)
    p_pool, p_rec = probs[..., :w], probs[..., w:]
    o_pool = (p_pool[:, :, :, None, :] * cv[:, :, None].to(f32)).sum(-1)
    o_rec = (p_rec[..., None] * rv_l[:, :, None].to(f32)).sum(-2)
    return (o_pool + o_rec).to(q.dtype)


def smem_bytes(groups: int, c: int, pmax: int, ps: int, rr: int) -> int:
    """Dynamic shared memory of one kernel block: the queries and the
    ``[G, W + R]`` score rows in f32, plus the staged block-table row."""
    return 4 * (groups * c + groups * (pmax * ps + rr)) + 4 * pmax


def _check(q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l, r, layer):
    s, hkv, g, c = q.shape
    if pool_k.dim() != 5 or pool_k.shape != pool_v.shape:
        raise ValueError(
            f"pools must be [L, NP, Hkv, C, PS] and equal, got "
            f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}"
        )
    nl, _, p_hkv, p_c, _ = pool_k.shape
    if (p_hkv, p_c) != (hkv, c):
        raise ValueError(
            f"q {tuple(q.shape)} does not match pool {tuple(pool_k.shape)}"
        )
    if bt.dim() != 2 or bt.shape[0] != s or pooled_len.shape != (s,):
        raise ValueError(
            f"bt {tuple(bt.shape)} / pooled_len {tuple(pooled_len.shape)} "
            f"do not match {s} slots"
        )
    if rk_l.shape != rv_l.shape or rk_l.shape[:2] != (s, hkv) or (
        rk_l.dim() != 4 or rk_l.shape[3] != c
    ):
        raise ValueError(
            f"recent rows must be [S, Hkv, R, C] = [{s}, {hkv}, R, {c}], "
            f"got {tuple(rk_l.shape)} and {tuple(rv_l.shape)}"
        )
    if not 0 <= r < rk_l.shape[2]:
        raise ValueError(f"r={r} outside the {rk_l.shape[2]} recent rows")
    if not 0 <= layer < nl:
        raise ValueError(f"layer={layer} outside the pool's {nl} layers")
    if bt.dtype != torch.int32 or pooled_len.dtype != torch.int32:
        raise ValueError("bt and pooled_len must be int32")
    if pool_k.dtype != pool_v.dtype or rk_l.dtype != pool_k.dtype or (
        rv_l.dtype != pool_k.dtype
    ):
        raise ValueError("pools and recent rows must share one dtype")
    tensors = (q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    fn = load("paged_decode").paged_decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
        + [ctypes.c_longlong, ctypes.c_void_p]
    )
    return fn


def paged_decode_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    bt: torch.Tensor,
    pooled_len: torch.Tensor,
    rk_l: torch.Tensor,
    rv_l: torch.Tensor,
    r: int,
    layer: int,
) -> torch.Tensor:
    """One decode step's paged attention, ``[S, Hkv, G, C]`` in q's dtype.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l, r, layer)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l, r, layer
        )
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    s, hkv, g, c = q.shape
    _, num_pages, _, _, ps = pool_k.shape
    pmax, rr = bt.shape[1], rk_l.shape[2]
    if c not in (64, 128):
        raise ValueError(f"the CUDA kernel takes C in (64, 128), got {c}")
    if q.dtype not in _DTYPE_CODES or pool_k.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the CUDA kernel takes float32/bfloat16, got q {q.dtype}, "
            f"pool {pool_k.dtype}"
        )
    tensors = (q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    smem = smem_bytes(g, c, pmax, ps, rr)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"score rows need {smem} bytes of shared memory, above the "
            f"{SMEM_LIMIT}-byte limit a block may use (G={g}, "
            f"W={pmax * ps}, R={rr}); long contexts need another design"
        )
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), bt.data_ptr(),
        pooled_len.data_ptr(), rk_l.data_ptr(), rv_l.data_ptr(),
        out.data_ptr(), s, hkv, g, c, num_pages, ps, pmax, rr, r, layer,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype], smem,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
