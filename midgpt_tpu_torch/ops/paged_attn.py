"""Paged decode and verify attention: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``midgpt_tpu.ops.paged_attn.paged_decode_attention`` and
``paged_verify_attention``, float and int8 pools. One decode step's attention for
every slot: each (slot, KV head) attends over the pages its block table
lists, up to its ragged ``pooled_len``, plus the decode window's recent
rows ``0..r``, with one flat f32 softmax over ``[pool | recent]``. A
speculative verify dispatch is the same over ``T`` candidate rows: row
``t`` sees the slot's resident pages (positions ``< start``) and the
candidate rows' own K/V ``0..t``, one flat f32 softmax over
``[pool | self]``.

An int8 pool comes with its per-(page, KV head) po2 scales gathered per
slot, ``scale_k``/``scale_v`` ``[S, Pmax, Hkv]`` f32 (JAX
``_gathered_pool_scales``), and self rows in bf16 (the pool's row dtype).
Pages dequantize as ``f32(code) * scale``, which is exact, so an int8
pool reads like a float pool holding the grid values.

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
- :func:`paged_verify_attention_reference` and
  :func:`paged_verify_attention` are the verify pair, with the same
  decode choreography (``Attention.verify_paged_at``'s XLA branch, not
  the prefill one) and the same rules; the kernel shares the decode
  kernel's body (``csrc/paged_decode.cu``, a second entry point).
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import torch

# Dynamic shared memory one block may ask for on an H100 (227 KB per
# block), less 9 KB kept for the kernel's static shared memory (the value
# pass's partial sums and the reduction scratch).
SMEM_LIMIT = 227 * 1024 - 9 * 1024

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _gathered(pool, scale, idx, layer):
    """The slots' pages through the block table, ``[S, Hkv, C, W]`` in page
    order: in the pool's dtype, or for an int8 pool dequantized in f32
    with each page's scale broadcast over its columns (JAX
    ``_gathered_pool_view``)."""
    pages = pool[layer][idx]  # [S, Pmax, Hkv, C, PS]
    s, pmax, hkv, c, ps = pages.shape
    view = pages.permute(0, 2, 3, 1, 4).reshape(s, hkv, c, pmax * ps)
    if scale is None:
        return view
    scw = scale.permute(0, 2, 1)[:, :, None, :, None].expand(
        s, hkv, 1, pmax, ps).reshape(s, hkv, 1, pmax * ps)
    return view.to(torch.float32) * scw


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
    scale_k: tp.Optional[torch.Tensor] = None,  # [S, Pmax, Hkv] f32 (int8)
    scale_v: tp.Optional[torch.Tensor] = None,
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
    ck = _gathered(pool_k, scale_k, idx, layer)
    cv = _gathered(pool_v, scale_v, idx, layer)
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


def _check(q, pool_k, pool_v, bt, lens, rows_k, rows_v, layer,
           self_rows: int, scale_k, scale_v):
    """What both wrappers need of their inputs. ``q`` is ``[S, Hkv, ...,
    C]``; ``rows_k``/``rows_v`` are the self rows ``[S, Hkv, R, C]`` (the
    decode window's recent rows, or the verify dispatch's candidate rows,
    where ``self_rows`` fixes R; -1 leaves it free). An int8 pool needs
    its gathered scales ``[S, Pmax, Hkv]`` f32 and bf16 self rows; a float
    pool takes no scales and self rows of its own dtype."""
    s, hkv, c = q.shape[0], q.shape[1], q.shape[-1]
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
    if bt.dim() != 2 or bt.shape[0] != s or lens.shape != (s,):
        raise ValueError(
            f"bt {tuple(bt.shape)} / lengths {tuple(lens.shape)} do not "
            f"match {s} slots"
        )
    if rows_k.shape != rows_v.shape or rows_k.dim() != 4 or (
        rows_k.shape[:2] != (s, hkv) or rows_k.shape[3] != c
        or self_rows not in (-1, rows_k.shape[2])
    ):
        r_dim = "R" if self_rows < 0 else self_rows
        raise ValueError(
            f"self rows must be [S, Hkv, R, C] = [{s}, {hkv}, {r_dim}, {c}], "
            f"got {tuple(rows_k.shape)} and {tuple(rows_v.shape)}"
        )
    if not 0 <= layer < nl:
        raise ValueError(f"layer={layer} outside the pool's {nl} layers")
    if bt.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("bt and the lengths must be int32")
    quant = pool_k.dtype == torch.int8
    row_dtype = torch.bfloat16 if quant else pool_k.dtype
    if pool_k.dtype != pool_v.dtype or rows_k.dtype != row_dtype or (
        rows_v.dtype != row_dtype
    ):
        raise ValueError(
            f"pools must share one dtype and the self rows must be "
            f"{row_dtype} for a {pool_k.dtype} pool, got pools "
            f"{pool_k.dtype}/{pool_v.dtype}, rows {rows_k.dtype}/"
            f"{rows_v.dtype}")
    tensors = (q, pool_k, pool_v, bt, lens, rows_k, rows_v)
    if quant != (scale_k is not None) or quant != (scale_v is not None):
        raise ValueError("scale_k and scale_v are given exactly when the "
                         "pool is int8")
    if quant:
        want = (s, bt.shape[1], hkv)
        for sc in (scale_k, scale_v):
            if tuple(sc.shape) != want or sc.dtype != torch.float32:
                raise ValueError(
                    f"scales must be [S, Pmax, Hkv] = {list(want)} f32, got "
                    f"{tuple(sc.shape)} {sc.dtype}")
        tensors += (scale_k, scale_v)
    return tensors
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device")


def _check_kernel(q, pool, tensors, smem: int, geometry: str) -> None:
    """What the CUDA kernel cannot take: it raises, never falls back."""
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention kernel for device {q.device}")
    c = q.shape[-1]
    if c not in (64, 128):
        raise ValueError(f"the CUDA kernel takes C in (64, 128), got {c}")
    if q.dtype not in (torch.float32, torch.bfloat16) or (
            pool.dtype not in _DTYPE_CODES):
        raise ValueError(
            f"the CUDA kernel takes float32/bfloat16 queries and a "
            f"float32/bfloat16/int8 pool, got q {q.dtype}, pool {pool.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"score rows need {smem} bytes of shared memory, above the "
            f"{SMEM_LIMIT}-byte limit a block may use ({geometry}); long "
            f"contexts need another design"
        )


def _ptr(t: tp.Optional[torch.Tensor]) -> tp.Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ints: int):
    """A C entry point of ``csrc/paged_decode.cu``: ten pointers (the last
    two the int8 pool's scales, null for a float pool), ``n_ints`` ints,
    the shared-memory size and the stream. The library is built and
    loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    fn = getattr(load("paged_decode"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * n_ints
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
    scale_k: tp.Optional[torch.Tensor] = None,
    scale_v: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step's paged attention, ``[S, Hkv, G, C]`` in q's dtype.
    CPU tensors take the plain version; CUDA tensors the kernel (its int8
    branch for an int8 pool with its gathered scales)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [S, Hkv, G, C], got {tuple(q.shape)}")
    tensors = _check(q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l, layer,
                     -1, scale_k, scale_v)
    if not 0 <= r < rk_l.shape[2]:
        raise ValueError(f"r={r} outside the {rk_l.shape[2]} recent rows")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, pool_k, pool_v, bt, pooled_len, rk_l, rv_l, r, layer,
            scale_k, scale_v,
        )
    s, hkv, g, c = q.shape
    _, num_pages, _, _, ps = pool_k.shape
    pmax, rr = bt.shape[1], rk_l.shape[2]
    smem = smem_bytes(g, c, pmax, ps, rr)
    _check_kernel(q, pool_k, tensors, smem, f"G={g}, W={pmax * ps}, R={rr}")
    out = torch.empty_like(q)
    err = _entry("paged_decode_attention_launch", 12)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), bt.data_ptr(),
        pooled_len.data_ptr(), rk_l.data_ptr(), rv_l.data_ptr(),
        out.data_ptr(), _ptr(scale_k), _ptr(scale_v),
        s, hkv, g, c, num_pages, ps, pmax, rr, r, layer,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype], smem,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention_reference(
    q: torch.Tensor,  # [S, Hkv, G, T, C] post-norm/rope queries
    kc: torch.Tensor,  # [S, Hkv, T, C] the rows' K, rounded to the pool dtype
    vc: torch.Tensor,  # [S, Hkv, T, C]
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS]
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32 block tables (pads = NP sentinel)
    start: torch.Tensor,  # [S] int32 resident tokens per slot
    layer: int,
    scale_k: tp.Optional[torch.Tensor] = None,  # [S, Pmax, Hkv] f32 (int8)
    scale_v: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:  # [S, Hkv, G, T, C] in q's dtype
    """The verify attention in the decode choreography: f32 upcast before
    the multiply-sums over C, the pool mask (``col < start``) and the
    causal self mask added, then a division by sqrt(C), one flat softmax
    over ``[pool W | self T]``, f32 probabilities through the value sums,
    ``o_pool + o_self``, one cast at the end."""
    s, hkv, g, t, c = q.shape
    num_pages, ps = pool_k.shape[1], pool_k.shape[-1]
    pmax = bt.shape[1]
    w = pmax * ps
    f32 = torch.float32
    idx = bt.long().clamp(0, num_pages - 1)
    ck = _gathered(pool_k, scale_k, idx, layer)
    cv = _gathered(pool_v, scale_v, idx, layer)
    cols = torch.arange(w, device=q.device)
    mask_pool = torch.where(
        cols[None, :] < start[:, None].long(), 0.0, -math.inf
    ).to(f32)[:, None, None, None, :]  # [S, 1, 1, 1, W]
    ii = torch.arange(t, device=q.device)
    mask_self = torch.where(ii[None, :] <= ii[:, None], 0.0,
                            -math.inf).to(f32)  # [T, T]
    s_pool = (q[..., :, None].to(f32)
              * ck[:, :, None, None].to(f32)).sum(-2)  # [S, Hkv, G, T, W]
    s_self = (q[:, :, :, :, None, :].to(f32)
              * kc[:, :, None, None].to(f32)).sum(-1)  # [S, Hkv, G, T, T]
    s_all = torch.cat([s_pool + mask_pool, s_self + mask_self], dim=-1)
    probs = torch.softmax(s_all / math.sqrt(c), dim=-1)
    p_pool, p_self = probs[..., :w], probs[..., w:]
    o_pool = (p_pool[:, :, :, :, None, :]
              * cv[:, :, None, None].to(f32)).sum(-1)  # [S, Hkv, G, T, C]
    o_self = (p_self[..., None] * vc[:, :, None, None].to(f32)).sum(-2)
    return (o_pool + o_self).to(q.dtype)


def verify_smem_bytes(groups: int, t: int, c: int, pmax: int, ps: int) -> int:
    """Dynamic shared memory of one verify block: the kernel's
    ``G * T`` query rows, each with a ``W + T`` score row."""
    return smem_bytes(groups * t, c, pmax, ps, t)


def paged_verify_attention(
    q: torch.Tensor,
    kc: torch.Tensor,
    vc: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    bt: torch.Tensor,
    start: torch.Tensor,
    layer: int,
    scale_k: tp.Optional[torch.Tensor] = None,
    scale_v: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A verify dispatch's paged attention, ``[S, Hkv, G, T, C]`` in q's
    dtype. CPU tensors take the plain version; CUDA tensors the kernel (its
    int8 branch for an int8 pool with its gathered scales)."""
    if q.dim() != 5:
        raise ValueError(f"q must be [S, Hkv, G, T, C], got {tuple(q.shape)}")
    s, hkv, g, t, c = q.shape
    tensors = _check(q, pool_k, pool_v, bt, start, kc, vc, layer, t,
                     scale_k, scale_v)
    if q.device.type == "cpu":
        return paged_verify_attention_reference(
            q, kc, vc, pool_k, pool_v, bt, start, layer, scale_k, scale_v
        )
    _, num_pages, _, _, ps = pool_k.shape
    pmax = bt.shape[1]
    smem = verify_smem_bytes(g, t, c, pmax, ps)
    _check_kernel(q, pool_k, tensors, smem, f"G={g}, T={t}, W={pmax * ps}")
    out = torch.empty_like(q)
    err = _entry("paged_verify_attention_launch", 11)(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), bt.data_ptr(), start.data_ptr(), out.data_ptr(),
        _ptr(scale_k), _ptr(scale_v), s, hkv, g, t, c, num_pages, ps, pmax, layer,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype], smem,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged verify kernel launch failed: cudaError {err}")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
