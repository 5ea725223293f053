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
- :func:`paged_attention_split_reference` is the kernels' plan in plain
  PyTorch, for both entry points: the pages cut into splits of
  :func:`split_pages` pages (a function of the page size alone), each
  split's own softmax state (max, sum, f32 partial values) per query
  row, then a merge in a fixed order: the max over the live splits and
  the visible self rows, the splits folded in ascending order, the self
  rows added, one division, one cast. It is the same function as the
  flat plain versions, summed in another order.

On the card one call is one launch of one kernel: split blocks, the last
of each (slot, KV head) merging; a split block's shared memory
(:func:`smem_bytes`) holds one split's pages, queries and scores, so it
does not grow with the table.
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import torch

# Dynamic shared memory one block may ask for on an H100 (227 KB per
# block); the split kernel has no static shared memory.
SMEM_LIMIT = 227 * 1024
# Tokens of one split of the kernels' plan (csrc/paged_decode.cu
# kSplitTokens): a split is max(1, SPLIT_TOKENS // PS) pages.
SPLIT_TOKENS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


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


def split_pages(ps: int) -> int:
    """Pages of one split: a function of the page size alone, never of the
    query rows, the slots, the heads or the table's length, so decode and
    verify (and any TP degree) cut the same columns at the same places."""
    return max(1, SPLIT_TOKENS // ps)


def smem_bytes(rows: int, c: int, ps: int, itemsize: int, rr: int,
               row_itemsize: int) -> int:
    """Dynamic shared memory of one split block: the split's K and V page
    slabs in the pool's type (``itemsize`` bytes an element), the ``rr``
    self K and V rows in theirs (``row_itemsize``), the ``rows`` query
    rows, their score rows, self-row scores and maxima in f32, and the
    split's page scales and ids. It does not depend on the table's
    length."""
    sp = split_pages(ps)
    return (2 * sp * c * ps * itemsize + 2 * rr * c * row_itemsize
            + 4 * rows * (c + sp * ps + rr + 1) + 12 * sp + 4)


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
    dev = q.get_device()  # -1 on the CPU; an int is cheaper than a device
    if any(t.get_device() != dev for t in tensors):
        raise ValueError("all inputs must be on one device")
    return tensors


@functools.lru_cache(maxsize=256)
def kernel_plan(rows: int, c: int, ps: int, pmax: int,
                pool_dtype: torch.dtype, rr: int) -> tp.Dict[str, int]:
    """The split plan one kernel call runs with (``rr`` self rows): pages
    a split, splits, the split block's shared memory and the f32 scratch
    elements per slot and KV head (partial values ``[NS, rows, C]`` and
    ``(m, l)`` pairs ``[NS, rows]``). Raises ValueError where a split
    block would not fit; nothing in it grows with ``pmax`` but the
    scratch. (Cached: treat the result as read-only.)"""
    if rows < 1 or pmax < 1 or ps < 1 or rr < 1:
        raise ValueError(f"the CUDA kernel takes query rows, self rows and a "
                         f"non-empty table, got rows={rows}, R={rr}, "
                         f"Pmax={pmax}, PS={ps}")
    row_itemsize = 2 if pool_dtype == torch.int8 else _ITEMSIZE[pool_dtype]
    smem = smem_bytes(rows, c, ps, _ITEMSIZE[pool_dtype], rr, row_itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"a split of {split_pages(ps)} pages of {ps} with {rows} query "
            f"rows needs {smem} bytes of shared memory, above the "
            f"{SMEM_LIMIT}-byte limit a block may use")
    ns = -(-pmax // split_pages(ps))  # the kernel's grid depth
    return {"split_pages": split_pages(ps), "splits": ns, "smem": smem,
            "part_o": ns * rows * c, "part_ml": ns * rows * 2}


def _check_kernel(q, pool, tensors, rows: int, pmax: int, rr: int):
    """What the CUDA kernel cannot take: it raises, never falls back.
    Returns the call's :func:`kernel_plan`."""
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
    return kernel_plan(rows, c, pool.shape[-1], pmax, pool.dtype, rr)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` where it starts 16-byte aligned (the kernel copies pages and
    self rows 16 bytes at a time), else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


# per device: the kernel's tickets, int32 zeros that each call leaves zero;
# a buffer outgrown stays allocated, since a captured CUDA graph may hold
# its address
_TICKETS: tp.Dict[int, torch.Tensor] = {}
_OUTGROWN: tp.List[torch.Tensor] = []


def _scratch(q, plan, s: int, hkv: int):
    """The split blocks' f32 outputs, which each (slot, KV head)'s last
    block merges: one buffer, the partial values then the ``(m, l)``
    pairs; and the tickets that choose that block. Returns the buffer
    (keep it alive through the launch) and the three addresses."""
    n_o = s * hkv * plan["part_o"]
    buf = torch.empty(n_o + s * hkv * plan["part_ml"], dtype=torch.float32,
                      device=q.device)
    index = q.get_device()
    tickets = _TICKETS.get(index)
    if tickets is None or tickets.numel() < s * hkv:
        if tickets is not None:
            _OUTGROWN.append(tickets)
        tickets = torch.zeros(max(s * hkv, 1024), dtype=torch.int32,
                              device=q.device)
        _TICKETS[index] = tickets
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n_o, tickets.data_ptr()


def _ptr(t: tp.Optional[torch.Tensor]) -> tp.Optional[int]:
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry(name: str, n_ints: int):
    """A C entry point of ``csrc/paged_decode.cu``: thirteen pointers (the
    int8 pool's scales, null for a float pool, then the two scratch
    buffers and the tickets), ``n_ints`` ints, the shared-memory size and
    the stream. The library is built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    fn = getattr(load("paged_decode"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * n_ints
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
    plan = _check_kernel(q, pool_k, tensors, g, pmax, rr)
    pool_k, pool_v, rk_l, rv_l = (_aligned(x) for x in (pool_k, pool_v, rk_l,
                                                         rv_l))
    out = torch.empty_like(q)
    scratch, part_o, part_ml, tickets = _scratch(q, plan, s, hkv)
    err = _entry("paged_decode_attention_launch", 12)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), bt.data_ptr(),
        pooled_len.data_ptr(), rk_l.data_ptr(), rv_l.data_ptr(),
        out.data_ptr(), _ptr(scale_k), _ptr(scale_v), part_o, part_ml,
        tickets, s, hkv, g, c, num_pages, ps, pmax, rr, r, layer,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype], plan["smem"],
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


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor, taken in f64 and rounded to f32: every
    element gets the same value wherever it sits in a tensor (torch's f32
    ``exp`` on the CPU takes another code path for a vector's tail)."""
    return torch.exp(x.double()).float()


def paged_attention_split_reference(
    q: torch.Tensor,  # decode [S, Hkv, G, C]; verify [S, Hkv, G, T, C]
    rows_k: torch.Tensor,  # [S, Hkv, R, C] self rows (recent / candidate)
    rows_v: torch.Tensor,
    pool_k: torch.Tensor,  # [L, NP, Hkv, C, PS]
    pool_v: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32
    lens: torch.Tensor,  # [S] int32 resident tokens (verify: start)
    layer: int,
    r: tp.Optional[int] = None,  # decode: rows 0..r visible; verify: None
    scale_k: tp.Optional[torch.Tensor] = None,  # [S, Pmax, Hkv] f32 (int8)
    scale_v: tp.Optional[torch.Tensor] = None,
) -> torch.Tensor:  # q's shape and dtype
    """The CUDA kernels' plan in plain PyTorch, f32 stages, for both entry
    points: decode (``r`` given, every query row sees self rows ``0..r``)
    and verify (``r`` None, q ``[S, Hkv, G, T, C]``, row ``t`` sees self
    rows ``0..t``). Per (slot, KV head):

    1. the table's columns cut into splits of :func:`split_pages` pages;
       per split and query row, the scores over its live columns
       (``col < lens``; f32 products summed over C in order, divided by
       sqrt(C)), the split's max ``m_i``, ``l_i = sum exp(z - m_i)`` and
       ``O_i = sum exp(z - m_i) v`` (columns in order); a split with no
       live column adds nothing;
    2. the merge: ``M`` the max over the splits and the visible self rows,
       ``L`` and ``O`` folded over the splits in ascending order (``l_i
       e^(m_i - M)``, ``O_i e^(m_i - M)``), then the self rows added
       (``e^(z_j - M)``, ``e^(z_j - M) v_j``), one division, one cast.

    Every stage is elementwise over the query rows (sums are loops of
    adds, exponents :func:`_exp_f32`), so a row's result depends on that
    row's inputs alone: verify row t equals decode step t bit for bit."""
    verify = r is None
    f32 = torch.float32
    s, hkv, c = q.shape[0], q.shape[1], q.shape[-1]
    num_pages, ps = pool_k.shape[1], pool_k.shape[-1]
    w = bt.shape[1] * ps
    rr = rows_k.shape[2]
    qr = q.to(f32).reshape(s, hkv, -1, c)  # rows g (decode), g T + t (verify)
    nr = qr.shape[2]
    idx = bt.long().clamp(0, num_pages - 1)
    ck = _gathered(pool_k, scale_k, idx, layer).to(f32)  # [S, Hkv, C, W]
    cv = _gathered(pool_v, scale_v, idx, layer).to(f32)
    n = lens.long().clamp(0, w)
    live_col = torch.arange(w, device=q.device)[None, :] < n[:, None]
    root_c = math.sqrt(c)
    zeros = functools.partial(torch.zeros, dtype=f32, device=q.device)

    span = split_pages(ps) * ps
    parts = []  # per split: (m, l, O)
    for c0 in range(0, w, span):
        c1 = min(c0 + span, w)
        acc = zeros(s, hkv, nr, c1 - c0)
        for ch in range(c):
            acc = acc + qr[..., ch, None] * ck[:, :, None, ch, c0:c1]
        valid = live_col[:, None, None, c0:c1]
        z = torch.where(valid, acc / root_c, -math.inf)
        m = z.amax(-1)
        e = torch.where(valid, _exp_f32(z - m[..., None]), 0.0)
        l_i, o_i = zeros(s, hkv, nr), zeros(s, hkv, nr, c)
        for j in range(c1 - c0):
            l_i = l_i + e[..., j]
            o_i = o_i + e[..., j, None] * cv[:, :, None, :, c0 + j]
        parts.append((m, l_i, o_i))

    zs = zeros(s, hkv, nr, rr)
    for ch in range(c):
        zs = zs + qr[..., ch, None] * rows_k[:, :, None, :, ch].to(f32)
    jr = torch.arange(rr, device=q.device)
    if verify:
        t = torch.arange(nr, device=q.device) % q.shape[3]
        vis = jr[None, :] <= t[:, None]  # [rows, R]
    else:
        vis = (jr <= r)[None, :].expand(nr, rr)
    zs = torch.where(vis, zs / root_c, -math.inf)

    big = zs.amax(-1)
    for m, _, _ in parts:
        big = torch.maximum(big, m)
    l_sum, o_sum = zeros(s, hkv, nr), zeros(s, hkv, nr, c)
    for m, l_i, o_i in parts:  # ascending splits; a dead one adds zeros
        wgt = _exp_f32(m - big)
        l_sum = l_sum + l_i * wgt
        o_sum = o_sum + o_i * wgt[..., None]
    for j in range(rr):
        wgt = torch.where(vis[:, j], _exp_f32(zs[..., j] - big), 0.0)
        l_sum = l_sum + wgt
        o_sum = o_sum + wgt[..., None] * rows_v[:, :, None, j, :].to(f32)
    return (o_sum / l_sum[..., None]).to(q.dtype).reshape(q.shape)


def verify_smem_bytes(groups: int, t: int, c: int, ps: int,
                      itemsize: int, row_itemsize: int) -> int:
    """Dynamic shared memory of one verify split block: the kernel's
    ``G * T`` query rows (row ``g T + t``) and ``T`` candidate rows over
    one split's pages."""
    return smem_bytes(groups * t, c, ps, itemsize, t, row_itemsize)


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
    plan = _check_kernel(q, pool_k, tensors, g * t, pmax, t)
    pool_k, pool_v, kc, vc = (_aligned(x) for x in (pool_k, pool_v, kc, vc))
    out = torch.empty_like(q)
    scratch, part_o, part_ml, tickets = _scratch(q, plan, s, hkv)
    err = _entry("paged_verify_attention_launch", 11)(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pool_k.data_ptr(),
        pool_v.data_ptr(), bt.data_ptr(), start.data_ptr(), out.data_ptr(),
        _ptr(scale_k), _ptr(scale_v), part_o, part_ml, tickets,
        s, hkv, g, t, c, num_pages, ps, pmax, layer,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[pool_k.dtype], plan["smem"],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged verify kernel launch failed: cudaError {err}")
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
