"""Causal GQA flash attention with counter-hash attention dropout: the CUDA
kernels' wrappers, their plain versions, and the autograd entry points.

Counterpart of ``midgpt_tpu.ops.flash``. Layout ``[B, H, T, C]`` for q and
``[B, Hkv, T, C]`` for k and v (GQA maps q head ``h`` to kv head
``h // (H / Hkv)``). The math, shared by the kernels and the plain
versions:

- ``z = (q . k) * (1 / sqrt(C))`` with f32 sums, future columns set to
  -1e30 AFTER the scale (``causal``; local coordinates);
- the forward's ``lse = m + log l`` comes from the UNDROPPED softmax, and
  dropout touches only the value sums: ``out = (softmax(z) * M / keep)
  @ v`` with the probabilities rounded to v's type before PV; ``out`` in
  q's type, ``lse [B, H, T]`` in f32;
- the backward takes ``p = exp(z - lse)``, ``delta = rowsum(dO * O) -
  dlse`` (JAX leaves it to XLA outside its kernels; on the card the dq
  kernel computes it for its q tile and writes it for dk/dv),
  ``dp = dO V^T`` masked and scaled by ``1 / keep``, ``ds = p (dp - delta)
  scale``; ``dq = ds K`` (ds rounded to k's type), per-q-head ``dk = ds^T
  Q`` and ``dv = (p M / keep)^T dO`` (rounded to q's and dO's types), the
  GQA sum over each kv group taken after the kernel.

The keep-mask ``M`` is a counter hash of (seed, flat q head ``bh_off + b
n_head_total + h``, global row ``row_off + i``, global column ``col_off +
j``): keep iff the low 24 bits of a murmur3-style finalizer fall under
``int(keep * 2^24)``. Nothing is stored; every kernel regenerates it. The
JAX package does this in int32 wrapping arithmetic with logical right
shifts; here it is int64 masked to 32 bits, with each multiply split so no
product reaches 2^63 (:func:`dropout_keep_block`,
:func:`dropout_mask_reference`), bit for bit the same mask on the CPU and
the card. The kernels read the seed from device memory (the low 32 bits
of a one-element tensor, :func:`seed_tensor`), so a captured train step
draws each replay's masks from the seed its inputs wrote.

- :func:`flash_forward_reference`, :func:`flash_backward_dq_reference`
  and :func:`flash_backward_dkv_reference` are the plain versions;
  :func:`flash_backward_dkv_staged_reference` is the last in the bf16
  dk/dv kernel's schedule (:func:`dkv_schedule`), tile pair by tile pair.
- :func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` are
  the kernels' wrappers: the plain version for CPU tensors, the
  hand-written kernel (``csrc/flash.cu``: for bf16 the `wgmma` tile cores
  of ``csrc/attn_tiles.cuh``; FMA loops for f32) for CUDA tensors, or an
  error; never a fallback. Each counts its launches in ``.launches``.
  :func:`flash_bwd_dq_delta` is the dq kernel's other entry, which
  computes delta itself and returns it (counted on ``flash_bwd_dq``).
- :func:`flash_attention`, :func:`flash_attention_lse`,
  :func:`flash_attention_dropout` and :func:`flash_attention_dropout_lse`
  are the entry points, all one ``torch.autograd.Function``; lse is
  differentiable (its cotangent folds in as ``delta - dlse``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import torch

from midgpt_tpu_torch.ops import launches

NEG_INF = -1e30
# rows of one q or k tile in the CUDA kernels
TILE = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


class Dropout(tp.NamedTuple):
    """The dropout payload: ``rate`` and the seed, plus the global anchors
    of this call's local (row 0, column 0, flat head 0) and the flat head
    stride ``n_head_total`` (None: the call's own H). The anchors let a
    call over a slice of a larger score matrix (a ring-attention hop, a
    head shard) drop exactly what one call over the whole would.

    The seed is an int or an integer tensor of one element (int32 or
    int64); its low 32 bits key the hash. The kernels read it from device
    memory by pointer (:func:`seed_tensor`), so a captured CUDA graph
    draws the mask of whatever seed its step wrote there."""

    rate: float
    seed: tp.Union[int, torch.Tensor]
    row_off: int = 0
    col_off: int = 0
    bh_off: int = 0
    n_head_total: tp.Optional[int] = None


# -- the counter hash -------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` and ``c <
    2^32``: ``c`` split into 16-bit halves keeps every product below
    2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_finalize(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer on non-negative int64 (the shifts are
    logical because the values are below 2^32)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(keep: float) -> int:
    """The 24-bit keep threshold, ``int(keep * 2^24)`` in Python doubles
    (keep 0.8 -> 13421772), as the JAX package computes it."""
    return int(keep * (1 << 24))


def _keep_mask(seed: tp.Union[int, torch.Tensor], head_ids: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor, keep: float) -> torch.Tensor:
    """Bool ``[*head_ids.shape, len(rows), len(cols)]``: the keep-mask of
    each flat head at global (row, col)."""
    i64 = torch.int64
    if isinstance(seed, torch.Tensor):
        seed = seed.to(i64).reshape(())
    x = (_mul32(rows.to(i64)[:, None] & _M32, 0x9E3779B1)
         + _mul32(cols.to(i64)[None, :] & _M32, 0x85EBCA77)) & _M32
    s = ((seed & _M32) + _mul32(head_ids.to(i64) & _M32, 0xC2B2AE35)) & _M32
    u24 = _hash_finalize(x ^ s[..., None, None]) & 0x00FFFFFF
    return u24 < keep_threshold(keep)


def dropout_keep_block(seed: int, head_id: int, rows0: int, cols0: int,
                       bq: int, bk: int, keep: float,
                       device=None) -> torch.Tensor:
    """``[bq, bk]`` keep-mask of flat head ``head_id`` at rows ``rows0 +
    i``, columns ``cols0 + j`` (the JAX package's
    ``_dropout_keep_block``)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    return _keep_mask(seed, torch.tensor(head_id, device=device),
                      rows0 + ar(bq), cols0 + ar(bk), keep)


def dropout_mask_reference(seed: int, b: int, h: int, t: int, rate: float,
                           device=None, batch_offset: int = 0,
                           head_offset: int = 0,
                           n_head_total: tp.Optional[int] = None
                           ) -> torch.Tensor:
    """``[B, H, T, T]`` keep-mask: the dense evaluation of the hash the
    kernels regenerate tile by tile (the JAX package's
    ``dropout_mask_reference``), batch row ``b`` at global row
    ``batch_offset + b`` and head ``i`` at global head ``head_offset + i``
    of ``n_head_total`` (default ``h``; a tensor shard's heads)."""
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    nh = n_head_total or h
    heads = (batch_offset + ar(b))[:, None] * nh + head_offset + ar(h)
    return _keep_mask(seed, heads, ar(t), ar(t), 1.0 - rate)


def _mask(drop: tp.Optional[Dropout], b: int, h: int, t: int,
          device) -> tp.Optional[torch.Tensor]:
    """The call's ``[B, H, T, T]`` keep-mask at its global anchors, or
    None without dropout."""
    if drop is None:
        return None
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    nh = drop.n_head_total or h
    heads = drop.bh_off + ar(b)[:, None] * nh + ar(h)[None, :]
    return _keep_mask(drop.seed, heads, drop.row_off + ar(t),
                      drop.col_off + ar(t), 1.0 - drop.rate)


# -- plain versions ---------------------------------------------------------


def _geometry(q: torch.Tensor, k: torch.Tensor):
    b, h, t, c = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"n_head {h} not divisible by n_kv_head {hkv}")
    if k.shape[2] != t:
        raise ValueError("self-attention only: q and k must have one T")
    return b, h, hkv, t, c


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked f32 scores ``[B, Hkv, G, T, T]``."""
    b, h, hkv, t, c = _geometry(q, k)
    qg = q.to(torch.float32).reshape(b, hkv, h // hkv, t, c)
    z = (qg @ k.to(torch.float32)[:, :, None].transpose(-1, -2)) * (
        1.0 / math.sqrt(c))
    if causal:
        ii = torch.arange(t, device=q.device)
        z = z.masked_fill(ii[None, :] > ii[:, None], NEG_INF)
    return z


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, H, ...]`` -> ``[B, Hkv, G, ...]``."""
    return x.reshape(x.shape[0], hkv, x.shape[1] // hkv, *x.shape[2:])


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor, taken in f64 and rounded to f32. On the
    CPU, torch's f32 ``exp`` takes another code path for a vector's tail,
    and in some processes, for a call, one intra-op thread's share of the
    tensor comes out with relative errors up to 1.5e-4 (about 13 good
    bits; seen under the test suite's parallel workers), so a plain
    path's values would depend on where each element sits and on that
    thread. In f64 either error is far below an f32 rounding."""
    return torch.exp(x.double()).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``log`` of an f32 tensor through f64, as :func:`exp_f32`."""
    return torch.log(x.double()).float()


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    drop: tp.Optional[Dropout] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``(out [B, H, T, C]`` in q's dtype, ``lse [B, H,
    T]`` f32``)``."""
    b, h, hkv, t, c = _geometry(q, k)
    z = _scores(q, k, causal)
    m = z.amax(-1, keepdim=True)
    p = exp_f32(z - m)
    l = p.sum(-1, keepdim=True)
    mask = _mask(drop, b, h, t, q.device)
    if mask is not None:
        p = torch.where(_grouped(mask, hkv), p * (1.0 / (1.0 - drop.rate)),
                        0.0)
    acc = p.to(v.dtype).to(torch.float32) @ v.to(torch.float32)[:, :, None]
    out = (acc / l).reshape(b, h, t, c).to(q.dtype)
    return out, (m + log_f32(l)).reshape(b, h, t)


def _backward_common(q, k, v, dout, lse, delta, causal, drop):
    """``(p_v, ds, dO)`` in f32, ``[B, Hkv, G, T, T]`` / ``[..., T, C]``:
    the dropped probabilities the dv product reads, ds, and dO grouped."""
    b, h, hkv, t, c = _geometry(q, k)
    f32 = torch.float32
    p = exp_f32(_scores(q, k, causal) - _grouped(lse, hkv)[..., None])
    do = _grouped(dout.to(f32), hkv)
    dp = do @ v.to(f32)[:, :, None].transpose(-1, -2)
    p_v = p
    mask = _mask(drop, b, h, t, q.device)
    if mask is not None:
        mask, inv = _grouped(mask, hkv), 1.0 / (1.0 - drop.rate)
        p_v = torch.where(mask, p * inv, 0.0)
        dp = torch.where(mask, dp * inv, 0.0)
    ds = p * (dp - _grouped(delta, hkv)[..., None]) * (1.0 / math.sqrt(c))
    return p_v, ds, do


def flash_backward_dq_reference(
    q, k, v, dout, lse, delta, causal: bool = True,
    drop: tp.Optional[Dropout] = None,
) -> torch.Tensor:
    """The plain dq: ``[B, H, T, C]`` in q's dtype. ``delta [B, H, T]`` is
    ``rowsum(dO * O) - dlse`` in f32."""
    _, ds, _ = _backward_common(q, k, v, dout, lse, delta, causal, drop)
    dq = ds.to(k.dtype).to(torch.float32) @ k.to(torch.float32)[:, :, None]
    return dq.reshape(q.shape).to(q.dtype)


def flash_backward_dkv_reference(
    q, k, v, dout, lse, delta, causal: bool = True,
    drop: tp.Optional[Dropout] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain per-q-head ``(dk, dv)``, each ``[B, H, T, C]`` in k's and
    v's dtypes (summed over each kv group by the caller)."""
    f32 = torch.float32
    hkv = k.shape[1]
    p_v, ds, do = _backward_common(q, k, v, dout, lse, delta, causal, drop)
    dv = p_v.to(dout.dtype).to(f32).transpose(-1, -2) @ do
    dk = (ds.to(q.dtype).to(f32).transpose(-1, -2)
          @ _grouped(q.to(f32), hkv))
    return dk.reshape(q.shape).to(k.dtype), dv.reshape(q.shape).to(v.dtype)


def dkv_schedule(t: int, causal: bool = True):
    """The bf16 dk/dv kernel's blocks for one (b, head), in launch order,
    each the list of ``(k tile, q tiles it walks)``. Causal: block ``g``
    holds the k tile pair ``(g, nk - 1 - g)`` (the middle tile alone
    where ``nk`` is odd), each k tile walking the q tiles at or after it,
    so every full block has the same ``nk + 1`` tile pairs; non-causal:
    one k tile a block, walking every q tile."""
    nk = t // TILE
    if not causal:
        return [[(j, list(range(nk)))] for j in range(nk)]
    return [[(j, list(range(j, nk))) for j in sorted({g, nk - 1 - g})]
            for g in range((nk + 1) // 2)]


def flash_backward_dkv_staged_reference(
    q, k, v, dout, lse, delta, causal: bool = True,
    drop: tp.Optional[Dropout] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain per-q-head ``(dk, dv)`` in the bf16 kernel's stages, the
    same function as :func:`flash_backward_dkv_reference`: per block of
    :func:`dkv_schedule`, per k tile, per q tile, with rows keys and
    columns q rows: ``S^T = K Q^T scale`` (a key after the q row masked
    on the causal diagonal tile), ``P^T = exp(S^T - lse)``, ``dP^T = V
    dO^T``, the keep-mask and ``1 / keep`` on the P^T that dV reads and on
    dP^T, ``dS^T = P^T (dP^T - delta) scale``; ``dV += P^T dO`` and ``dK
    += dS^T Q`` with P^T and dS^T rounded to dO's and q's dtypes."""
    b, h, hkv, t, c = _geometry(q, k)
    f32 = torch.float32
    scale = 1.0 / math.sqrt(c)
    qf, do = (_grouped(x.to(f32), hkv) for x in (q, dout))
    kf, vf = (x.to(f32)[:, :, None] for x in (k, v))
    ls, dl = (_grouped(x, hkv)[..., None, :] for x in (lse, delta))
    mask = _mask(drop, b, h, t, q.device)
    if mask is not None:
        mask, inv = _grouped(mask, hkv), 1.0 / (1.0 - drop.rate)
    rows = [slice(i * TILE, (i + 1) * TILE) for i in range(t // TILE)]
    after = torch.ones(TILE, TILE, dtype=torch.bool,
                       device=q.device).tril(-1)  # key > q row
    dk, dv = torch.zeros_like(qf), torch.zeros_like(qf)
    for block in dkv_schedule(t, causal):
        for jk, q_tiles in block:
            ks = rows[jk]
            for iq in q_tiles:
                qs = rows[iq]
                st = (kf[..., ks, :] @ qf[..., qs, :].transpose(-1, -2)) * scale
                if causal and iq == jk:
                    st = st.masked_fill(after, NEG_INF)
                pt = exp_f32(st - ls[..., qs])
                dpt = vf[..., ks, :] @ do[..., qs, :].transpose(-1, -2)
                pv = pt
                if mask is not None:
                    keep = mask[..., qs, ks].transpose(-1, -2)
                    pv = torch.where(keep, pt * inv, 0.0)
                    dpt = torch.where(keep, dpt * inv, 0.0)
                dst = pt * (dpt - dl[..., qs]) * scale
                dv[..., ks, :] += pv.to(dout.dtype).to(f32) @ do[..., qs, :]
                dk[..., ks, :] += dst.to(q.dtype).to(f32) @ qf[..., qs, :]
    return dk.reshape(q.shape).to(k.dtype), dv.reshape(q.shape).to(v.dtype)


# -- CUDA kernels -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launchers():
    """The kernels' C entry points, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    lib = load("flash")
    vp, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    # on, seed's address, row/col/bh offsets, n_head_total, threshold,
    # 1/keep, stream
    drop = [i, vp, u, u, u, i, u, f, vp]
    geom = [i] * 7 + [f]  # b, t, h, hkv, c, dtype, causal, scale
    fns = {}
    # pointers: inputs and their strides, then outputs (and lse, delta)
    for name, n_ptr in (("flash_fwd_launch", 6), ("flash_dq_launch", 11),
                        ("flash_dkv_launch", 9)):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = [vp] * n_ptr + geom + drop
        fns[name] = fn
    return fns


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place (unit last
    stride, 16-byte aligned rows and base), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def _check_cuda(q, k, v) -> tp.Tuple[int, int, int, int, int]:
    """What the CUDA kernels take; raises on anything else."""
    b, h, hkv, t, c = _geometry(q, k)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the CUDA kernels take one float32/bfloat16 type "
                         f"for q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if c not in (64, 128):
        raise ValueError(f"the CUDA kernels take C in (64, 128), got {c}")
    if t % TILE:
        raise ValueError(f"T={t} is not a multiple of the {TILE}-row tile")
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != c:
        raise ValueError("k and v must be [B, Hkv, T, C]")
    if len({x.device for x in (q, k, v)}) != 1:
        raise ValueError("q, k and v must be on one device")
    return b, h, hkv, t, c


def _strides(*xs: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


@functools.lru_cache(maxsize=64)
def _int_seed(seed32: int, device: torch.device) -> torch.Tensor:
    # made once, so a launch with an int seed inside a CUDA graph capture
    # finds it on the device (a capture cannot copy from the host)
    return torch.tensor(seed32, dtype=torch.int64, device=device)


def seed_tensor(seed: tp.Union[int, torch.Tensor],
                device) -> torch.Tensor:
    """The seed as the one-element int32/int64 tensor on ``device`` whose
    address the kernels take: a tensor seed itself (checked), an int's low
    32 bits in a tensor made there once."""
    if not isinstance(seed, torch.Tensor):
        return _int_seed(seed & _M32, torch.device(device))
    if (seed.numel() != 1 or seed.dtype not in (torch.int32, torch.int64)
            or seed.device != torch.device(device)):
        raise ValueError(f"a dropout seed tensor must hold one int32/int64 "
                         f"on {device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    return seed


def _drop_args(drop: tp.Optional[Dropout], h: int, device):
    """The launchers' dropout arguments, and the seed tensor the launch
    reads (keep it alive until the launch is queued)."""
    if drop is None:
        return [0, None, 0, 0, 0, h, 0, 1.0], None
    keep = 1.0 - drop.rate
    seed = seed_tensor(drop.seed, device)
    return [1, seed.data_ptr(), drop.row_off & _M32, drop.col_off & _M32,
            drop.bh_off & _M32, drop.n_head_total or h, keep_threshold(keep),
            1.0 / keep], seed


def _launch(name: str, *args) -> None:
    err = _launchers()[name](*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _cuda_or_cpu(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention kernel for device {x.device}")
    return x.device.type == "cuda"


def flash_fwd(q, k, v, causal: bool = True,
              drop: tp.Optional[Dropout] = None):
    """The forward kernel: ``(out, lse)`` as the plain forward's. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if not _cuda_or_cpu(q):
        return flash_forward_reference(q, k, v, causal, drop)
    b, h, hkv, t, c = _check_cuda(q, k, v)
    q, k, v = (_kernel_layout(x) for x in (q, k, v))
    out = torch.empty(b, h, t, c, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    drop_args, _seed = _drop_args(drop, h, q.device)
    _launch("flash_fwd_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _strides(q, k, v), out.data_ptr(), lse.data_ptr(), b, t, h, hkv,
            c, _DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(c),
            *drop_args, torch.cuda.current_stream(q.device).cuda_stream)
    launches.count(flash_fwd)
    return out, lse


flash_fwd.launches = 0


def _check_bwd(q, dout, lse, delta, b, h, t, c):
    if tuple(dout.shape) != (b, h, t, c) or dout.dtype != q.dtype:
        raise ValueError("dout must be [B, H, T, C] in q's dtype")
    for name, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be [B, H, T] float32")


def delta_reference(dout, out, dlse=None) -> torch.Tensor:
    """The plain ``delta = rowsum(dO * O) - dlse``, ``[B, H, T]`` f32."""
    f32 = torch.float32
    delta = (dout.to(f32) * out.to(f32)).sum(-1)
    return delta if dlse is None else delta - dlse.to(f32)


def _dq_launch(q, k, v, dout, lse, delta, out, dlse, causal, drop):
    """One launch of the dq kernel on CUDA tensors: with ``delta`` given it
    reads it; else it computes delta from ``out`` (and ``dlse``) and
    writes it. Returns ``(dq, delta)``."""
    b, h, hkv, t, c = _check_cuda(q, k, v)
    dev = q.device
    written = None
    if delta is None:
        if tuple(out.shape) != (b, h, t, c) or out.dtype != q.dtype or (
                out.device != dev):
            raise ValueError("out must be [B, H, T, C] in q's dtype")
        if dlse is not None:
            if tuple(dlse.shape) != (b, h, t) or dlse.device != dev:
                raise ValueError("dlse must be [B, H, T]")
            dlse = dlse.to(torch.float32).contiguous()
        out = _kernel_layout(out)
        delta = written = torch.empty(b, h, t, dtype=torch.float32,
                                      device=dev)
    _check_bwd(q, dout, lse, delta, b, h, t, c)
    q, k, v, dout = (_kernel_layout(x) for x in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty(b, h, t, c, dtype=q.dtype, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    drop_args, _seed = _drop_args(drop, h, q.device)
    _launch("flash_dq_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), ptr(out),
            _strides(q, k, v, dout, dout if out is None else out),
            lse.data_ptr(), None if written is not None else delta.data_ptr(),
            ptr(dlse), ptr(written), dq.data_ptr(), b, t, h, hkv, c,
            _DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(c),
            *drop_args, torch.cuda.current_stream(dev).cuda_stream)
    launches.count(flash_bwd_dq)
    return dq, delta


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True,
                 drop: tp.Optional[Dropout] = None):
    """The dq kernel given delta: ``dq`` as the plain dq. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if not _cuda_or_cpu(q):
        return flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                           drop)
    return _dq_launch(q, k, v, dout, lse, delta, None, None, causal, drop)[0]


flash_bwd_dq.launches = 0


def flash_bwd_dq_delta(q, k, v, dout, lse, out, dlse=None,
                       causal: bool = True,
                       drop: tp.Optional[Dropout] = None):
    """The dq kernel with delta computed inside: ``(dq, delta)``, delta =
    ``rowsum(dO * O) - dlse`` in f32 ``[B, H, T]``, which the dk/dv launch
    then reads. CPU tensors take the plain versions (:func:`
    delta_reference`, then the plain dq); CUDA tensors one launch of the
    dq kernel (counted in ``flash_bwd_dq.launches``), which runs no other
    operation to form delta."""
    if not _cuda_or_cpu(q):
        delta = delta_reference(dout, out, dlse)
        return flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                           drop), delta
    return _dq_launch(q, k, v, dout, lse, None, out, dlse, causal, drop)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = True,
                  drop: tp.Optional[Dropout] = None):
    """The dk/dv kernel: per-q-head ``(dk, dv)`` as the plain version's.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if not _cuda_or_cpu(q):
        return flash_backward_dkv_reference(q, k, v, dout, lse, delta, causal,
                                            drop)
    b, h, hkv, t, c = _check_cuda(q, k, v)
    _check_bwd(q, dout, lse, delta, b, h, t, c)
    q, k, v, dout = (_kernel_layout(x) for x in (q, k, v, dout))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(b, h, t, c, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    drop_args, _seed = _drop_args(drop, h, q.device)
    _launch("flash_dkv_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), _strides(q, k, v, dout), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, hkv, c,
            _DTYPE_CODES[q.dtype], int(causal), 1.0 / math.sqrt(c),
            *drop_args, torch.cuda.current_stream(q.device).cuda_stream)
    launches.count(flash_bwd_dkv)
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, out, lse, dout, dlse=None, causal: bool = True,
              drop: tp.Optional[Dropout] = None):
    """The whole backward: the dq kernel (which forms ``delta`` on the
    card), the dk/dv kernel reading that delta (or their plain versions,
    delta in PyTorch), then the GQA sum. ``(dq, dk, dv)``."""
    f32 = torch.float32
    dq, delta = flash_bwd_dq_delta(q, k, v, dout, lse, out, dlse, causal,
                                   drop)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, drop)
    hkv = k.shape[1]
    if hkv != q.shape[1]:
        dk = _grouped(dk.to(f32), hkv).sum(2).to(k.dtype)
        dv = _grouped(dv.to(f32), hkv).sum(2).to(v.dtype)
    return dq, dk, dv


# -- entry points -----------------------------------------------------------


class _FlashLSE(torch.autograd.Function):
    """The one VJP pair behind every entry point: ``(out, lse)``, both
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, drop):
        out, lse = flash_fwd(q, k, v, causal, drop)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.drop = causal, drop
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, dlse, ctx.causal,
                               ctx.drop)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = True):
    """``(out [B, H, T, C], lse [B, H, T])``; lse is differentiable."""
    return _FlashLSE.apply(q, k, v, causal, None)


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Flash attention, ``[B, H, T, C]`` in q's dtype."""
    return flash_attention_lse(q, k, v, causal)[0]


def flash_attention_dropout_lse(
    q, k, v, seed: tp.Union[int, torch.Tensor], rate: float, causal: bool = True, row_off: int = 0,
    col_off: int = 0, bh_off: int = 0,
    n_head_total: tp.Optional[int] = None,
):
    """``(out, lse)`` with attention dropout at ``rate`` (the mask of
    ``seed`` at the given global anchors, see :class:`Dropout`)."""
    drop = (None if rate == 0.0 else
            Dropout(rate, seed if isinstance(seed, torch.Tensor)
                    else int(seed), row_off, col_off, bh_off, n_head_total))
    return _FlashLSE.apply(q, k, v, causal, drop)


def flash_attention_dropout(q, k, v, seed: tp.Union[int, torch.Tensor],
                            rate: float, causal: bool = True,
                            bh_off: int = 0) -> torch.Tensor:
    """Flash attention with attention dropout: ``(softmax(z) * M / keep) @
    v`` with ``M`` the counter-hash mask of ``seed`` (flat q head 0 at
    ``bh_off``)."""
    return flash_attention_dropout_lse(q, k, v, seed, rate, causal,
                                       bh_off=bh_off)[0]
