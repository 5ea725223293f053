"""Fused QK-LayerNorm + RoPE + causal attention from packed qkv: the CUDA
kernels' wrappers and their plain versions.

Counterpart of ``midgpt_tpu.ops.fused_attn`` (``fused_attention_qkv``
and its combined backward). The input is the raw output of the packed
QKV projection, ``qkv [B, T, (H + 2 Hkv) C]``; per head the function
applies a mean-subtracting LayerNorm in f32 (weights ``wq``/``wk``, eps
1e-6), interleaved RoPE in f32 from duplicated-interleaved ``[T, C]``
tables, casts q and k to the input dtype, and attends causally:

- ``z = (q . k) * (1 / sqrt(C))`` with f32 accumulation, future columns
  set to -1e30 (not -inf);
- softmax in f32, probabilities cast to the input dtype before PV;
- ``out [B, T, H C]`` in the input dtype and ``lse [B, H, T]`` in f32.

The backward recomputes LN and RoPE, takes ``p = exp(z - lse)`` and
``delta = rowsum(dO * O)``, forms ``dv = P^T dO``, ``ds = p (dO V^T -
delta) scale`` (cast to the input dtype), ``dq = ds K`` and ``dk = ds^T
Q`` in f32, and then goes back through RoPE and the LayerNorm. It
returns ``dqkv`` (packed like ``qkv``) and the LayerNorm weights'
gradients ``dwq``, ``dwk``. As in the JAX package (``_fused_backward``,
``:620``), the combined single-pass kernel takes ``T <= bwd_cap(C)``;
a longer sequence takes the split route: the pre-pass (q and k through
LN and RoPE once, rounded, and ``delta``), the dq kernel, the dk/dv
kernel (per q head), then the GQA group sum (:func:`takes_split`, the
same rule on the CPU, where the plain versions stand in for the
kernels). The f32 split kernels have no pre-pass: they normalise and
rope in their walks (f32 products), with ``delta`` from PyTorch.

- :func:`fused_attention_forward_reference` and
  :func:`fused_attention_backward_reference` are the plain PyTorch
  versions: the formulas above, written out without autograd;
  :func:`fused_attention_bwd_prep_reference`,
  :func:`fused_attention_bwd_dq_reference` and
  :func:`fused_attention_bwd_dkv_reference` the split route's, the last
  two given ``lse`` and ``delta`` (and, optionally, the pre-pass's q^
  and k^); :func:`fused_attention_forward_staged_reference` the bf16
  forward route in its stages (pre-pass, then the base-2 walk of the
  flash forward's core), :func:`fused_attention_backward_staged_reference`
  and :func:`fused_attention_backward_split_staged_reference` the bf16
  backward routes tile by tile in the kernels' schedules
  (:func:`dq_groups`, :func:`split_schedule`).
- :func:`fused_attention_reference` is the unfused oracle (LN, RoPE and
  ``ops.attention.naive_attention`` as separate steps), differentiable
  through autograd.
- :func:`fused_attention_qkv` is what the model calls, a
  ``torch.autograd.Function``. For CPU tensors it runs the plain
  versions; for CUDA tensors it launches the hand-written kernels
  (``csrc/fused_attn.cu``) or raises. It never falls back. In bf16 every
  route starts with the LN + RoPE pre-pass into q^ and k^ and runs its
  products on `wgmma`: the forward is the flash forward's core, the
  combined backward a tile kernel and a post-pass, the split backward a
  dq kernel and the tile kernel without dQ (the tile cores are shared
  with ``csrc/flash.cu`` through ``csrc/attn_tiles.cuh``). In f32 each
  is one FMA-loop kernel (the split pair two), as the f32 checks need
  f32 products. ``fused_attention_fwd.launches``,
  ``fused_attention_bwd.launches``, ``fused_attention_bwd_prep.launches``,
  ``fused_attention_bwd_dq.launches`` and
  ``fused_attention_bwd_dkv.launches`` count wrapper calls that launch:
  the forward's own pre-pass counts under ``fused_attention_fwd``, not
  ``fused_attention_bwd_prep``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import typing as tp

import torch

NEG_INF = -1e30
EPS = 1e-6
# The combined (single-pass) backward's sequence cap, by heads that share
# one 128-lane block in the JAX package (2 at C=64, 1 at C>=128); above
# it the split dq / dkv kernels run, as in the JAX package.
BWD_CAP = {2: 1024, 1: 2048}
# rows of one q or k tile in the CUDA kernels
TILE = 64
# most dq partial groups of the bf16 combined backward (see dq_groups)
DQ_GROUPS = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(n_head: int, n_kv_head: int, head_dim: int) -> bool:
    """Shapes the fused kernels take; the same matrix as the JAX package's
    so that both packages dispatch alike."""
    if n_head % n_kv_head != 0:
        return False
    if head_dim % 128 == 0:
        return True
    return head_dim == 64 and n_head == n_kv_head and n_head % 2 == 0


def bwd_cap(head_dim: int) -> int:
    """Longest sequence the combined backward takes at this head width."""
    return BWD_CAP[2 if head_dim == 64 else 1]


def dq_groups(t: int) -> int:
    """Groups of k tiles whose dq sums the bf16 combined backward keeps
    apart (one f32 partial each, added in group order afterwards). The k
    tiles pair up as (j, nk - 1 - j), equal causal work, and pair p goes
    to group p % G: G = DQ_GROUPS blocks per (b, head) fill the card at
    the train shape (4 x 96 = 384 blocks on 132 SMs), fewer where T has
    fewer pairs."""
    return min(DQ_GROUPS, (t // TILE + 1) // 2)


def split_schedule(t: int):
    """The bf16 split kernels' blocks for one (b, head), in launch order:
    ``(dq, dkv)``, each a list of blocks and each block the list of tiles
    it walks. A dq block holds one q tile, the late (heavy) ones launched
    first; a dk/dv block holds the k tile pair ``(p, nk - 1 - p)``, equal
    causal work (``nk + 1`` q tiles; the middle tile alone where ``nk`` is
    odd), by the combined tile kernel's rule with one group a pair."""
    nk = t // TILE
    dq = [[i] for i in reversed(range(nk))]
    pairs = (nk + 1) // 2
    dkv = [[j for j in range(g, nk) if min(j, nk - 1 - j) % pairs == g]
           for g in range(pairs)]
    return dq, dkv


def takes_split(t: int, c: int) -> bool:
    """Whether the backward at sequence length ``t`` and head width ``c``
    takes the split dq / dkv pair (JAX ``_fused_backward``'s rule)."""
    return t > bwd_cap(c)


def rope_full_tables(sin: torch.Tensor, cos: torch.Tensor):
    """``[T, C//2]`` tables -> duplicated-interleaved ``[T, C]`` f32."""
    return (torch.repeat_interleave(sin.to(torch.float32), 2, dim=-1),
            torch.repeat_interleave(cos.to(torch.float32), 2, dim=-1))


def _rotate(x: torch.Tensor) -> torch.Tensor:
    """``y[2i] = -x[2i+1], y[2i+1] = x[2i]`` (the JAX package's ``x @ R``,
    bit for bit: each output is one signed input)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def _rotate_t(x: torch.Tensor) -> torch.Tensor:
    """The transpose of :func:`_rotate`: ``y[2i] = x[2i+1], y[2i+1] =
    -x[2i]``."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack((x2, -x1), dim=-1).reshape(x.shape)


def _geometry(qkv: torch.Tensor, n_head: int, n_kv_head: int):
    b, t, f = qkv.shape
    if f % (n_head + 2 * n_kv_head):
        raise ValueError(
            f"qkv width {f} is not (H + 2 Hkv) C for H={n_head}, "
            f"Hkv={n_kv_head}")
    return b, t, f // (n_head + 2 * n_kv_head)


def _split(qkv: torch.Tensor, n_head: int, n_kv_head: int):
    """Raw q ``[B, H, T, C]``, k and v ``[B, Hkv, T, C]`` (views)."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    q = qkv[..., : h * c].reshape(b, t, h, c).transpose(1, 2)
    k = qkv[..., h * c : (h + hkv) * c].reshape(b, t, hkv, c).transpose(1, 2)
    v = qkv[..., (h + hkv) * c :].reshape(b, t, hkv, c).transpose(1, 2)
    return q, k, v


def _ln_rope(x: torch.Tensor, w: torch.Tensor, sin: torch.Tensor,
             cos: torch.Tensor, eps: float):
    """f32 LayerNorm (mean-subtract, weight, no bias) and interleaved RoPE
    of ``x [..., T, C]``. Returns ``(roped, xhat, rstd)``, all f32."""
    x = x.to(torch.float32)
    centered = x - x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(-1, keepdim=True) + eps)
    xhat = centered * rstd
    ln = xhat * w.to(torch.float32)
    return ln * cos + _rotate(ln) * sin, xhat, rstd


def _ln_rope_bwd(d: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                 w: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """Back through RoPE and the LayerNorm, in f32. Returns ``(dx,
    dw_rows)``; ``dw_rows = d_ln * xhat`` is summed over rows by the
    caller."""
    d_ln = d * cos + _rotate_t(d * sin)
    dw_rows = d_ln * xhat
    dxhat = d_ln * w.to(torch.float32)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dw_rows


def _scores(qh: torch.Tensor, kh: torch.Tensor, groups: int) -> torch.Tensor:
    """Scaled, masked f32 scores ``[B, Hkv, G, T, T]`` of the rounded q/k."""
    b, h, t, c = qh.shape
    qg = qh.to(torch.float32).reshape(b, h // groups, groups, t, c)
    z = (qg @ kh.to(torch.float32)[:, :, None].transpose(-1, -2)) * (
        1.0 / math.sqrt(c))
    ii = torch.arange(t, device=qh.device)
    return z.masked_fill(ii[None, :] > ii[:, None], NEG_INF)


def fused_attention_forward_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: ``(out [B, T, H C]`` in qkv's dtype, ``lse
    [B, H, T]`` f32). ``sin``/``cos`` are the ``[T, C]`` f32 tables."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    groups = n_head // n_kv_head
    dt = qkv.dtype
    q, k, v = _split(qkv, n_head, n_kv_head)
    qh = _ln_rope(q, wq, sin, cos, eps)[0].to(dt)
    kh = _ln_rope(k, wk, sin, cos, eps)[0].to(dt)
    z = _scores(qh, kh, groups)
    m = z.amax(-1, keepdim=True)
    p = torch.exp(z - m)
    l = p.sum(-1, keepdim=True)
    acc = p.to(dt).to(torch.float32) @ v.to(torch.float32)[:, :, None]
    out = (acc / l).reshape(b, n_head, t, c).transpose(1, 2)
    lse = (m + torch.log(l)).reshape(b, n_head, t)
    return out.reshape(b, t, n_head * c).to(dt), lse


def fused_attention_forward_staged_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward in the bf16 route's stages, the same function as
    :func:`fused_attention_forward_reference`: the pre-pass (q^ and k^
    through LN and RoPE, rounded to qkv's dtype), then the forward core's
    walk: blocks of two q tiles (128 rows), each q tile an online softmax
    over k tiles ``0..iq`` in base 2 (``log2(e)`` folded into the scale,
    the running max ``m`` in those units, masked scores -1e30), the
    probabilities rounded to qkv's dtype before PV, the output sums
    rescaled per k tile; ``out = o / l``, ``lse = m ln 2 + log l``."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    dt, f32 = qkv.dtype, torch.float32
    qhat, khat, _ = fused_attention_bwd_prep_reference(qkv, wq, wk, sin, cos,
                                                       h, hkv, eps)
    qf = qhat.to(f32).reshape(b, hkv, h // hkv, t, c)
    kf = khat.to(f32)[:, :, None]
    vf = _split(qkv, h, hkv)[2].to(f32)[:, :, None]
    scale2 = math.log2(math.e) / math.sqrt(c)
    nq = t // TILE
    rows = [slice(i * TILE, (i + 1) * TILE) for i in range(nq)]
    future = torch.ones(TILE, TILE, dtype=torch.bool,
                        device=qkv.device).triu(1)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:-1], dtype=f32, device=qkv.device)
    for blk in range((nq + 1) // 2):
        for iq in range(2 * blk, min(2 * blk + 2, nq)):
            qs = rows[iq]
            m = torch.full((*qf.shape[:3], TILE, 1), NEG_INF, dtype=f32,
                           device=qkv.device)
            l = torch.zeros_like(m)
            o = torch.zeros_like(qf[..., qs, :])
            for j in range(iq + 1):
                z = (qf[..., qs, :] @ kf[..., rows[j], :].transpose(-1, -2)
                     ) * scale2
                if j == iq:
                    z = z.masked_fill(future, NEG_INF)
                m_new = torch.maximum(m, z.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(z - m_new)
                l = alpha * l + p.sum(-1, keepdim=True)
                o = o * alpha + p.to(dt).to(f32) @ vf[..., rows[j], :]
                m = m_new
            out[..., qs, :] = o / l
            lse[..., qs] = (m * math.log(2.0) + torch.log(l))[..., 0]
    return (_packed(out.reshape(b, h, t, c)).to(dt),
            lse.reshape(b, h, t))


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    n_head: int) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` per head, ``[B, H, T]`` f32."""
    b, t, _ = out.shape
    prod = dout.to(torch.float32) * out.to(torch.float32)
    return prod.reshape(b, t, n_head, -1).sum(-1).transpose(1, 2)


def _bwd_recompute(qkv, wq, wk, sin, cos, lse, delta, dout, n_head,
                   n_kv_head, eps, qhat=None, khat=None):
    """What every backward recomputes from its inputs: the roped, rounded
    q and k with their LN statistics, ``p`` and ``ds`` ``[B, Hkv, G, T,
    T]`` f32 (ds rounded through the input dtype) and dO ``[B, Hkv, G, T,
    C]`` f32. Given ``qhat`` and ``khat`` (the pre-pass's), they stand for
    the roped, rounded q and k."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    groups = h // hkv
    dt, f32 = qkv.dtype, torch.float32
    q, k, v = _split(qkv, h, hkv)
    qr, q_xhat, q_rstd = _ln_rope(q, wq, sin, cos, eps)
    kr, k_xhat, k_rstd = _ln_rope(k, wk, sin, cos, eps)
    qh = qr.to(dt) if qhat is None else qhat
    kh = kr.to(dt) if khat is None else khat
    z = _scores(qh, kh, groups)  # [B, Hkv, G, T, T]
    p = torch.exp(z - lse.reshape(b, hkv, groups, t, 1))
    do = dout.reshape(b, t, h, c).transpose(1, 2).to(f32)
    do = do.reshape(b, hkv, groups, t, c)
    dp = do @ v.to(f32)[:, :, None].transpose(-1, -2)
    d = delta.reshape(b, hkv, groups, t, 1)
    ds = (p * (dp - d) * (1.0 / math.sqrt(c))).to(dt).to(f32)
    return dict(qh=qh, kh=kh, q_xhat=q_xhat, q_rstd=q_rstd, k_xhat=k_xhat,
                k_rstd=k_rstd, p=p, ds=ds, do=do)


def _packed(x: torch.Tensor) -> torch.Tensor:
    """``[B, heads, T, C]`` -> ``[B, T, heads C]``."""
    b, heads, t, c = x.shape
    return x.transpose(1, 2).reshape(b, t, heads * c)


def fused_attention_bwd_prep_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS, out: tp.Optional[torch.Tensor] = None,
    dout: tp.Optional[torch.Tensor] = None,
):
    """The split route's plain pre-pass: ``(qhat [B, H, T, C], khat [B,
    Hkv, T, C]`` (q and k through LN and RoPE, rounded to qkv's dtype),
    ``delta [B, H, T]`` f32, or None without ``out`` and ``dout``)."""
    q, k, _ = _split(qkv, n_head, n_kv_head)
    qh = _ln_rope(q, wq, sin, cos, eps)[0].to(qkv.dtype).contiguous()
    kh = _ln_rope(k, wk, sin, cos, eps)[0].to(qkv.dtype).contiguous()
    delta = None if out is None else attention_delta(out, dout, n_head)
    return qh, kh, delta


def fused_attention_bwd_dq_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS, qhat: tp.Optional[torch.Tensor] = None,
    khat: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The split backward's plain dq: ``(dq [B, T, H C]`` in qkv's dtype,
    ``dwq`` in wq's dtype``)``; ``qhat``/``khat`` as the pre-pass's."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    r = _bwd_recompute(qkv, wq, wk, sin, cos, lse, delta, dout, n_head,
                       n_kv_head, eps, qhat, khat)
    dq_rot = (r["ds"] @ r["kh"].to(torch.float32)[:, :, None]).reshape(
        b, n_head, t, c)
    dq, dwq_rows = _ln_rope_bwd(dq_rot, r["q_xhat"], r["q_rstd"], wq, sin,
                                cos)
    return _packed(dq).to(qkv.dtype), dwq_rows.sum((0, 1, 2)).to(wq.dtype)


def fused_attention_bwd_dkv_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS, qhat: tp.Optional[torch.Tensor] = None,
    khat: tp.Optional[torch.Tensor] = None,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split backward's plain dk/dv, per q head: ``(dk_h, dv_h [B, T,
    H C]`` in qkv's dtype, ``dwk`` in wk's dtype``)``; ``qhat``/``khat`` as
    the pre-pass's."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    f32 = torch.float32
    r = _bwd_recompute(qkv, wq, wk, sin, cos, lse, delta, dout, n_head,
                       n_kv_head, eps, qhat, khat)
    qf = r["qh"].to(f32).reshape(r["do"].shape)
    dv_h = r["p"].to(qkv.dtype).to(f32).transpose(-1, -2) @ r["do"]
    dk_rot = r["ds"].transpose(-1, -2) @ qf  # [B, Hkv, G, T, C]
    dk_h, dwk_rows = _ln_rope_bwd(dk_rot, r["k_xhat"][:, :, None],
                                  r["k_rstd"][:, :, None], wk, sin, cos)
    dk_h, dv_h = (_packed(x.reshape(b, n_head, t, c)).to(qkv.dtype)
                  for x in (dk_h, dv_h))
    return dk_h, dv_h, dwk_rows.sum((0, 1, 2, 3)).to(wk.dtype)


def _sum_groups(dqkv: torch.Tensor, dk_h: torch.Tensor, dv_h: torch.Tensor,
                n_head: int, n_kv_head: int) -> None:
    """Per-q-head dk/dv ``[B, T, H C]`` summed (in f32) into the KV heads'
    slots of ``dqkv``."""
    b, t, _ = dk_h.shape
    h, hkv = n_head, n_kv_head
    c = dk_h.shape[-1] // h
    for src, lo in ((dk_h, h * c), (dv_h, (h + hkv) * c)):
        dqkv[..., lo : lo + hkv * c] = src.reshape(b, t, hkv, h // hkv, c).to(
            torch.float32).sum(3).reshape(b, t, hkv * c).to(dqkv.dtype)


def fused_attention_backward_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: ``(dqkv`` in qkv's dtype, ``dwq``, ``dwk`` in
    the weights' dtypes``)``. The combined kernel's function: one
    recompute of the scores feeds dq, dk and dv."""
    h, hkv = n_head, n_kv_head
    f32 = torch.float32
    r = _bwd_recompute(qkv, wq, wk, sin, cos, lse,
                       attention_delta(out, dout, h), dout, h, hkv, eps)
    kf = r["kh"].to(f32)[:, :, None]
    qf = r["qh"].to(f32).reshape(r["do"].shape)
    dv_h = r["p"].to(qkv.dtype).to(f32).transpose(-1, -2) @ r["do"]
    dk_rot = r["ds"].transpose(-1, -2) @ qf  # [B, Hkv, G, T, C]
    return _combined_grads(qkv, wq, wk, sin, cos, r, r["ds"] @ kf, dk_rot,
                           dv_h, h, hkv)


def _combined_grads(qkv, wq, wk, sin, cos, r, dq_rot, dk_rot, dv_h, h, hkv):
    """The combined backward's tail: ``dq_rot``, ``dk_rot`` and ``dv_h``
    (``[B, Hkv, G, T, C]`` f32) back through RoPE and the LayerNorm, the
    GQA sums, packed into ``(dqkv, dwq, dwk)``."""
    b, t, c = _geometry(qkv, h, hkv)
    dq, dwq_rows = _ln_rope_bwd(dq_rot.reshape(b, h, t, c), r["q_xhat"],
                                r["q_rstd"], wq, sin, cos)
    dk_h, dwk_rows = _ln_rope_bwd(dk_rot, r["k_xhat"][:, :, None],
                                  r["k_rstd"][:, :, None], wk, sin, cos)
    dk, dv = dk_h.sum(2), dv_h.sum(2)  # per-q-head sums into KV heads
    dqkv = torch.cat([_packed(dq), _packed(dk), _packed(dv)], dim=-1).to(
        qkv.dtype)
    dwq = dwq_rows.sum((0, 1, 2)).to(wq.dtype)
    dwk = dwk_rows.sum((0, 1, 2, 3)).to(wk.dtype)
    return dqkv, dwq, dwk


def fused_attention_backward_staged_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward in the bf16 kernel route's stages, the same
    function as :func:`fused_attention_backward_reference`: the pre-pass
    (q and k through LN and RoPE, rounded; delta), then per group of k
    tiles (:func:`dq_groups`: pairs ``(j, nk - 1 - j)``, pair ``p`` in
    group ``p % G``) each k tile's dK^ and dV over the q tiles at or after
    it and its dQ^ added into the group's own f32 partial, then the
    post-pass: the partials of the groups that reach each q tile (``g <=``
    the tile) summed in group order before RoPE and the LN go backward."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    f32 = torch.float32
    r = _bwd_recompute(qkv, wq, wk, sin, cos, lse,
                       attention_delta(out, dout, h), dout, h, hkv, eps)
    kf = r["kh"].to(f32)[:, :, None]
    qf = r["qh"].to(f32).reshape(r["do"].shape)
    p = r["p"].to(qkv.dtype).to(f32)
    groups, nk = dq_groups(t), t // TILE
    dk_rot, dv_h = torch.zeros_like(qf), torch.zeros_like(qf)
    parts = torch.zeros((groups, *qf.shape), dtype=f32, device=qf.device)
    for g in range(groups):
        for j in range(g, nk):
            if min(j, nk - 1 - j) % groups != g:
                continue
            ks, qs = slice(j * TILE, (j + 1) * TILE), slice(j * TILE, t)
            dv_h[..., ks, :] = p[..., qs, ks].transpose(-1, -2) @ r["do"][
                ..., qs, :]
            dk_rot[..., ks, :] = r["ds"][..., qs, ks].transpose(-1, -2) @ qf[
                ..., qs, :]
            parts[g][..., qs, :] += r["ds"][..., qs, ks] @ kf[..., ks, :]
    dq_rot = torch.zeros_like(qf)
    for i in range(nk):
        rows = slice(i * TILE, (i + 1) * TILE)
        for g in range(min(i + 1, groups)):
            dq_rot[..., rows, :] += parts[g][..., rows, :]
    return _combined_grads(qkv, wq, wk, sin, cos, r, dq_rot, dk_rot, dv_h, h,
                           hkv)


def fused_attention_backward_split_staged_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward in the bf16 split route's stages, the same
    function as :func:`fused_attention_bwd_split`: the pre-pass once (q^
    and k^ rounded to qkv's dtype, delta), then tile pair by tile pair in
    the kernels' schedule (:func:`split_schedule`): each dq block's q
    tiles walk k tiles 0..iq, summing dQ^ = dS K^ in one accumulator;
    each dk/dv block's k tiles walk q tiles j..nk-1, summing dV += P^T dO
    and dK^ += dS^T Q^; P and dS rounded to qkv's dtype before their
    products. Then back through RoPE and the LayerNorm, and the GQA
    sums."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    g = h // hkv
    dt, f32 = qkv.dtype, torch.float32
    scale = 1.0 / math.sqrt(c)
    qhat, khat, delta = fused_attention_bwd_prep_reference(
        qkv, wq, wk, sin, cos, h, hkv, eps, out, dout)
    q, k, v = _split(qkv, h, hkv)
    _, q_xhat, q_rstd = _ln_rope(q, wq, sin, cos, eps)
    _, k_xhat, k_rstd = _ln_rope(k, wk, sin, cos, eps)
    qf = qhat.to(f32).reshape(b, hkv, g, t, c)
    kf, vf = khat.to(f32)[:, :, None], v.to(f32)[:, :, None]
    do = dout.reshape(b, t, h, c).transpose(1, 2).to(f32).reshape(qf.shape)
    ls, dl = (x.reshape(b, hkv, g, t, 1) for x in (lse, delta))
    rows = [slice(i * TILE, (i + 1) * TILE) for i in range(t // TILE)]
    future = torch.ones(TILE, TILE, dtype=torch.bool).triu(1)

    def tile_pair(iq, jk):
        """p (rounded) and ds of q tile iq against k tile jk, q rows first."""
        qs, ks = rows[iq], rows[jk]
        z = (qf[..., qs, :] @ kf[..., ks, :].transpose(-1, -2)) * scale
        if iq == jk:
            z = z.masked_fill(future.to(z.device), NEG_INF)
        p = torch.exp(z - ls[..., qs, :])
        dp = do[..., qs, :] @ vf[..., ks, :].transpose(-1, -2)
        ds = (p * (dp - dl[..., qs, :]) * scale).to(dt).to(f32)
        return p.to(dt).to(f32), ds

    dq_blocks, dkv_blocks = split_schedule(t)
    dq_rot, dk_rot, dv_h = (torch.zeros_like(qf) for _ in range(3))
    for block in dq_blocks:
        for iq in block:
            for jk in range(iq + 1):
                dq_rot[..., rows[iq], :] += tile_pair(iq, jk)[1] @ kf[
                    ..., rows[jk], :]
    for block in dkv_blocks:
        for jk in block:
            for iq in range(jk, len(rows)):
                p, ds = tile_pair(iq, jk)
                dv_h[..., rows[jk], :] += p.transpose(-1, -2) @ do[
                    ..., rows[iq], :]
                dk_rot[..., rows[jk], :] += ds.transpose(-1, -2) @ qf[
                    ..., rows[iq], :]
    r = dict(q_xhat=q_xhat, q_rstd=q_rstd, k_xhat=k_xhat, k_rstd=k_rstd)
    return _combined_grads(qkv, wq, wk, sin, cos, r, dq_rot, dk_rot, dv_h, h,
                           hkv)


def fused_attention_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> torch.Tensor:
    """The unfused oracle: f32 LayerNorm, RoPE, cast, then
    ``naive_attention`` (mask before the scale, f32 softmax), as separate
    autograd-differentiable steps. ``[B, T, H C]`` in qkv's dtype."""
    from midgpt_tpu_torch.ops.attention import naive_attention

    b, t, c = _geometry(qkv, n_head, n_kv_head)
    q, k, v = _split(qkv, n_head, n_kv_head)
    qh = _ln_rope(q, wq, sin, cos, eps)[0].to(qkv.dtype)
    kh = _ln_rope(k, wk, sin, cos, eps)[0].to(qkv.dtype)
    o = naive_attention(qh, kh, v)
    return o.transpose(1, 2).reshape(b, t, n_head * c)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launchers():
    """The kernels' C entry points, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    lib = load("fused_attn")
    fwd = lib.fused_attn_fwd_launch
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    bwd = lib.fused_attn_bwd_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    dq = lib.fused_attn_bwd_dq_launch
    dq.restype = ctypes.c_int
    dq.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    dkv = lib.fused_attn_bwd_dkv_launch
    dkv.restype = ctypes.c_int
    dkv.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    prep = lib.fused_attn_bwd_prep_launch
    prep.restype = ctypes.c_int
    prep.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    return fwd, bwd, dq, dkv, prep


def _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head):
    """What the CUDA kernels take; raises on anything else."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take float32/bfloat16, got "
                         f"{qkv.dtype}")
    if c not in (64, 128):
        raise ValueError(f"the CUDA kernels take C in (64, 128), got {c}")
    if n_head % n_kv_head:
        raise ValueError(f"H={n_head} is not a multiple of Hkv={n_kv_head}")
    if t % TILE:
        raise ValueError(f"T={t} is not a multiple of the {TILE}-row tile")
    if not qkv.is_contiguous():
        raise ValueError("the CUDA kernels need a contiguous qkv")
    if tuple(sin.shape) != (t, c) or tuple(cos.shape) != (t, c):
        raise ValueError(f"rope tables must be [T, C] = [{t}, {c}]")
    if wq.shape != (c,) or wk.shape != (c,):
        raise ValueError(f"LayerNorm weights must be [{c}]")
    tensors = (qkv, wq, wk, sin, cos)
    if len({x.device for x in tensors}) != 1:
        raise ValueError("all inputs must be on one device")
    return b, t, c


def _f32(*tensors):
    """The LN weights and rope tables as the kernels read them: contiguous
    f32."""
    return [x.to(torch.float32).contiguous() for x in tensors]


def fused_attention_fwd(qkv, wq, wk, sin, cos, n_head, n_kv_head,
                        eps=EPS):
    """The forward kernel: ``(out, lse)`` as the plain forward's. CPU
    tensors take the plain version; CUDA tensors the kernel (bf16: the
    forward pre-pass into q^ and k^, then the flash forward's core on
    them, two launches of one C call; f32: one kernel)."""
    if qkv.device.type == "cpu":
        return fused_attention_forward_reference(
            qkv, wq, wk, sin, cos, n_head, n_kv_head, eps)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    f32, dev = torch.float32, qkv.device
    wq32, wk32, sin32, cos32 = _f32(wq, wk, sin, cos)
    out = torch.empty(b, t, n_head * c, dtype=qkv.dtype, device=dev)
    lse = torch.empty(b, n_head, t, dtype=f32, device=dev)
    qhat = khat = None
    if qkv.dtype == torch.bfloat16:
        # scratch of the two-launch route: the pre-pass's q^ and k^
        qhat = torch.empty(b, n_head, t, c, dtype=qkv.dtype, device=dev)
        khat = torch.empty(b, n_kv_head, t, c, dtype=qkv.dtype, device=dev)
    err = _launchers()[0](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), out.data_ptr(), lse.data_ptr(), _ptr(qhat),
        _ptr(khat), b, t, n_head, n_kv_head, c, _DTYPE_CODES[qkv.dtype],
        1.0 / math.sqrt(c), eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention forward launch failed: "
                           f"cudaError {err}")
    fused_attention_fwd.launches += 1
    return out, lse


fused_attention_fwd.launches = 0


def fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout, n_head,
                        n_kv_head, eps=EPS):
    """The combined backward kernel: ``(dqkv, dwq, dwk)`` as the plain
    backward's. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if qkv.device.type == "cpu":
        return fused_attention_backward_reference(
            qkv, wq, wk, sin, cos, out, lse, dout, n_head, n_kv_head, eps)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    if (tuple(out.shape) != (b, t, h * c) or tuple(dout.shape) != (b, t, h * c)
            or tuple(lse.shape) != (b, h, t)):
        raise ValueError("out/dout must be [B, T, H C] and lse [B, H, T]")
    if out.dtype != qkv.dtype or dout.dtype != qkv.dtype or (
            lse.dtype != torch.float32):
        raise ValueError("out/dout must share qkv's dtype, lse be float32")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    f32, dev = torch.float32, qkv.device
    wq32, wk32, sin32, cos32 = _f32(wq, wk, sin, cos)
    f = qkv.shape[-1]
    dqkv = torch.empty_like(qkv)
    if h == hkv:
        # MHA: dk and dv land in their packed slots directly
        dk_h = dqkv[..., h * c :]
        dv_h = dqkv[..., 2 * h * c :]
        kv_stride = f
    else:
        # GQA: per-q-head dk/dv, summed into the KV heads below
        dk_h = torch.empty(b, t, h * c, dtype=qkv.dtype, device=dev)
        dv_h = torch.empty(b, t, h * c, dtype=qkv.dtype, device=dev)
        kv_stride = h * c
    if qkv.dtype == torch.bfloat16:
        # scratch of the three-launch route: q^, k^, delta; dq partials,
        # one per group; dwq per (b, head, q tile), dwk per (b, head, group)
        groups = dq_groups(t)
        qhat = torch.empty(b, h, t, c, dtype=qkv.dtype, device=dev)
        khat = torch.empty(b, hkv, t, c, dtype=qkv.dtype, device=dev)
        delta = torch.empty(b, h, t, dtype=f32, device=dev)
        dq_acc = torch.empty(groups, b, h, t, c, dtype=f32, device=dev)
        dwq_part = torch.empty(b, h, t // TILE, c, dtype=f32, device=dev)
        dwk_part = torch.empty(b, h, groups, c, dtype=f32, device=dev)
        scratch = (qhat.data_ptr(), khat.data_ptr(), delta.data_ptr())
    else:
        groups, scratch = 1, (0, 0, 0)
        dq_acc = torch.empty(b, h, t, c, dtype=f32, device=dev)
        dwq_part = torch.empty(b, h, c, dtype=f32, device=dev)
        dwk_part = torch.empty(b, h, c, dtype=f32, device=dev)
    err = _launchers()[1](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), dk_h.data_ptr(), dv_h.data_ptr(), *scratch,
        dq_acc.data_ptr(), dwq_part.data_ptr(), dwk_part.data_ptr(), b, t, h,
        hkv, c, f, kv_stride, groups, _DTYPE_CODES[qkv.dtype],
        1.0 / math.sqrt(c), eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention backward launch failed: "
                           f"cudaError {err}")
    fused_attention_bwd.launches += 1
    if h != hkv:
        _sum_groups(dqkv, dk_h, dv_h, h, hkv)
    # partials per (b, head) and row block or group, summed in a fixed order
    dwq = dwq_part.flatten(0, -2).sum(0).to(wq.dtype)
    dwk = dwk_part.flatten(0, -2).sum(0).to(wk.dtype)
    return dqkv, dwq, dwk


fused_attention_bwd.launches = 0


def _check_split(qkv, lse, delta, dout, n_head, b, t, c):
    if (tuple(lse.shape) != (b, n_head, t) or tuple(delta.shape) != lse.shape
            or lse.dtype != torch.float32 or delta.dtype != torch.float32):
        raise ValueError("lse and delta must be [B, H, T] float32")
    if tuple(dout.shape) != (b, t, n_head * c) or dout.dtype != qkv.dtype:
        raise ValueError("dout must be [B, T, H C] in qkv's dtype")


def fused_attention_bwd_prep(qkv, wq, wk, sin, cos, n_head, n_kv_head,
                             eps=EPS, out=None, dout=None):
    """The split route's pre-pass kernel (bf16): ``(qhat, khat, delta)`` as
    the plain version's, ``delta`` only where ``out`` and ``dout`` are
    given. CPU tensors take the plain version; bf16 CUDA tensors the
    kernel (the f32 split kernels normalise in their walks and take no
    pre-pass)."""
    if qkv.device.type == "cpu":
        return fused_attention_bwd_prep_reference(
            qkv, wq, wk, sin, cos, n_head, n_kv_head, eps, out, dout)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    h, hkv, dev = n_head, n_kv_head, qkv.device
    if qkv.dtype != torch.bfloat16:
        raise ValueError("the pre-pass kernel takes bfloat16")
    if (out is None) != (dout is None):
        raise ValueError("give both out and dout, or neither")
    delta = None
    if out is not None:
        if (tuple(out.shape) != (b, t, h * c) or out.dtype != qkv.dtype
                or tuple(dout.shape) != out.shape or dout.dtype != qkv.dtype):
            raise ValueError("out/dout must be [B, T, H C] in qkv's dtype")
        out, dout = out.contiguous(), dout.contiguous()
        delta = torch.empty(b, h, t, dtype=torch.float32, device=dev)
    wq32, wk32, sin32, cos32 = _f32(wq, wk, sin, cos)
    qhat = torch.empty(b, h, t, c, dtype=qkv.dtype, device=dev)
    khat = torch.empty(b, hkv, t, c, dtype=qkv.dtype, device=dev)
    err = _launchers()[4](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), _ptr(out), _ptr(dout), qhat.data_ptr(),
        khat.data_ptr(), _ptr(delta), b, t, h, hkv, c, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention pre-pass launch failed: "
                           f"cudaError {err}")
    fused_attention_bwd_prep.launches += 1
    return qhat, khat, delta


fused_attention_bwd_prep.launches = 0


def _ptr(x: tp.Optional[torch.Tensor]):
    """A tensor's address for a kernel, or null for None."""
    return None if x is None else x.data_ptr()


def _hats(qkv, wq, wk, sin, cos, n_head, n_kv_head, eps, qhat, khat):
    """The pre-pass's q^ and k^ for a bf16 split kernel (the pre-pass runs
    here when they are not given; the caller keeps them alive through the
    launch); None for f32."""
    if qkv.dtype != torch.bfloat16:
        return None, None
    if (qhat is None) != (khat is None):
        raise ValueError("give both qhat and khat, or neither")
    if qhat is None:
        qhat, khat, _ = fused_attention_bwd_prep(qkv, wq, wk, sin, cos,
                                                 n_head, n_kv_head, eps)
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    for x, heads in ((qhat, n_head), (khat, n_kv_head)):
        if (tuple(x.shape) != (b, heads, t, c) or x.dtype != qkv.dtype
                or x.device != qkv.device or not x.is_contiguous()):
            raise ValueError("qhat / khat must be contiguous [B, H|Hkv, T, "
                             "C] in qkv's dtype")
    return qhat, khat


def _out_view(out, like: torch.Tensor) -> torch.Tensor:
    """The kernel's ``[B, T, H C]`` destination: ``out`` (a view whose
    rows may be strided, as a slot of dqkv is) or a new tensor."""
    if out is None:
        return torch.empty_like(like)
    if (out.shape != like.shape or out.dtype != like.dtype
            or out.device != like.device or out.stride(-1) != 1
            or out.stride(0) != out.shape[1] * out.stride(1)):
        raise ValueError("out must be [B, T, H C] in qkv's dtype with "
                         "contiguous rows")
    return out


def fused_attention_bwd_dq(qkv, wq, wk, sin, cos, lse, delta, dout, n_head,
                           n_kv_head, eps=EPS, out=None, qhat=None,
                           khat=None):
    """The split backward's dq kernel: ``(dq [B, T, H C], dwq)`` as the
    plain version's, ``dq`` written into ``out`` when given (a view with
    strided rows, such as dqkv's q slot). ``qhat``/``khat``: the
    pre-pass's q^ and k^ (:func:`fused_attention_bwd_prep`); the bf16
    kernel runs the pre-pass itself where they are not given, the f32
    kernel normalises in its walk. CPU tensors take the plain version;
    CUDA tensors the kernel. Any ``T % 64 == 0``."""
    if qkv.device.type == "cpu":
        dq, dwq = fused_attention_bwd_dq_reference(
            qkv, wq, wk, sin, cos, lse, delta, dout, n_head, n_kv_head, eps,
            qhat, khat)
        return (dq if out is None else out.copy_(dq)), dwq
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    _check_split(qkv, lse, delta, dout, n_head, b, t, c)
    f32, dev = torch.float32, qkv.device
    wq32, wk32, sin32, cos32 = _f32(wq, wk, sin, cos)
    lse, delta, dout = lse.contiguous(), delta.contiguous(), dout.contiguous()
    dq = _out_view(out, dout)
    qhat, khat = _hats(qkv, wq, wk, sin, cos, n_head, n_kv_head, eps, qhat,
                       khat)
    dwq_part = torch.empty(b, n_head, t // TILE, c, dtype=f32, device=dev)
    err = _launchers()[2](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
        _ptr(qhat), _ptr(khat), dq.data_ptr(), dwq_part.data_ptr(), b, t,
        n_head, n_kv_head, c, dq.stride(1), _DTYPE_CODES[qkv.dtype],
        1.0 / math.sqrt(c), eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention dq launch failed: "
                           f"cudaError {err}")
    fused_attention_bwd_dq.launches += 1
    # per-(b, head, q tile) partials, summed in a fixed order
    return dq, dwq_part.sum((0, 1, 2)).to(wq.dtype)


fused_attention_bwd_dq.launches = 0


def fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, lse, delta, dout, n_head,
                            n_kv_head, eps=EPS, out=None, qhat=None,
                            khat=None):
    """The split backward's dk/dv kernel, per q head: ``(dk_h, dv_h [B, T,
    H C], dwk)`` as the plain version's, ``dk_h``/``dv_h`` written into
    ``out = (dk, dv)`` when given (views with strided rows: dqkv's k and
    v slots for MHA). ``qhat``/``khat`` as :func:`fused_attention_bwd_dq`'s.
    CPU tensors take the plain version; CUDA tensors the kernel. Any
    ``T % 64 == 0``."""
    if qkv.device.type == "cpu":
        dk_h, dv_h, dwk = fused_attention_bwd_dkv_reference(
            qkv, wq, wk, sin, cos, lse, delta, dout, n_head, n_kv_head, eps,
            qhat, khat)
        if out is not None:
            dk_h, dv_h = out[0].copy_(dk_h), out[1].copy_(dv_h)
        return dk_h, dv_h, dwk
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    _check_split(qkv, lse, delta, dout, n_head, b, t, c)
    f32, dev = torch.float32, qkv.device
    wq32, wk32, sin32, cos32 = _f32(wq, wk, sin, cos)
    lse, delta, dout = lse.contiguous(), delta.contiguous(), dout.contiguous()
    dk_h, dv_h = (_out_view(o, dout)
                  for o in (out if out is not None else (None, None)))
    if dk_h.stride(1) != dv_h.stride(1):
        raise ValueError("dk and dv rows must share one stride")
    qhat, khat = _hats(qkv, wq, wk, sin, cos, n_head, n_kv_head, eps, qhat,
                       khat)
    # LN-weight partials: one per k tile (f32), one per k tile pair (bf16)
    blocks = (len(split_schedule(t)[1]) if qkv.dtype == torch.bfloat16
              else t // TILE)
    dwk_part = torch.empty(b, n_head, blocks, c, dtype=f32, device=dev)
    err = _launchers()[3](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
        _ptr(qhat), _ptr(khat), dk_h.data_ptr(), dv_h.data_ptr(),
        dwk_part.data_ptr(), b, t, n_head, n_kv_head, c, dk_h.stride(1),
        _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(c), eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention dkv launch failed: "
                           f"cudaError {err}")
    fused_attention_bwd_dkv.launches += 1
    return dk_h, dv_h, dwk_part.sum((0, 1, 2)).to(wk.dtype)


fused_attention_bwd_dkv.launches = 0


def fused_attention_bwd_split(qkv, wq, wk, sin, cos, out, lse, dout, n_head,
                              n_kv_head, eps=EPS):
    """The split backward: the pre-pass (q^, k^ and delta), the dq kernel,
    the dk/dv kernel, the GQA group sum; ``(dqkv, dwq, dwk)`` as the
    combined backward's. dq lands in dqkv's q slot, and for MHA dk and dv
    in their slots, straight from the kernels. The f32 kernels normalise
    and rope in their walks, so on the card f32 takes ``delta`` from
    PyTorch and no pre-pass."""
    h, hkv = n_head, n_kv_head
    c = _geometry(qkv, h, hkv)[2]
    if qkv.is_cuda and qkv.dtype == torch.float32:
        qhat = khat = None
        delta = attention_delta(out, dout, h)
    else:
        qhat, khat, delta = fused_attention_bwd_prep(
            qkv, wq, wk, sin, cos, h, hkv, eps, out=out, dout=dout)
    dqkv = torch.empty_like(qkv)
    _, dwq = fused_attention_bwd_dq(qkv, wq, wk, sin, cos, lse, delta, dout,
                                    h, hkv, eps, out=dqkv[..., : h * c],
                                    qhat=qhat, khat=khat)
    slots = (dqkv[..., h * c : 2 * h * c], dqkv[..., 2 * h * c :])
    dk_h, dv_h, dwk = fused_attention_bwd_dkv(
        qkv, wq, wk, sin, cos, lse, delta, dout, h, hkv, eps,
        out=slots if h == hkv else None, qhat=qhat, khat=khat)
    if h != hkv:
        _sum_groups(dqkv, dk_h, dv_h, h, hkv)
    return dqkv, dwq, dwk


class _FusedAttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, wq, wk, sin, cos, n_head, n_kv_head, eps):
        out, lse = fused_attention_fwd(qkv, wq, wk, sin, cos, n_head,
                                       n_kv_head, eps)
        ctx.save_for_backward(qkv, wq, wk, sin, cos, out, lse)
        ctx.heads = (n_head, n_kv_head, eps)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, wq, wk, sin, cos, out, lse = ctx.saved_tensors
        n_head, n_kv_head, eps = ctx.heads
        c = _geometry(qkv, n_head, n_kv_head)[2]
        bwd = (fused_attention_bwd_split if takes_split(qkv.shape[1], c)
               else fused_attention_bwd)
        dqkv, dwq, dwk = bwd(qkv, wq, wk, sin, cos, out, lse,
                             dout.contiguous(), n_head, n_kv_head, eps)
        return dqkv, dwq, dwk, None, None, None, None, None


def fused_attention_qkv(
    qkv: torch.Tensor,  # [B, T, (H + 2 Hkv) C] raw packed projection
    wq: torch.Tensor,  # [C] q-LayerNorm weight
    wk: torch.Tensor,  # [C] k-LayerNorm weight
    sin: torch.Tensor,  # [T, C] duplicated-interleaved f32 table
    cos: torch.Tensor,
    n_head: int,
    n_kv_head: int,
    eps: float = EPS,
) -> torch.Tensor:
    """QK-LayerNorm + RoPE + causal attention from packed qkv, ``[B, T,
    H C]``; differentiable in qkv, wq and wk. The backward takes the
    combined kernel for ``T <= bwd_cap(C)`` and the split pair above it
    (:func:`takes_split`)."""
    return _FusedAttentionQKV.apply(qkv, wq, wk, sin, cos, n_head,
                                    n_kv_head, eps)
