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
gradients ``dwq``, ``dwk``.

- :func:`fused_attention_forward_reference` and
  :func:`fused_attention_backward_reference` are the plain PyTorch
  versions: the formulas above, written out without autograd.
- :func:`fused_attention_reference` is the unfused oracle (LN, RoPE and
  ``ops.attention.naive_attention`` as separate steps), differentiable
  through autograd.
- :func:`fused_attention_qkv` is what the model calls, a
  ``torch.autograd.Function``. For CPU tensors it runs the plain
  versions; for CUDA tensors it launches the hand-written kernels
  (``csrc/fused_attn.cu``: tensor-core tiles for bf16, FMA loops for
  f32) or raises. It never falls back. ``fused_attention_fwd.launches``
  and ``fused_attention_bwd.launches`` count kernel launches.
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
# it the JAX package runs split dq / dkv kernels, not ported yet.
BWD_CAP = {2: 1024, 1: 2048}
# rows of one q or k tile in the CUDA kernels
TILE = 64

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


def _check_bwd_cap(t: int, c: int) -> None:
    if t > bwd_cap(c):
        raise ValueError(
            f"T={t} is above the combined backward's cap {bwd_cap(c)} at "
            f"C={c}; the split dq/dkv kernels come in a later slice")


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


def fused_attention_backward_reference(
    qkv: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
    sin: torch.Tensor, cos: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, n_head: int, n_kv_head: int,
    eps: float = EPS,
) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: ``(dqkv`` in qkv's dtype, ``dwq``, ``dwk`` in
    the weights' dtypes``)``."""
    b, t, c = _geometry(qkv, n_head, n_kv_head)
    h, hkv = n_head, n_kv_head
    groups = h // hkv
    dt, f32 = qkv.dtype, torch.float32
    scale = 1.0 / math.sqrt(c)
    q, k, v = _split(qkv, h, hkv)
    qr, q_xhat, q_rstd = _ln_rope(q, wq, sin, cos, eps)
    kr, k_xhat, k_rstd = _ln_rope(k, wk, sin, cos, eps)
    qh, kh = qr.to(dt), kr.to(dt)
    z = _scores(qh, kh, groups)  # [B, Hkv, G, T, T]
    p = torch.exp(z - lse.reshape(b, hkv, groups, t, 1))
    do = dout.reshape(b, t, h, c).transpose(1, 2).to(f32)
    do = do.reshape(b, hkv, groups, t, c)
    o = out.reshape(b, t, h, c).transpose(1, 2).to(f32)
    delta = (do * o.reshape(b, hkv, groups, t, c)).sum(-1, keepdim=True)
    vf = v.to(f32)[:, :, None]  # [B, Hkv, 1, T, C]
    dv_h = p.to(dt).to(f32).transpose(-1, -2) @ do  # per q head
    dp = do @ vf.transpose(-1, -2)
    ds = (p * (dp - delta) * scale).to(dt).to(f32)
    qf = qh.to(f32).reshape(b, hkv, groups, t, c)
    kf = kh.to(f32)[:, :, None]
    dq_rot = (ds @ kf).reshape(b, h, t, c)
    dk_rot = ds.transpose(-1, -2) @ qf  # [B, Hkv, G, T, C]
    dq, dwq_rows = _ln_rope_bwd(dq_rot, q_xhat, q_rstd, wq, sin, cos)
    dk_h, dwk_rows = _ln_rope_bwd(dk_rot, k_xhat[:, :, None],
                                  k_rstd[:, :, None], wk, sin, cos)
    dk, dv = dk_h.sum(2), dv_h.sum(2)  # per-q-head sums into KV heads

    def packed(x, heads):  # [B, heads, T, C] -> [B, T, heads C]
        return x.transpose(1, 2).reshape(b, t, heads * c)

    dqkv = torch.cat([packed(dq, h), packed(dk, hkv), packed(dv, hkv)],
                     dim=-1).to(dt)
    dwq = dwq_rows.sum((0, 1, 2)).to(wq.dtype)
    dwk = dwk_rows.sum((0, 1, 2, 3)).to(wk.dtype)
    return dqkv, dwq, dwk


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
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    bwd = lib.fused_attn_bwd_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return fwd, bwd


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


def fused_attention_fwd(qkv, wq, wk, sin, cos, n_head, n_kv_head,
                        eps=EPS):
    """The forward kernel: ``(out, lse)`` as the plain forward's. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if qkv.device.type == "cpu":
        return fused_attention_forward_reference(
            qkv, wq, wk, sin, cos, n_head, n_kv_head, eps)
    if qkv.device.type != "cuda":
        raise ValueError(f"no fused attention kernel for device {qkv.device}")
    b, t, c = _check_cuda(qkv, wq, wk, sin, cos, n_head, n_kv_head)
    f32 = torch.float32
    wq32, wk32 = wq.to(f32).contiguous(), wk.to(f32).contiguous()
    sin32, cos32 = sin.to(f32).contiguous(), cos.to(f32).contiguous()
    out = torch.empty(b, t, n_head * c, dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty(b, n_head, t, dtype=f32, device=qkv.device)
    err = _launchers()[0](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, n_head,
        n_kv_head, c, _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(c), eps,
        torch.cuda.current_stream(qkv.device).cuda_stream,
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
    _check_bwd_cap(t, c)
    if (tuple(out.shape) != (b, t, h * c) or tuple(dout.shape) != (b, t, h * c)
            or tuple(lse.shape) != (b, h, t)):
        raise ValueError("out/dout must be [B, T, H C] and lse [B, H, T]")
    if out.dtype != qkv.dtype or dout.dtype != qkv.dtype or (
            lse.dtype != torch.float32):
        raise ValueError("out/dout must share qkv's dtype, lse be float32")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    f32, dev = torch.float32, qkv.device
    wq32, wk32 = wq.to(f32).contiguous(), wk.to(f32).contiguous()
    sin32, cos32 = sin.to(f32).contiguous(), cos.to(f32).contiguous()
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
    dq_acc = torch.empty(b, h, t, c, dtype=f32, device=dev)
    dwq_part = torch.empty(b, h, c, dtype=f32, device=dev)
    dwk_part = torch.empty(b, h, c, dtype=f32, device=dev)
    err = _launchers()[1](
        qkv.data_ptr(), wq32.data_ptr(), wk32.data_ptr(), sin32.data_ptr(),
        cos32.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), dk_h.data_ptr(), dv_h.data_ptr(), dq_acc.data_ptr(),
        dwq_part.data_ptr(), dwk_part.data_ptr(), b, t, h, hkv, c, f,
        kv_stride, _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(c), eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused attention backward launch failed: "
                           f"cudaError {err}")
    fused_attention_bwd.launches += 1
    if h != hkv:
        g = h // hkv
        for src, lo in ((dk_h, h * c), (dv_h, (h + hkv) * c)):
            dqkv[..., lo : lo + hkv * c] = src.reshape(b, t, hkv, g, c).to(
                f32).sum(3).reshape(b, t, hkv * c).to(qkv.dtype)
    # per-(b, head) partials, each summed over T inside the kernel
    dwq = dwq_part.sum((0, 1)).to(wq.dtype)
    dwk = dwk_part.sum((0, 1)).to(wk.dtype)
    return dqkv, dwq, dwk


fused_attention_bwd.launches = 0


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
        dqkv, dwq, dwk = fused_attention_bwd(
            qkv, wq, wk, sin, cos, out, lse, dout.contiguous(), n_head,
            n_kv_head, eps)
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
    H C]``; differentiable in qkv, wq and wk. On the card the combined
    backward takes ``T <= bwd_cap(C)``; a longer sequence raises here,
    before the forward runs."""
    if qkv.device.type == "cuda":
        _check_bwd_cap(qkv.shape[1], _geometry(qkv, n_head, n_kv_head)[2])
    return _FusedAttentionQKV.apply(qkv, wq, wk, sin, cos, n_head,
                                    n_kv_head, eps)
