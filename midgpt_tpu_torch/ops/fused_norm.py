"""Fused RMSNorm: the CUDA kernels' wrappers and their plain versions.

Counterpart of ``midgpt_tpu.ops.fused_norm`` (``fused_rms_norm``, its
Pallas forward and backward kernels). Over the last dim of any
``[..., D]`` input, flattened to ``[N, D]``, in f32:

    r  = rsqrt(mean(x^2) + eps)            saved for the backward, [N] f32
    y  = x * r * w                         (w optional), one cast to x's dtype
    g  = dy * w
    dx = r * g - x * r^3 * sum(g * x) / D  one cast to x's dtype
    dw = sum_rows(dy * x * r)              a plain reduction, as JAX does

- :func:`fused_rms_norm_forward_reference` and
  :func:`fused_rms_norm_backward_reference` are the plain PyTorch
  versions of the two kernels.
- :func:`fused_rms_norm_fwd` and :func:`fused_rms_norm_bwd` are the
  kernels' wrappers: for CPU tensors they run the plain versions, for
  CUDA tensors they launch the hand-written kernels
  (``csrc/fused_norm.cu``) or raise; ``.launches`` counts launches.
- :func:`fused_rms_norm` is what the model calls, a
  ``torch.autograd.Function`` over the two.

The JAX kernels pad N to 256-row blocks; the CUDA kernels take any N
(one warp a row) and need only D % 128 == 0, the JAX package's rule.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from midgpt_tpu_torch.ops import launches

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the lane width the JAX kernels need, and the CUDA kernels' 4-value loads
# over a 32-lane warp
D_MULTIPLE = 128


def fused_rms_norm_forward_reference(
    x: torch.Tensor, weight: tp.Optional[torch.Tensor], eps: float
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward over ``x [N, D]``: ``(y`` in x's dtype, ``rstd
    [N]`` f32``)``."""
    xf = x.to(torch.float32)
    r = torch.rsqrt(xf.square().mean(-1) + eps)
    y = xf * r[:, None]
    if weight is not None:
        y = y * weight.to(torch.float32)
    return y.to(x.dtype), r


def fused_rms_norm_backward_reference(
    x: torch.Tensor, weight: tp.Optional[torch.Tensor], rstd: torch.Tensor,
    dy: torch.Tensor,
) -> torch.Tensor:
    """The plain backward's ``dx [N, D]`` in x's dtype."""
    xf, r = x.to(torch.float32), rstd[:, None]
    g = dy.to(torch.float32)
    if weight is not None:
        g = g * weight.to(torch.float32)
    proj = (g * xf).sum(-1, keepdim=True) / x.shape[-1]
    return (r * g - xf * (r * r * r) * proj).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launchers():
    """The kernels' C entry points, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    lib = load("fused_norm")
    fwd = lib.rms_norm_fwd_launch
    fwd.restype = ctypes.c_int
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    bwd = lib.rms_norm_bwd_launch
    bwd.restype = ctypes.c_int
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    return fwd, bwd


def _check_cuda(x: torch.Tensor, weight: tp.Optional[torch.Tensor]):
    """What the CUDA kernels take; raises on anything else. Returns the
    weight as contiguous f32 (or None)."""
    if x.dim() != 2:
        raise ValueError(f"the CUDA kernels take x [N, D], got {x.shape}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take float32/bfloat16, got "
                         f"{x.dtype}")
    if x.shape[1] % D_MULTIPLE:
        raise ValueError(f"the CUDA kernels need D % {D_MULTIPLE} == 0, got "
                         f"D={x.shape[1]}")
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels need a contiguous x")
    if weight is None:
        return None
    if tuple(weight.shape) != (x.shape[1],) or weight.device != x.device:
        raise ValueError(f"weight must be [{x.shape[1]}] on {x.device}")
    return weight.to(torch.float32).contiguous()


def _ptr(t: tp.Optional[torch.Tensor]) -> tp.Optional[int]:
    return None if t is None else t.data_ptr()


def fused_rms_norm_fwd(x: torch.Tensor, weight: tp.Optional[torch.Tensor],
                       eps: float):
    """The forward kernel: ``(y, rstd)`` as the plain forward's. CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return fused_rms_norm_forward_reference(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no fused norm kernel for device {x.device}")
    w32 = _check_cuda(x, weight)
    n, d = x.shape
    y = torch.empty_like(x)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    err = _launchers()[0](
        x.data_ptr(), _ptr(w32), y.data_ptr(), rstd.data_ptr(), n, d,
        _DTYPE_CODES[x.dtype], eps,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused norm forward launch failed: cudaError {err}")
    launches.count(fused_rms_norm_fwd)
    return y, rstd


fused_rms_norm_fwd.launches = 0


def fused_rms_norm_bwd(x: torch.Tensor, weight: tp.Optional[torch.Tensor],
                       rstd: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The backward kernel: ``dx`` as the plain backward's. CPU tensors
    take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return fused_rms_norm_backward_reference(x, weight, rstd, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no fused norm kernel for device {x.device}")
    w32 = _check_cuda(x, weight)
    n, d = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor like x")
    if tuple(rstd.shape) != (n,) or rstd.dtype != torch.float32:
        raise ValueError(f"rstd must be [{n}] float32")
    rstd = rstd.contiguous()
    dx = torch.empty_like(x)
    err = _launchers()[1](
        x.data_ptr(), _ptr(w32), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), n, d, _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused norm backward launch failed: "
                           f"cudaError {err}")
    launches.count(fused_rms_norm_bwd)
    return dx


fused_rms_norm_bwd.launches = 0


class _FusedRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, eps):
        y, rstd = fused_rms_norm_fwd(x2, weight, eps)
        ctx.save_for_backward(x2, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, weight, rstd = ctx.saved_tensors
        dx = fused_rms_norm_bwd(x2, weight, rstd, dy.contiguous())
        dw = None
        if weight is not None and ctx.needs_input_grad[1]:
            # one plain reduction, as the JAX package computes it
            dw = (dy.to(torch.float32) * x2.to(torch.float32)
                  * rstd[:, None]).sum(0).to(weight.dtype)
        return dx, dw, None


def fused_rms_norm(x: torch.Tensor, weight: tp.Optional[torch.Tensor],
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x [..., D]``; ``weight`` ``[D]`` or
    None. Differentiable in x and weight."""
    shape = x.shape
    y = _FusedRMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), weight,
                            eps)
    return y.reshape(shape)
