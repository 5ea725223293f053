"""Keyed inverted dropout: the residual and embedding dropout of the
training forward, its CUDA kernel's wrapper and its plain version.

``y = keep(i) ? x * (1 / keep) : 0`` over the global index ``i = offset +
(f // inner) * inner_stride + f % inner`` of flat (row-major) element
``f`` of ``x`` (``x`` rows of ``inner`` elements, each a slice of a
global row of ``inner_stride``; both default to the whole of ``x``, so
``i = offset + f``). ``offset`` is 0 but on a data-parallel rank, which
passes its first row's, and a sequence-parallel rank, which adds its
columns' start and passes its ``T / S * D`` and the global ``T * D``: its
elements draw the global batch's masks. The keep-mask is a counter hash
of (site key, ``i``): ``s = lo + hi
* 0xC2B2AE35`` over the key's two 32-bit words, then the attention
kernels' murmur3 finalizer of ``(i * 0x9E3779B1) ^ s``, kept where its low
24 bits fall under ``int(keep * 2^24)`` (:func:`keep_mask_reference`;
``ops.flash`` holds the 32-bit arithmetic in int64 PyTorch ops). The key
is a one-element int64 tensor, read from device memory by the kernel, so
a captured CUDA graph draws each replay's masks from the keys that step
wrote, and the mask is a function of (key, index) alone: a checkpointed
block's recompute and a resumed run draw the masks they drew before.

- :func:`keyed_dropout_reference` is the plain version;
- :func:`keyed_dropout` the wrapper: the plain version for CPU tensors,
  the kernel (``csrc/dropout.cu``) for CUDA tensors, or an error; it
  counts its launches in ``.launches``;
- :func:`dropout` the differentiable entry point: the backward is the
  same function of ``dy`` under the same key (no mask is saved).
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from midgpt_tpu_torch.ops import launches
from midgpt_tpu_torch.ops.flash import _M32, _hash_finalize, _mul32, keep_threshold

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_key(key: torch.Tensor, device) -> torch.Tensor:
    if (key.numel() != 1 or key.dtype != torch.int64
            or key.device != torch.device(device)):
        raise ValueError(f"a dropout key must be one int64 on {device}, got "
                         f"{key.dtype} {tuple(key.shape)} on {key.device}")
    return key


def _rows(n: int, inner: tp.Optional[int],
          inner_stride: tp.Optional[int]) -> tp.Tuple[int, int]:
    """``(inner, inner_stride)`` with their defaults, checked."""
    inner = n if inner is None else int(inner)
    stride = inner if inner_stride is None else int(inner_stride)
    if inner < 1 or n % inner or stride < inner:
        raise ValueError(f"rows of {inner} elements at a stride of {stride} "
                         f"do not tile {n} elements")
    return inner, stride


def keep_mask_reference(key: torch.Tensor, n: int, keep: float,
                        offset: int = 0, inner: tp.Optional[int] = None,
                        inner_stride: tp.Optional[int] = None
                        ) -> torch.Tensor:
    """Bool ``[n]``: the keep-mask of flat elements ``f = 0 .. n - 1`` at
    global index ``offset + (f // inner) * inner_stride + f % inner`` (mod
    2^32; by default ``offset + f``) under ``key`` (a one-element int64
    tensor, the mask on its device)."""
    inner, stride = _rows(n, inner, inner_stride)
    k = key.reshape(())
    s = ((k & _M32) + _mul32((k >> 32) & _M32, 0xC2B2AE35)) & _M32
    f = torch.arange(n, dtype=torch.int64, device=key.device)
    i = (_mul32(f // inner, stride & _M32) + f % inner + offset) & _M32
    u24 = _hash_finalize(_mul32(i, 0x9E3779B1) ^ s) & 0x00FFFFFF
    return u24 < keep_threshold(keep)


def keyed_dropout_reference(x: torch.Tensor, key: torch.Tensor,
                            rate: float, offset: int = 0,
                            inner: tp.Optional[int] = None,
                            inner_stride: tp.Optional[int] = None
                            ) -> torch.Tensor:
    """The plain version: ``x`` with dropped elements 0 and kept ones
    times ``1 / keep``, in x's dtype."""
    keep = 1.0 - rate
    mask = keep_mask_reference(key, x.numel(), keep, offset, inner,
                               inner_stride).reshape(x.shape)
    return torch.where(mask, x * (1.0 / keep), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


@functools.lru_cache(maxsize=None)
def _launcher():
    from midgpt_tpu_torch.ops.build import load

    fn = load("dropout").keyed_dropout_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                   ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    return fn


def keyed_dropout(x: torch.Tensor, key: torch.Tensor,
                  rate: float, offset: int = 0,
                  inner: tp.Optional[int] = None,
                  inner_stride: tp.Optional[int] = None) -> torch.Tensor:
    """The kernel: the plain version's function. CPU tensors take the
    plain version; CUDA tensors the kernel."""
    _check_key(key, x.device)
    if offset < 0:
        raise ValueError(f"a dropout offset is >= 0, got {offset}")
    inner, stride = _rows(x.numel(), inner, inner_stride)
    if x.device.type == "cpu":
        return keyed_dropout_reference(x, key, rate, offset, inner, stride)
    if x.device.type != "cuda":
        raise ValueError(f"no dropout kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the dropout kernel takes float32/bfloat16, got "
                         f"{x.dtype}")
    if not 0 < x.numel() < 1 << 32:
        raise ValueError(f"the dropout kernel takes 1 .. 2^32 - 1 elements, "
                         f"got {x.numel()}")
    x = x.contiguous()
    y = torch.empty_like(x)
    keep = 1.0 - rate
    err = _launcher()(x.data_ptr(), y.data_ptr(), x.numel(), key.data_ptr(),
                      offset, keep_threshold(keep), 1.0 / keep,
                      _DTYPE_CODES[x.dtype], inner, stride,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dropout launch failed: cudaError {err}")
    launches.count(keyed_dropout)
    return y


keyed_dropout.launches = 0


class _KeyedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key, rate, offset, inner, inner_stride):
        # the key rides on ctx, not among the saved tensors: it is a view
        # of the step's key table, and the backward only reads it
        ctx.key, ctx.args = key, (rate, offset, inner, inner_stride)
        return keyed_dropout(x, key, rate, offset, inner, inner_stride)

    @staticmethod
    def backward(ctx, dy):
        return (keyed_dropout(dy, ctx.key, *ctx.args), None, None, None, None,
                None)


def dropout(x: torch.Tensor, key: torch.Tensor, rate: float,
            offset: int = 0, inner: tp.Optional[int] = None,
            inner_stride: tp.Optional[int] = None) -> torch.Tensor:
    """Differentiable keyed dropout of ``x`` at ``rate`` under ``key``,
    element 0 at global index ``offset`` (rows of ``inner`` elements
    ``inner_stride`` apart, as :func:`keep_mask_reference`)."""
    return _KeyedDropout.apply(x, key, rate, offset, inner, inner_stride)
