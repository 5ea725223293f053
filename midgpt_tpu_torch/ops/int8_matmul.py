"""The int8-weight matrix product: the CUDA kernel's wrapper and its plain
version.

``y = (x @ codes) * scale`` with ``x [..., K]`` bf16 or f32, ``codes [K,
N]`` int8 (``QuantLinear``'s ``[in, out]`` layout) and ``scale [N]`` f32,
one per output channel. The JAX package computes it in XLA, which fuses
the int8 convert into the dot (``midgpt_tpu/quant.py`` ``QuantLinear``);
in eager PyTorch ``codes.to(x.dtype)`` would write a full-precision copy
of the weight that the product then reads again.

- :func:`int8_matmul_reference` is the plain version, ``(x @
  codes.to(x.dtype)) * scale.to(y.dtype)``: it rounds the product to x's
  dtype and then multiplies by the scale.
- :func:`int8_matmul` is what ``QuantLinear`` calls. For tensors on the
  CPU it runs the plain version; for CUDA tensors it launches the
  hand-written kernel (``csrc/int8_matmul.cu``), which reads the codes
  and never writes a dequantized weight, or raises. It never falls back.
  ``int8_matmul.launches`` counts kernel launches. The kernel rounds as
  the plain version does (bf16: the sum to bf16, then times the scale
  rounded to bf16; f32: the sum times the scale), so it computes the
  plain version's function for every scale, po2 and absmax alike.

On the card a bf16 call is one launch: (M tile, N tile, K split) blocks
of the instance :func:`plan` picks from M (``mma.sync`` tiles of 16, 32
or 48 rows up to M = 48, a ``wgmma`` tile of 128 rows above), K split
so that every SM streams codes where the tiles alone leave SMs idle; a
tile's splits form one thread block cluster and sum their partials in
order through the cluster's shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM
TILE_K = 64  # csrc/int8_matmul.cu kBK
# mt -> (rows, columns) of a block's output tile: the mma.sync instance's
# 16 mt x kBN, the wgmma instance's kWgBM x kWgBN
TILES = {1: (16, 64), 2: (32, 64), 3: (48, 64), 4: (128, 128)}
MAX_SPLITS = 8  # csrc/int8_matmul.cu kMaxSplits: the portable cluster size
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x: torch.Tensor, codes: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain product, ``[..., N]`` in x's dtype."""
    y = x @ codes.to(x.dtype)
    return y * scale.to(y.dtype)


def split_limits(mt: int, tiles: int, nk: int) -> tp.Tuple[int, int]:
    """The shortest split (K tiles) and the most blocks for instance
    ``mt``: the mma.sync instance (five blocks an SM fit) takes splits of
    2 K tiles within four blocks an SM; the wgmma instance (two fit) of 3
    within two, or of 2 where 3 would leave fewer than half the SMs a
    block. A shorter split spends its time filling the ring and summing
    the cluster (split sweeps over the openwebtext projections at M = 8
    .. 512, H100 SXM)."""
    if mt < 4:
        return 2, 4 * SMS
    least = 3 if tiles * -(-nk // min(nk, 3)) >= SMS // 2 else 2
    return least, 2 * SMS


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int) -> tp.Dict[str, int]:
    """The bf16 kernel's grid for ``[m, k] @ [k, n]``: the instance ``mt``
    (1, 2 or 3: the mma.sync one with 16 ``mt`` rows a tile; 4: the wgmma
    one, 128), the tiles, the K tiles a split and the splits: the fewest
    K tiles a split, at least :func:`split_limits`' shortest, that keep
    the splits within a cluster (``MAX_SPLITS``) and the blocks within
    its cap; where the tiles alone fill the card, no split. (Cached:
    treat the result as read-only.)"""
    mt = 1 if m <= 16 else 2 if m <= 32 else 3 if m <= 48 else 4
    bm, bn = TILES[mt]
    tiles = -(-m // bm) * -(-n // bn)
    nk = -(-k // TILE_K)
    least, cap = split_limits(mt, tiles, nk)
    kps = min(nk, least)
    while kps < nk and (-(-nk // kps) > MAX_SPLITS
                        or tiles * -(-nk // kps) > cap):
        kps += 1
    return {"mt": mt, "tiles": tiles, "k_tiles_per_split": kps,
            "splits": -(-nk // kps)}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    fn = load("int8_matmul").int8_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def _check_cuda(x, codes, scale) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the CUDA kernel takes float32/bfloat16 x, got "
                         f"{x.dtype}")
    if codes.dtype != torch.int8 or codes.dim() != 2:
        raise ValueError(f"codes must be int8 [K, N], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    k, n = codes.shape
    if x.shape[-1] != k or k % 8:
        raise ValueError(f"x [..., {x.shape[-1]}] does not match codes "
                         f"{tuple(codes.shape)}, or K % 8 != 0")
    if tuple(scale.shape) != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be [{n}] float32")
    dev = x.get_device()
    if codes.get_device() != dev or scale.get_device() != dev:
        raise ValueError("x, codes and scale must be on one device")
    if not (codes.is_contiguous() and scale.is_contiguous()
            and codes.data_ptr() % 16 == 0):
        raise ValueError("codes must be contiguous and 16-byte aligned, "
                         "scale contiguous")


def int8_matmul(x: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``(x @ codes) * scale``, ``[..., N]`` in x's dtype. CPU tensors
    take the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, codes, scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for device {x.device}")
    _check_cuda(x, codes, scale)
    k, n = codes.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    m = x2.shape[0]
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, n)
    mt, kps, splits = 0, 1, 1
    if x.dtype == torch.bfloat16:
        p = plan(m, n, k)
        mt, kps, splits = p["mt"], p["k_tiles_per_split"], p["splits"]
    err = _launcher()(
        x2.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
        m, n, k, _DTYPE_CODES[x.dtype], mt, kps, splits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return y.reshape(*lead, n)


int8_matmul.launches = 0
