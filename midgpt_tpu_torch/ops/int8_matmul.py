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

On the card a bf16 call is one launch of the instance :func:`plan` picks
from M: a streaming GEMV up to M = 48 (``mma.sync`` with the codes as the
A operand and x's rows on the n8 side, four warps a tile on their own K
steps), a ``wgmma`` tile of 128 rows above (the codes as the register
operand); both convert the codes in registers. The grid is sized to the
card: a tile's K is split over a thread block cluster (summed in order
through the cluster's shared memory) only where the tiles alone leave
SMs idle, and the blocks past what the card holds at once loop over
tiles instead of running a second wave.
"""

from __future__ import annotations

import ctypes
import functools
import typing as tp

import torch

from midgpt_tpu_torch.ops import launches

SMS = 132  # streaming multiprocessors of an H100 SXM
GEMV_MAX_ROWS = 48  # M up to this takes the GEMV
WGMMA = 16  # the wgmma instance's ``mt``: its 128 rows are 16 m8 tiles
# mt -> (rows, columns) of a block's output tile: the GEMV's 8 mt rows
# of Gv<MT>::kCols, the wgmma instance's kWgBM x kWgBN
TILES = {**{mt: (8 * mt, 64) for mt in range(1, 7)}, WGMMA: (128, 128)}
# K rows a step (the unit of a split): a GEMV warp's ring step, a wgmma
# ring stage
STEP = {**{mt: 16 for mt in range(1, 7)}, WGMMA: 64}
# blocks an SM holds at once (shared memory, csrc/int8_matmul.cu
# Gv<MT>::kSmem and kWgSmem): the blocks that loop over the tiles, and
# the cap on split blocks
BLOCKS_PER_SM = {1: 3, 2: 3, 3: 2, 4: 2, 5: 2, 6: 2, WGMMA: 2}
MAX_SPLITS = 8  # csrc/int8_matmul.cu kMaxSplits: the portable cluster size
# K splits (split sweeps over the openwebtext projections at M = 8, 16, 40
# and 512 on an H100 SXM): the most that keep tiles x splits within
# GEMV_BLOCKS (more clusters than the card places at once run in waves)
# or, for the wgmma instance, within WGMMA_BLOCKS with WGMMA_MIN_STEPS K
# tiles a split at least
GEMV_BLOCKS = 224
WGMMA_BLOCKS = 100
WGMMA_MIN_STEPS = 3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x: torch.Tensor, codes: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain product, ``[..., N]`` in x's dtype."""
    y = x @ codes.to(x.dtype)
    return y * scale.to(y.dtype)


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int) -> tp.Dict[str, int]:
    """The bf16 kernel's grid for ``[m, k] @ [k, n]``, without a card: the
    instance ``mt`` (1 .. 6: the GEMV with ``mt`` m8 tiles of rows; 16:
    the wgmma one), its ``tiles``, the K ``steps_per_split`` (``STEP``
    rows each) and ``splits``, and the ``blocks`` along x, each taking
    tiles ``b``, ``b + blocks``, ... K is split (see ``MAX_SPLITS``) only
    while the split blocks fit the card at once (``BLOCKS_PER_SM``);
    then every tile has its own block. Otherwise the blocks are the
    tiles, or the resident blocks where there are more tiles. (Cached:
    treat the result as read-only.)"""
    mt = -(-m // 8) if m <= GEMV_MAX_ROWS else WGMMA
    bm, bn = TILES[mt]
    tiles = -(-m // bm) * -(-n // bn)
    nk = -(-k // STEP[mt])
    cap = BLOCKS_PER_SM[mt] * SMS
    if mt == WGMMA:
        want = min(WGMMA_BLOCKS // tiles, nk // WGMMA_MIN_STEPS)
    else:
        want = GEMV_BLOCKS // tiles
    splits = max(1, min(MAX_SPLITS, want, cap // tiles))
    steps = -(-nk // splits)
    splits = -(-nk // steps)
    return {"mt": mt, "tiles": tiles, "steps_per_split": steps,
            "splits": splits, "blocks": min(tiles, cap // splits)}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and loaded at first use."""
    from midgpt_tpu_torch.ops.build import load

    fn = load("int8_matmul").int8_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
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
    mt, steps, splits, blocks = 0, 1, 1, 1
    if x.dtype == torch.bfloat16:
        p = plan(m, n, k)
        mt, steps, splits, blocks = (p["mt"], p["steps_per_split"],
                                     p["splits"], p["blocks"])
    err = _launcher()(
        x2.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
        m, n, k, _DTYPE_CODES[x.dtype], mt, steps, splits, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 matmul launch failed: cudaError {err}")
    launches.count(int8_matmul)
    return y.reshape(*lead, n)


int8_matmul.launches = 0
