"""The port's host-side native code: the multi-threaded window gather of
the data feed (``gather.cpp``, a copy of the JAX package's ``dg_gather``),
bound with ctypes.

The library is built with ``g++ -O3 -shared -fPIC -pthread`` at its first
use into the checkout's ``build/`` directory, named by a hash of the
source as ``ops/build.py`` names the kernels' libraries, so an edited
source never loads a stale library. A failed build raises with the
compiler's output: there is no silent NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import typing as tp

import numpy as np

from midgpt_tpu_torch.ops.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gather.cpp")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: tp.Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdatagather-{digest}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a process-unique name renamed into place: a concurrent builder never
    # loads a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build {_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The gather library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.dg_gather.restype = ctypes.c_int
            lib.dg_gather.argtypes = [
                ctypes.c_void_p,  # tokens
                ctypes.c_int64,  # n_tokens
                ctypes.c_void_p,  # offsets
                ctypes.c_int64,  # n_seqs
                ctypes.c_int64,  # block_size
                ctypes.c_void_p,  # x_out
                ctypes.c_void_p,  # y_out
                ctypes.c_int,  # n_threads
            ]
            _lib = lib
        return _lib


def gather_windows(tokens: np.ndarray, offsets: np.ndarray, block_size: int,
                   n_threads: tp.Optional[int] = None,
                   ) -> tp.Tuple[np.ndarray, np.ndarray]:
    """(x, y) int32 ``[n, block_size]`` windows of the uint16 stream
    ``tokens`` at ``offsets``; y is x shifted by one. Raises IndexError if
    a window runs past either end of the stream."""
    if tokens.dtype != np.uint16 or tokens.ndim != 1:
        raise TypeError("tokens must be a 1-D uint16 array")
    tokens = np.ascontiguousarray(tokens)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_seqs = len(offsets)
    x = np.empty((n_seqs, block_size), dtype=np.int32)
    y = np.empty((n_seqs, block_size), dtype=np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = load_library().dg_gather(
        tokens.ctypes.data, len(tokens), offsets.ctypes.data, n_seqs,
        block_size, x.ctypes.data, y.ctypes.data, n_threads)
    if rc != 0:
        raise IndexError("gather window out of range")
    return x, y
