"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source under ``midgpt_tpu_torch/csrc/`` has a plain C
interface and compiles on its own into a shared library under the
checkout's ``build/`` directory, named by a hash of the source and the
shared headers (``csrc/*.cuh``) so an edited source never loads a stale
library. Nothing builds at import:
the first launch of a kernel builds it, and ``build_all`` builds every
source at once (one ``nvcc`` process each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import typing as tp

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build")

# kernel name -> source path relative to the package
SOURCES: tp.Dict[str, str] = {
    "paged_decode": "csrc/paged_decode.cu",
    "fused_attn": "csrc/fused_attn.cu",
    "flash": "csrc/flash.cu",
    "fused_norm": "csrc/fused_norm.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: tp.Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source and of the
    headers under ``csrc/`` that sources may include."""
    csrc = os.path.join(PACKAGE_DIR, "csrc")
    headers = sorted(n for n in os.listdir(csrc) if n.endswith(".cuh"))
    h = hashlib.sha1()
    for path in [os.path.join(PACKAGE_DIR, SOURCES[name])] + [
            os.path.join(csrc, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str) -> tp.Optional[tp.Tuple[subprocess.Popen, str, str]]:
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(PACKAGE_DIR, SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: str,
                  out: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> tp.Dict[str, str]:
    """Build every kernel source in parallel; returns each kernel's
    compiler log (empty for a library that was already built)."""
    started = {name: _start_build(name) for name in SOURCES}
    return {
        name: (_finish_build(name, *job) if job is not None else "")
        for name, job in started.items()
    }


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, *job)
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib
