"""Build and load the hand-written CUDA kernels of ``csrc/*.cu``.

``nvcc`` compiles every source of ``csrc/`` for ``sm_90a`` (Hopper) into
one shared library with a plain C interface, under the repository's
``build/kernels/`` directory, at first use; ``ctypes`` loads it.  Every C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port, and a machine without ``nvcc`` never reaches :func:`kernel_library`
because tensors that lie on the CPU take the plain PyTorch versions.

``LAUNCHES`` counts the kernel launches of each wrapper, so that a run can
show which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes as C
import glob
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB = os.path.join(BUILD_DIR, "libmp2v_kernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()

_P = C.c_void_p
_I = C.c_int
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "mp2v_idct8x8": [_P, _P, _I, _P],
    # ref0[2], ref1[2], res[2], out[2], sy/sx/ph fwd, sy/sx/ph bwd, mode,
    # n_mb, mb_width, Hr, Wr, bidir, stream
    "mp2v_mc_recon_luma": [_P] * 15 + [_I] * 5 + [_P],
    "mp2v_mc_recon_uv": [_P] * 15 + [_I] * 5 + [_P],
}

_lib = None


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found: the CUDA kernels cannot be "
                                "built on this machine")
    return path


def build(force: bool = False) -> str:
    """Path of an up-to-date kernel library, compiling it when a source is
    newer.  Compiles to a private temporary name and renames it into place,
    so a concurrent process never loads a half-written library."""
    srcs = _sources()
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) > max(map(os.path.getmtime, srcs))):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs], check=True)
    os.replace(tmp, LIB)
    return LIB


def kernel_library():
    """The loaded kernel library (built first when needed)."""
    global _lib
    if _lib is None:
        lib = C.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = C.c_int
        _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current CUDA stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
