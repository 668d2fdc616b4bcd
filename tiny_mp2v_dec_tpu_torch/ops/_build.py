"""Build and load the hand-written CUDA kernels of ``csrc/*.cu``.

``nvcc`` compiles every source of ``csrc/`` for ``sm_90a`` (Hopper), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, under the repository's
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
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB = os.path.join(BUILD_DIR, "libmp2v_kernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES: collections.Counter = collections.Counter()

_P = C.c_void_p
_I = C.c_int
# length of the pointer array every MC entry point takes (layout in
# csrc/mc_ptrs.cuh): ref0[2], ref1[2], res[2], out[2], sy/sx/ph fwd,
# sy/sx/ph bwd, mode, then the field tuples (C0, sx0, ph0, C1, sx1, ph1) fwd
# and bwd.  The SWAR entry points (K7/K8) take no residual (null) and write
# their (H, W/4) word plane to out[0]; K7's picture form (mp2v_mc_swar_yuv)
# lays the array out its own way (22 pointers, the rest null).
MC_PTRS = 27
# the MC entry points' arguments: the pointer array, tile rows, tile
# columns, n_mb, mb_width, Hr, Wr, bidir, stream
_MC = [C.POINTER(_P)] + [_I] * 7 + [_P]
# length of the pointer array of the blocks form of K2/K3/K4
# (mp2v_mc_{recon,field}_blocks_{luma,uv}; layout in csrc/mc_ptrs.cuh):
# ref0[2], ref1[2], the residual block grid, the metadata rows, out[2]
MC_BLOCKS_PTRS = 8
# their arguments: the pointer array, metadata columns, chroma format,
# n_mb, the first MB, mb_width, Hr, Wr, bidir, stream
_MC_BLOCKS = [C.POINTER(_P)] + [_I] * 8 + [_P]
# the grouped blocks form (mp2v_mc_{recon,field}_blocks_group): at most
# MC_GROUP_MAX pictures of MC_GROUP_PTRS pointers each (ref0 Y, U, V, ref1
# Y, U, V, the grid, the rows, out Y, U, V), then the pictures, metadata
# columns, chroma format, n_mb, the first MB, mb_width, the luma planes' Hr
# and Wr, the chroma planes' Hc and Wc, the pictures' bidir bits, stream
MC_GROUP_MAX = 16
MC_GROUP_PTRS = 11
_MC_GROUP = [C.POINTER(_P)] + [_I] * 11 + [_P]
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "mp2v_idct8x8": [_P, _P, _I, _P],
    # the chunk transport: pair_pos, pair_val, row_nnz, scat, pic_k,
    # cap_pairs, cap_k, chunk, n_rows, scat_u16, scratch, out, stream
    "mp2v_transport": [_P] * 5 + [_I] * 5 + [_P] * 3,
    "mp2v_mc_recon_luma": _MC,
    "mp2v_mc_recon_uv": _MC,
    "mp2v_mc_field_luma": _MC,
    "mp2v_mc_field_uv": _MC,
    "mp2v_mc_recon_blocks_luma": _MC_BLOCKS,
    "mp2v_mc_recon_blocks_uv": _MC_BLOCKS,
    "mp2v_mc_field_blocks_luma": _MC_BLOCKS,
    "mp2v_mc_field_blocks_uv": _MC_BLOCKS,
    "mp2v_mc_recon_blocks_group": _MC_GROUP,
    "mp2v_mc_field_blocks_group": _MC_GROUP,
    "mp2v_mc_roll_luma": _MC,
    "mp2v_mc_roll_uv": _MC,
    "mp2v_mc_swar": _MC,
    "mp2v_mc_swar_yuv": _MC,
    "mp2v_mc_swar_field": _MC,
    # K9: plane, Hp, Wp, sy, sx, ph, out, H, W, stream
    "mp2v_mc_row": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    # K10: word plane, Hp, words per row, sy, sxq, rb, ph, out, H, W, stream
    "mp2v_mc_row_packed": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # a kernel that does nothing: blocks, stream
    "mp2v_empty": [_I, _P],
}

_lib = None
# one load a process: two decoders' dispatch threads may launch their first
# kernels at the same time
_lib_lock = threading.Lock()


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _inputs() -> list:
    """Every file a compile reads: the sources and their shared headers."""
    return _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


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
            and os.path.getmtime(LIB) > max(map(os.path.getmtime,
                                                _inputs()))):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in srcs]
    tmp = f"{LIB}.{tag}"
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
                 for src, obj in zip(srcs, objs)]
        failed = [src for src, p in zip(srcs, procs) if p.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                       check=True)
        os.replace(tmp, LIB)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    return LIB


def kernel_library():
    """The loaded kernel library (built first when needed), loaded once
    whichever thread asks first."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
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


def empty_kernel(device, blocks: int = 1) -> None:
    """Launch the library's empty kernel, ``blocks`` blocks of the MC
    segment kernels' 256 threads, on the current stream of ``device``: its
    device time is what a launch costs with no work in it."""
    check("mp2v_empty", kernel_library().mp2v_empty(
        blocks, stream_handle(device)))
    LAUNCHES["empty"] += 1
