"""Fixed-point 8x8 IDCT: plain PyTorch version and the CUDA kernel K1.

Counterpart of ``tiny_mp2v_dec_tpu/ops/idct.py``.  The arithmetic is the
golden model's (``tiny_mp2v_dec_tpu/golden/idct.py``, which replicates the
reference's SSE2 kernel): per-stage ``mulhi`` truncation, int16-saturating
adds/subs and int16-wrapping left shifts, emulated in int32, then ``>> 6``.

Block storage: a 64-vector holds the coefficient matrix transposed
(index u*8+v = QF[v][u]); pass 1 runs along the stored first axis, pass 2
along the second, and the result lands in raster order.

:func:`idct_blocks` dispatches on where its tensor lies: a CPU tensor takes
the plain version :func:`idct_blocks_ref`, a CUDA tensor the kernel of
``csrc/idct.cu``; any other device raises.  The decoder's paths run K1's
transform inside the chunk transport (``csrc/transport.cu``,
``ops/recon.py``), which shares its device code (``csrc/idct8x8.cuh``);
this wrapper serves ``chip_smoke.py``, ``tools/ab_kernel_times.py`` and
the tests.
"""
from __future__ import annotations

import torch

from . import _build

IDCT_SCALE_SHIFT = 6

# _mm_mulhi_epi16 magic constants of the reference's idct_sse2.hpp
K_TMP0, K_TMP1, K_TMP3, K_TMP4 = 27145, 30068, 20090, 25079
K0, K1, K2, K3 = 27145, -5037, -19954, -22089
K5, K6, K7 = 14567, 17391, 25570


def _sat16(x):
    """_mm_adds/subs_epi16 saturation of an int32 value."""
    return torch.clamp(x, -32768, 32767)


def _wrap16(x):
    """_mm_slli_epi16 two's-complement wraparound of an int32 value."""
    return ((x + 32768) & 65535) - 32768


def butterfly8(s):
    """The 8-point butterfly of idct_sse2.hpp:23-65 on a list of 8
    equal-shape int32 tensors holding int16-range values; returns the 8
    transformed outputs (int16-range int32)."""
    def mulhi(x, k):
        return (x * k) >> 16

    def adds(a, b):
        return _sat16(a + b)

    def subs(a, b):
        return _sat16(a - b)

    def op0(x):  # x * 1.414213 : src + mulhi(src, 27145)
        return adds(x, mulhi(x, K_TMP0))

    def op1(x):  # x * 0.541196 : src - mulhi(src, 30068)
        return subs(x, mulhi(x, K_TMP1))

    def op3(x):  # x * 1.306562 : src + mulhi(src, 20090)
        return adds(x, mulhi(x, K_TMP3))

    def op4(x):  # x * 0.382683
        return mulhi(x, K_TMP4)

    # step 0 (idct_sse2.hpp:25-33)
    v15 = adds(_wrap16(mulhi(s[0], K0) << 1), _wrap16(s[0] << 1))
    v26 = adds(mulhi(s[1], K1), _wrap16(s[1] << 2))
    v21 = adds(mulhi(s[2], K2), _wrap16(s[2] << 2))
    v28 = adds(_wrap16(mulhi(s[3], K3) << 1), _wrap16(s[3] << 2))
    v16 = adds(_wrap16(mulhi(s[4], K0) << 1), _wrap16(s[4] << 1))
    v25 = adds(mulhi(s[5], K5), _wrap16(s[5] << 1))
    v22 = adds(_wrap16(mulhi(s[6], K6) << 1), s[6])
    v27 = _wrap16(mulhi(s[7], K7) << 1)

    # step 1 (idct_sse2.hpp:35-44)
    v19 = subs(v25, v28)
    v20 = subs(v26, v27)
    v23 = adds(v26, v27)
    v24 = adds(v25, v28)
    v7 = adds(v23, v24)
    v11 = adds(v21, v22)
    v13 = subs(v23, v24)
    v17 = subs(v21, v22)
    v8 = adds(v15, v16)
    v9 = subs(v15, v16)

    # step 2 (idct_sse2.hpp:46-56)
    v18 = op4(subs(v19, v20))
    v12 = subs(v18, op3(v19))
    v14 = subs(op1(v20), v18)
    v6 = subs(_wrap16(v14 << 1), v7)
    v5 = subs(op0(v13), v6)
    v4 = adds(v5, _wrap16(v12 << 1))
    v10 = subs(op0(v17), v11)
    v0 = adds(v8, v11)
    v1 = adds(v9, v10)
    v2 = subs(v9, v10)
    v3 = subs(v8, v11)

    # step 3 (idct_sse2.hpp:58-65)
    return [adds(v0, v7), adds(v1, v6), adds(v2, v5), subs(v3, v4),
            adds(v3, v4), subs(v2, v5), subs(v1, v6), subs(v0, v7)]


def _idct_1d(blocks):
    """One butterfly pass along axis -2 of an (..., 8, N) int32 tensor."""
    return torch.stack(butterfly8([blocks[..., k, :] for k in range(8)]),
                       dim=-2)


def idct_blocks_ref(coeffs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch IDCT on any device: (..., 64) int16 -> (..., 8, 8)
    int16 raster residual."""
    m = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).to(torch.int32)
    t = _idct_1d(m)                    # pass 1 (u / horizontal)
    t = t.transpose(-1, -2)            # transpose_8x8_sse2
    t = _idct_1d(t)                    # pass 2 (v / vertical)
    return (t >> IDCT_SCALE_SHIFT).to(torch.int16)


def _check(coeffs: torch.Tensor) -> None:
    """Raise unless ``coeffs`` is what kernel K1 takes: a contiguous
    (B, 64) int16 tensor, 16-byte aligned (the kernel loads each stored row
    of a block as one 16-byte word).  Runs before the kernel library is
    loaded, so it holds on any device."""
    if (coeffs.dtype != torch.int16 or coeffs.dim() != 2
            or coeffs.shape[1] != 64 or not coeffs.is_contiguous()):
        raise ValueError("idct_blocks: expected a contiguous (B, 64) int16 "
                         f"tensor, got {tuple(coeffs.shape)} {coeffs.dtype}")
    if coeffs.data_ptr() % 16:
        raise ValueError("idct_blocks: the coefficients must be 16-byte "
                         "aligned (the kernel reads 16-byte rows)")


def _launch(coeffs: torch.Tensor) -> torch.Tensor:
    """Check ``coeffs`` (:func:`_check`) and run kernel K1 on the current
    stream of its device: (B, 8, 8) int16."""
    _check(coeffs)
    n = coeffs.shape[0]
    out = torch.empty((n, 8, 8), dtype=torch.int16, device=coeffs.device)
    if n == 0:
        return out
    lib = _build.kernel_library()
    rc = lib.mp2v_idct8x8(coeffs.data_ptr(), out.data_ptr(), n,
                          _build.stream_handle(coeffs.device))
    _build.check("mp2v_idct8x8", rc)
    _build.LAUNCHES["idct8x8"] += 1
    return out


def idct_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """(B, 64) int16 -> (B, 8, 8) int16.  CPU tensor: the plain version;
    CUDA tensor: kernel K1 (``csrc/idct.cu``), which raises unless the
    tensor is contiguous and 16-byte aligned; anything else raises."""
    if coeffs.device.type == "cpu":
        return idct_blocks_ref(coeffs)
    if coeffs.device.type != "cuda":
        raise ValueError(f"idct_blocks: no kernel for device {coeffs.device}")
    return _launch(coeffs)
