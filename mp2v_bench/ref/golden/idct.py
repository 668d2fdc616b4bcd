"""Fixed-point 8x8 inverse DCT — the bit-exactness golden spec.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/golden/idct.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/golden/idct.py`` (numpy only).

This is the single golden definition of the decoder's IDCT arithmetic.  It
replicates, op for op, the arithmetic of the reference decoder's x86-64
production kernel (reference: src/core/idct_sse2.hpp:7-120): per-stage
two-term multiplies (`_mm_mulhi_epi16` truncation plus power-of-two shifts),
*saturating* int16 adds/subs (`_mm_adds_epi16`/`_mm_subs_epi16`), and
two's-complement *wraparound* on the int16 left shifts (`_mm_slli_epi16`).

Note the reference also ships a plain fixed-point model (idct_ref.hpp) and a
float model (idct_c.hpp); all three agree only for small coefficients (its
SIMD parity test draws inputs from 0..255, test/gtest/simd/idct_test.cpp:42).
For real streams (intra DC alone reaches ±2040) they diverge, and the
behavior a user of the reference observes on x86 is the SSE2 arithmetic —
so that is the behavior this framework defines as golden; decoded YUV is
bit-exact against the reference binary (see tests/test_reference_bitexact).

The function is array-namespace-generic: ``xp`` is ``numpy`` by default, or
any namespace with numpy's array API; each produces identical bits.  The
port's K1 (``csrc/idct.cu``) and its plain version (``ops/idct.py``) follow
the same steps and are held to this arithmetic.

Block storage convention: a 64-vector holds the coefficient matrix
*transposed* (index u*8+v = QF[v][u], see utils/scan.py), mirroring the
reference's g_scan_trans layout (scan_c.cpp:4-21), so pass 1 runs along the
stored first axis (the u/horizontal transform), pass 2 along the second, and
the result lands in raster order with no extra transpose — the same dataflow
as idct_sse2's load/idct/transpose/idct/store sequence.
"""
from __future__ import annotations

import numpy as np

IDCT_SCALE_SHIFT = 6

# _mm_mulhi_epi16 magic constants from idct_sse2.hpp (each stage-0 multiply
# is value*(shifted src) + mulhi(src, K) so the effective scale matches the
# AAN butterfly constants C0..C7 / S1,S3,S4,SQ of idct_ref.hpp)
K_TMP0, K_TMP1, K_TMP3, K_TMP4 = 27145, 30068, 20090, 25079
K0, K1, K2, K3 = 27145, -5037, -19954, -22089
K5, K6, K7 = 14567, 17391, 25570


def _sat16(x, xp):
    """_mm_adds/subs_epi16 saturation of an int32 value."""
    return xp.clip(x, -32768, 32767)


def _wrap16(x):
    """_mm_slli_epi16 two's-complement wraparound of an int32 value."""
    return ((x + 32768) & 65535) - 32768


def butterfly8(s, xp=np):
    """The 8-point butterfly of idct_sse2.hpp:23-65 on a list of 8
    equal-shape *int32* arrays holding int16-range values; returns the 8
    transformed outputs (int16-range int32), in the namespace ``xp``."""
    def mulhi(x, k):
        return (x * k) >> 16

    def adds(a, b):
        return _sat16(a + b, xp)

    def subs(a, b):
        return _sat16(a - b, xp)

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


def idct_1d(blocks, xp=np):
    """One butterfly pass along axis -2 of an (..., 8, N) int32 array."""
    out = butterfly8([blocks[..., k, :] for k in range(8)], xp)
    return xp.stack(out, axis=-2)


def idct_blocks(coeffs, xp=np):
    """Full 2-D fixed-point IDCT (idct_sse2.hpp:96-120 dataflow).

    coeffs: (..., 64) int16 blocks in transposed-raster storage.
    Returns (..., 8, 8) int16 spatial residual in raster order (already
    descaled by the arithmetic >> 6 of the store stage); caller adds
    prediction and saturates to u8.
    """
    m = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).astype(xp.int32)
    t = idct_1d(m, xp)                 # pass 1 (u / horizontal)
    t = xp.swapaxes(t, -1, -2)         # transpose_8x8_sse2
    t = idct_1d(t, xp)                 # pass 2 (v / vertical)
    return (t >> IDCT_SCALE_SHIFT).astype(xp.int16)


def float_idct_blocks(coeffs):
    """Independent float reference (spec Annex A definition) used only to
    sanity-check the fixed-point pipeline — numpy only."""
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    basis = 0.5 * c[None, :] * np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16)
    m = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).astype(np.float64)
    qf = np.swapaxes(m, -1, -2)  # undo transposed storage -> QF[v][u]
    # f[y][x] = sum_{v,u} B[y,v] QF[v,u] B[x,u],  B[x,u] = c_u/2 cos((2x+1)u pi/16)
    return np.einsum("yv,...vu,xu->...yx", basis, qf, basis)
