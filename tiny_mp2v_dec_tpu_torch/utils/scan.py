"""Coefficient scan orders and default quantiser matrices (ISO/IEC 13818-2).

Data here is ISO/IEC 13818-2:2000 spec material:
  - Figure 7-2 (zig-zag scan), Figure 7-3 (alternate scan)
  - Section 6.3.11 default quantiser matrices

Internal block layout convention
--------------------------------
Coefficient blocks in this framework are stored in *column-major* ("transposed
raster") order: index ``t = u*8 + v`` holds coefficient ``QF[v][u]`` (v = row,
u = column).  This matches the layout the fixed-point IDCT consumes (its first
1-D pass runs along what is physically the first axis, which combined with the
transposed storage yields the spec's row/column transform order) and mirrors
the reference decoder's ``g_scan_trans`` convention (reference:
src/core/scan_c.cpp:4-21, mb_decoder.cpp:141) so the fixed-point arithmetic is
truncation-order identical.
"""
from __future__ import annotations

import numpy as np

# Figure 7-2: zig-zag scan order. SCAN_RASTER[0][pos] = raster index (v*8+u).
_ZIGZAG = [
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
]

# Figure 7-3: alternate scan order. SCAN_RASTER[1][pos] = raster index.
_ALTSCAN = [
    0,  8, 16, 24,  1,  9,  2, 10,
    17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18,  3, 11,  4, 12,
    19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28,  5, 13,  6, 14,
    21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30,  7, 15, 23, 31,
    38, 46, 54, 62, 39, 47, 55, 63,
]

# scan position -> raster index (v*8+u)
SCAN_RASTER = np.array([_ZIGZAG, _ALTSCAN], dtype=np.uint8)

# raster index -> transposed-raster index
TRANSPOSE64 = np.array([(k % 8) * 8 + k // 8 for k in range(64)], dtype=np.uint8)

# scan position -> transposed-raster storage index (the layout blocks use)
SCAN_STORE = TRANSPOSE64[SCAN_RASTER]

# raster index -> scan position (inverse of SCAN_RASTER), used to de-zigzag
# quantiser matrices downloaded from the bitstream.
RASTER_TO_SCANPOS = np.zeros((2, 64), dtype=np.uint8)
for _alt in range(2):
    RASTER_TO_SCANPOS[_alt, SCAN_RASTER[_alt]] = np.arange(64, dtype=np.uint8)

# Section 6.3.11: default intra quantiser matrix, raster order W[v][u].
DEFAULT_INTRA_QUANT_MATRIX = np.array([
    8,  16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83,
], dtype=np.uint8)

DEFAULT_NON_INTRA_QUANT_MATRIX = np.full(64, 16, dtype=np.uint8)


def dezigzag(values64) -> np.ndarray:
    """Convert a matrix downloaded from the bitstream (zig-zag order per
    spec 6.3.7) into raster order."""
    out = np.zeros(64, dtype=np.uint8)
    out[SCAN_RASTER[0]] = np.asarray(values64, dtype=np.uint8)
    return out
