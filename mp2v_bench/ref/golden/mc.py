"""Half-pel motion compensation — numpy golden model.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/golden/mc.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/golden/mc.py``.

MPEG-2 prediction arithmetic (spec 7.6.4; reference scalar kernels:
src/core/mc_c.hpp:3-54): integer part of the half-pel vector offsets the
window; the two fractional bits select between copy / horizontal /
vertical / 4-tap bilinear averaging, each stage rounding with ``+1 >> 1``;
bidirectional prediction averages the two single-direction predictions with
the same rounding.

MC reads an (h+1, w+1) window from the reference plane *zero-padded by one
row/column at bottom and right* (the padding is only touched by the unused
half-pel taps at the picture edge).  The window origin is clamped into the
padded plane — the clamp the device kernels apply to their window starts —
so host and device paths stay bit-identical even on malformed streams;
conforming streams never reference outside the picture.
"""
from __future__ import annotations

import numpy as np


def pad_for_mc(plane: np.ndarray) -> np.ndarray:
    """Zero-pad one row/col at bottom/right for the half-pel window reads."""
    return np.pad(plane, ((0, 1), (0, 1)))


def mc_window(padded: np.ndarray, y0: int, x0: int, mvx: int, mvy: int,
              h: int, w: int) -> np.ndarray:
    """Unidirectional half-pel prediction of an (h, w) block whose top-left
    is (y0, x0) in *destination* coordinates, from a ``pad_for_mc`` plane."""
    iy = min(max(y0 + (mvy >> 1), 0), padded.shape[0] - (h + 1))
    ix = min(max(x0 + (mvx >> 1), 0), padded.shape[1] - (w + 1))
    hy = mvy & 1
    hx = mvx & 1
    win = padded[iy:iy + h + 1, ix:ix + w + 1].astype(np.uint16)
    a = win[:h, :w]
    if hx and hy:
        b, c, d = win[:h, 1:w + 1], win[1:h + 1, :w], win[1:h + 1, 1:w + 1]
        return ((((a + b + 1) >> 1) + ((c + d + 1) >> 1) + 1) >> 1).astype(np.uint8)
    if hx:
        return ((a + win[:h, 1:w + 1] + 1) >> 1).astype(np.uint8)
    if hy:
        return ((a + win[1:h + 1, :w] + 1) >> 1).astype(np.uint8)
    return a.astype(np.uint8)


def mc_bidir(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    return ((p0.astype(np.uint16) + p1.astype(np.uint16) + 1) >> 1).astype(np.uint8)


def chroma_mv(mvx: int, mvy: int, chroma_format: int):
    """Chroma motion vector derivation (spec 7.6.3.7; arithmetic shift as in
    reference mb_decoder.cpp:198-206)."""
    if chroma_format < 3:
        mvx = mvx >> 1
    if chroma_format < 2:
        mvy = mvy >> 1
    return mvx, mvy
