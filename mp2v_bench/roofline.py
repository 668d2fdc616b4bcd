"""The least time a card needs for a window's decode work, from the
stream's tokens and geometry alone (not from the kernels that ran, so the
work reads the same whatever implements it): its bytes over the card's
memory rate.  The bytes of one picture are

* each coded block's 64 int16 coefficients, read once;
* each reference byte that the picture's prediction needs, read once: per
  direction and plane, the union of the macroblocks' prediction windows
  (as the golden model's ``mc_window`` places them: the start clamped into
  the plane, one more row or column under a half-pel vector, none in the
  zero padding, which is not in memory);
* each byte of the decoded frame, written once.

The arithmetic follows ``chip_smoke.py``'s ``bound`` and ``window_bytes``
(bytes over 3.35 TB/s); the decode is bound by bytes, not operations.
"""
from __future__ import annotations

import numpy as np

from .ref import headers as H
from .ref.golden.mc import chroma_mv
from .ref.tokenizer.types import CHROMA_INFO

# memory bytes per second of each card by torch.cuda.get_device_name (the
# data sheet's, at the card's full power limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _union_rows(rows0, nrows, cols0, ncols, H_: int, W_: int) -> int:
    """Cells of an (H_, W_) plane covered by the rectangles ``rows0 ..
    rows0 + nrows`` by ``cols0 .. cols0 + ncols``, each cut at the plane's
    edge (a 2-D difference array, summed up)."""
    if not len(rows0):
        return 0
    r0 = np.clip(rows0, 0, H_)
    r1 = np.clip(rows0 + nrows, 0, H_)
    c0 = np.clip(cols0, 0, W_)
    c1 = np.clip(cols0 + ncols, 0, W_)
    d = np.zeros((H_ + 1, W_ + 1), np.int32)
    np.add.at(d, (r0, c0), 1)
    np.add.at(d, (r0, c1), -1)
    np.add.at(d, (r1, c0), -1)
    np.add.at(d, (r1, c1), 1)
    return int((d.cumsum(0).cumsum(1)[:H_, :W_] > 0).sum())


def _windows(start, mv_half, h: int, plane: int):
    """Window starts (clamped into a plane of ``plane`` rows or columns as
    ``mc_window`` clamps them into its zero-padded copy) and lengths (one
    more under a half-pel vector) along one axis."""
    pos = np.clip(start + (mv_half >> 1), 0, plane - h)
    return pos, h + (mv_half & 1)


def reference_bytes(tokens, direction: int) -> int:
    """Bytes of the reference planes that one direction's prediction of a
    picture needs (0 for none), counted on each field of each plane:
    frame windows cover their rows of both fields, a field window the rows
    of the field it selects."""
    g = tokens.geom
    use = tokens.coded & (tokens.fwd if direction == 0 else tokens.bwd)
    m = np.nonzero(use)[0]
    if not len(m):
        return 0
    xs, ys, _ = CHROMA_INFO[g.chroma_format]
    my, mx = np.divmod(m, g.mb_width)
    field = tokens.field_pred[m]
    frame = ~field
    total = 0
    for comp in range(3):
        Hp, Wp = g.luma_padded if comp == 0 else g.chroma_padded
        bh, bw = (16, 16) if comp == 0 else (16 >> ys, 16 >> xs)
        y0, x0 = my * bh, mx * bw
        mvs = []
        for unit in range(2):
            mvx = tokens.mv[m, unit, direction, 0].astype(np.int64)
            mvy = tokens.mv[m, unit, direction, 1].astype(np.int64)
            mvs.append(chroma_mv(mvx, mvy, g.chroma_format) if comp
                       else (mvx, mvy))
        rows, nr = _windows(y0[frame], mvs[0][1][frame], bh, Hp)
        cols, nc = _windows(x0[frame], mvs[0][0][frame], bw, Wp)
        for parity in range(2):
            r0 = (rows - parity + 1) // 2
            r1 = (rows + nr - parity + 1) // 2
            wins = [(r0, r1 - r0, cols, nc)]
            for unit in range(2):
                sel = field & (tokens.mvfs[m, unit, direction] == parity)
                fr, fn = _windows(y0[sel] // 2, mvs[unit][1][sel], bh // 2,
                                  Hp // 2)
                fc, fm = _windows(x0[sel], mvs[unit][0][sel], bw, Wp)
                wins.append((fr, fn, fc, fm))
            total += _union_rows(*(np.concatenate(x) for x in zip(*wins)),
                                 Hp // 2, Wp)
    return total


def picture_bytes(tokens, pct: int) -> int:
    """Bytes one picture's decode needs read or written (module doc)."""
    g = tokens.geom
    xs, ys, _ = CHROMA_INFO[g.chroma_format]
    cw = (g.width + (1 << xs) - 1) >> xs
    ch = (g.height + (1 << ys) - 1) >> ys
    out = g.width * g.height + 2 * cw * ch
    coeff = tokens.n_coded_blocks * 64 * 2
    refs = reference_bytes(tokens, 0)
    if pct == H.PCT_B:
        refs += reference_bytes(tokens, 1)
    return coeff + refs + out


def window_bytes(decoded, refs) -> int:
    """Bytes of a window that decoded distinct picture ``i`` of channel
    ``c`` ``decoded[c, i]`` times, summed over the channels: each
    channel's pictures are held against its own reference's tokens and
    coding types (``refs[c]``, a ``reference.Reference``)."""
    return sum(n * picture_bytes(refs[c].tokens[i], refs[c].pcts[i])
               for (c, i), n in decoded.items())
