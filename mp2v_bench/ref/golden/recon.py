"""Numpy golden picture reconstruction from :class:`PictureTokens`.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/golden/recon.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/golden/recon.py``.  This is the bit-exactness
oracle the device reconstruction (the CUDA kernels and their plain
versions) is tested against: IDCT residual assembly (incl. field-DCT
interleave), frame- and field-based motion compensation, bidirectional
averaging, residual add and saturation (reference equivalents:
mb_decoder.cpp:157-339).
"""
from __future__ import annotations

import numpy as np

from ..headers import CHROMA_420, CHROMA_422, CHROMA_444
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureTokens
from .idct import idct_blocks
from .mc import chroma_mv, mc_bidir, mc_window, pad_for_mc


def zero_planes(geom: PictureGeometry):
    lh, lw = geom.luma_padded
    ch, cw = geom.chroma_padded
    return (np.zeros((lh, lw), np.uint8),
            np.zeros((ch, cw), np.uint8),
            np.zeros((ch, cw), np.uint8))


def _assemble_tile(blocks, rows: int, cols: int, interleave: bool) -> np.ndarray:
    """blocks: (rows*cols, 8, 8) spatial row-major -> (rows*8, cols*8) tile.
    With ``interleave`` (field DCT, spec 6.3.17.1 figure 6-13), block-row 0
    supplies the even tile rows and block-row 1 the odd rows."""
    grid = blocks.reshape(rows, cols, 8, 8)
    rowtiles = [np.concatenate([grid[r, c] for c in range(cols)], axis=1)
                for r in range(rows)]
    if not interleave or rows == 1:
        return np.concatenate(rowtiles, axis=0)
    out = np.empty((rows * 8, cols * 8), rowtiles[0].dtype)
    out[0::2] = rowtiles[0]
    out[1::2] = rowtiles[1]
    return out


def _pred_block(padded_planes, comp, y0, x0, mv, cf, h, w):
    mvx, mvy = int(mv[0]), int(mv[1])
    if comp > 0:
        mvx, mvy = chroma_mv(mvx, mvy, cf)
    return mc_window(padded_planes[comp], y0, x0, mvx, mvy, h, w)


def _pred_block_field(padded_fields, comp, y0, x0, mv, cf, h, w, src_field):
    """Field-based prediction inside a frame picture: operate on the
    de-interlaced field views (equivalent to the reference's doubled-stride
    field kernels, mb_decoder.cpp:212-289)."""
    mvx, mvy = int(mv[0]), int(mv[1])
    if comp > 0:
        mvx, mvy = chroma_mv(mvx, mvy, cf)
    return mc_window(padded_fields[comp][src_field], y0 // 2, x0, mvx, mvy,
                     h // 2, w)


def _pad_refs(planes):
    full = tuple(pad_for_mc(p) for p in planes)
    fields = tuple((pad_for_mc(p[0::2]), pad_for_mc(p[1::2])) for p in planes)
    return full, fields


def reconstruct_picture(tokens: PictureTokens,
                        ref0=None, ref1=None) -> tuple:
    """Return reconstructed (Y, U, V) uint8 padded planes."""
    geom = tokens.geom
    cf = geom.chroma_format
    xs, ys, n_cb = CHROMA_INFO[cf]
    cbw = 16 >> xs   # chroma block width in pixels per MB
    cbh = 16 >> ys
    c_cols = cbw // 8
    c_rows = cbh // 8

    out = zero_planes(geom)
    if ref0 is None:
        ref0 = zero_planes(geom)
    if ref1 is None:
        ref1 = zero_planes(geom)
    ref0_full, ref0_fields = _pad_refs(ref0)
    ref1_full, ref1_fields = _pad_refs(ref1)

    # batched fixed-point IDCT over every block of the picture
    residual = idct_blocks(tokens.dense_coeff())  # (n_mb, n_blk, 8, 8) int16

    mbw = geom.mb_width
    for m in range(geom.n_mb):
        if not tokens.coded[m]:
            continue
        my, mx = divmod(m, mbw)
        ly, lx = my * 16, mx * 16
        cy, cx = (my * 16) >> ys, (mx * 16) >> xs
        interleave = bool(tokens.dct_type[m])

        # residual tiles
        res_y = _assemble_tile(residual[m, 0:4], 2, 2, interleave)
        res_cb = _assemble_tile(residual[m, 4:4 + n_cb], c_rows, c_cols,
                                interleave and cf != CHROMA_420)
        res_cr = _assemble_tile(residual[m, 4 + n_cb:4 + 2 * n_cb], c_rows,
                                c_cols, interleave and cf != CHROMA_420)

        # prediction
        fwd, bwd = bool(tokens.fwd[m]), bool(tokens.bwd[m])
        preds = []
        if fwd or bwd:
            geom_blocks = ((0, ly, lx, 16, 16), (1, cy, cx, cbh, cbw),
                           (2, cy, cx, cbh, cbw))
            if not tokens.field_pred[m]:
                mv_sets = []
                if fwd:
                    mv_sets.append((ref0_full, tokens.mv[m, 0, 0]))
                if bwd:
                    mv_sets.append((ref1_full, tokens.mv[m, 0, 1]))
                for comp, y0, x0, h, w in geom_blocks:
                    ps = [_pred_block(refp, comp, y0, x0, mv, cf, h, w)
                          for refp, mv in mv_sets]
                    preds.append(ps[0] if len(ps) == 1 else mc_bidir(*ps))
            else:
                # field-based: unit r predicts destination field r
                for comp, y0, x0, h, w in geom_blocks:
                    tile = np.zeros((h, w), np.uint8)
                    for r in range(2):
                        mv_sets = []
                        if fwd:
                            mv_sets.append((ref0_fields, tokens.mv[m, r, 0],
                                            int(tokens.mvfs[m, r, 0])))
                        if bwd:
                            mv_sets.append((ref1_fields, tokens.mv[m, r, 1],
                                            int(tokens.mvfs[m, r, 1])))
                        ps = [_pred_block_field(refp, comp, y0, x0, mv, cf,
                                                h, w, sf)
                              for refp, mv, sf in mv_sets]
                        tile[r::2] = ps[0] if len(ps) == 1 else mc_bidir(*ps)
                    preds.append(tile)
        else:
            preds = [np.zeros((16, 16), np.uint8),
                     np.zeros((cbh, cbw), np.uint8),
                     np.zeros((cbh, cbw), np.uint8)]

        # residual add + saturate
        for comp, (y0, x0), pred, res in (
            (0, (ly, lx), preds[0], res_y),
            (1, (cy, cx), preds[1], res_cb),
            (2, (cy, cx), preds[2], res_cr),
        ):
            h, w = res.shape
            val = pred.astype(np.int16) + res
            out[comp][y0:y0 + h, x0:x0 + w] = np.clip(val, 0, 255).astype(np.uint8)

    return out
