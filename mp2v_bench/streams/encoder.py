"""Synthetic MPEG-2 elementary-stream encoder — test fixture generator.

Frozen copy of ``tests/m2v_encoder.py`` at commit fcc0a56b588b, the
benchmark's stream generator, with its imports taken from the frozen
reference beside it (``mp2v_bench/ref``) instead of the JAX package, and
``encode_stream`` given the sequence header's frame rate, bit rate and
profile and level.  Below, the source's own text.

Generates conforming (progressive frame picture) streams with randomized but
valid macroblock content: I/P/B pictures, all chroma formats, skipped MBs,
quantiser updates, concealment MVs, field/frame motion, dct_type, alternate
scan, intra_vlc_format, q_scale_type, escape-coded coefficients.

This is the end-to-end analog of the reference's table-driven cavlc fuzz
harness (reference: test/gtest/cavlc/cavlc_test.cpp): instead of planting
single code words, we author whole streams and require the decoder paths to
agree on every decoded bit.

The encoder mirrors the decoder's sequential state (PMVs with range wrap,
DC predictors, quantiser scale) so that generated symbols are always legal.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ref import headers as H
from ..ref.utils.bits import BitWriter
from ..ref.vlc import tables as T

_COEFF_CODE = [
    {(run, lvl): (code, ln) for code, ln, run, lvl in T.COEFF_ZERO},
    {(run, lvl): (code, ln) for code, ln, run, lvl in T.COEFF_ONE},
]
_MBTYPE_CODE = {
    1: {flags: code for code, flags in T.MB_TYPE_I},
    2: {flags: code for code, flags in T.MB_TYPE_P},
    3: {flags: code for code, flags in T.MB_TYPE_B},
}


@dataclass
class MBSpec:
    skip_before: int = 0
    intra: bool = False
    fwd: bool = False
    bwd: bool = False
    pattern: bool = False
    quant: bool = False
    qscale_code: int = 8
    motion_type: int = 2           # 2=frame, 1=field (frame pictures)
    dct_type: int = 0
    # mv deltas per (unit r, direction s) -> (dx, dy); motion-code domain
    mv_deltas: Dict[Tuple[int, int], Tuple[int, int]] = dc_field(default_factory=dict)
    mvfs: Dict[Tuple[int, int], int] = dc_field(default_factory=dict)
    cbp: int = 0                   # bitstream block-order bits (bit b = block b)
    # block idx -> (dc_target or None, [(run, level), ...])
    blocks: Dict[int, Tuple[Optional[int], List[Tuple[int, int]]]] = dc_field(default_factory=dict)


@dataclass
class SliceSpec:
    mb_row: int
    qscale_code: int
    macroblocks: List[MBSpec] = dc_field(default_factory=list)


@dataclass
class PictureSpec:
    picture_coding_type: int = H.PCT_I
    temporal_reference: int = 0
    f_code: tuple = ((15, 15), (15, 15))
    intra_dc_precision: int = 0
    frame_pred_frame_dct: int = 1
    concealment_motion_vectors: int = 0
    q_scale_type: int = 0
    intra_vlc_format: int = 0
    alternate_scan: int = 0
    slices: List[SliceSpec] = dc_field(default_factory=list)
    qmext: Optional[H.QuantMatrixExtension] = None


def _write_motion_delta(w: BitWriter, delta: int, f_code: int) -> None:
    if delta == 0:
        w.write_code(T.MOTION_CODE[0])
        return
    f = 1 << (f_code - 1)
    sign = -1 if delta < 0 else 1
    a = abs(delta)
    assert 1 <= a <= 16 * f, (delta, f_code)
    if f_code == 1:
        w.write_code(T.MOTION_CODE[delta])
        return
    mc = (a - 1) // f + 1
    residual = (a - 1) % f
    w.write_code(T.MOTION_CODE[sign * mc])
    w.write(residual, f_code - 1)


def _write_coeff(w: BitWriter, run: int, level: int, table: int) -> None:
    assert level != 0 and -2047 <= level <= 2047 and 0 <= run <= 63
    code = _COEFF_CODE[table].get((run, abs(level)))
    if code is not None:
        w.write_code(code)
        w.write(1 if level < 0 else 0, 1)
    else:
        w.write_code(T.COEFF_ESCAPE)
        w.write(run, 6)
        w.write(level & 0xFFF, 12)


def _write_dc(w: BitWriter, diff: int, luma: bool) -> None:
    size = 0 if diff == 0 else max(abs(diff), 1).bit_length()
    table = T.DCT_SIZE_LUMA if luma else T.DCT_SIZE_CHROMA
    w.write_code(table[size])
    if size:
        bits = diff if diff >= 0 else diff + (1 << size) - 1
        w.write(bits, size)


class _EncState:
    def __init__(self, pic: PictureSpec):
        self.pmv = np.zeros((2, 2, 2), np.int32)
        self.dc_pred = [1 << (pic.intra_dc_precision + 7)] * 3
        self.prev_intra = False


def _apply_mv_delta(st, r_idx, s, t, delta, f_code, field_in_frame):
    f = 1 << (f_code - 1)
    high, low, rng = 16 * f - 1, -16 * f, 32 * f
    pred = int(st.pmv[r_idx, s, t])
    if field_in_frame and t == 1:
        pred >>= 1
    mv = pred + delta
    if mv < low:
        mv += rng
    if mv > high:
        mv -= rng
    st.pmv[r_idx, s, t] = mv * 2 if (field_in_frame and t == 1) else mv


def encode_picture(w: BitWriter, pic: PictureSpec, geom_mb_width: int,
                   chroma_format: int, vertical_size: int) -> None:
    H.PictureHeader(
        temporal_reference=pic.temporal_reference,
        picture_coding_type=pic.picture_coding_type,
        forward_f_code=7, backward_f_code=7,
    ).write(w)
    H.PictureCodingExtension(
        f_code=pic.f_code,
        intra_dc_precision=pic.intra_dc_precision,
        picture_structure=H.PS_FRAME,
        frame_pred_frame_dct=pic.frame_pred_frame_dct,
        concealment_motion_vectors=pic.concealment_motion_vectors,
        q_scale_type=pic.q_scale_type,
        intra_vlc_format=pic.intra_vlc_format,
        alternate_scan=pic.alternate_scan,
        progressive_frame=1,
    ).write(w)
    if pic.qmext is not None:
        pic.qmext.write(w)

    n_cb = {1: 1, 2: 2, 3: 4}[chroma_format]
    n_blocks = 4 + 2 * n_cb
    pct = pic.picture_coding_type

    for sl in pic.slices:
        st = _EncState(pic)
        H.SliceHeader(slice_vertical_position=sl.mb_row + 1,
                      quantiser_scale_code=sl.qscale_code).write(w, vertical_size)
        first = True
        for mb in sl.macroblocks:
            increment = mb.skip_before + 1
            if pct == H.PCT_P and increment > 1:
                st.pmv[:] = 0
            while increment > 33:
                w.write_code(T.MBA_ESCAPE)
                increment -= 33
            w.write_code(T.MBA[increment])

            flags = ((T.MB_QUANT if mb.quant else 0)
                     | (T.MB_MOTION_FWD if mb.fwd else 0)
                     | (T.MB_MOTION_BWD if mb.bwd else 0)
                     | (T.MB_PATTERN if mb.pattern else 0)
                     | (T.MB_INTRA if mb.intra else 0))
            w.write_code(_MBTYPE_CODE[pct][flags])

            if (mb.fwd or mb.bwd) and pic.frame_pred_frame_dct == 0:
                w.write(mb.motion_type, 2)
            if pic.frame_pred_frame_dct == 0 and (mb.intra or mb.pattern):
                w.write(mb.dct_type, 1)
            if mb.quant:
                w.write(mb.qscale_code, 5)

            # motion vectors
            field_motion = mb.motion_type == 1 and not mb.intra
            mv_count = 2 if field_motion else 1
            cmv = mb.intra and pic.concealment_motion_vectors

            def write_dir(s):
                for r in range(mv_count):
                    if field_motion:
                        w.write(mb.mvfs.get((r, s), 0), 1)
                    dx, dy = mb.mv_deltas.get((r, s), (0, 0))
                    _write_motion_delta(w, dx, pic.f_code[s][0])
                    _apply_mv_delta(st, r, s, 0, dx, pic.f_code[s][0], field_motion)
                    _write_motion_delta(w, dy, pic.f_code[s][1])
                    _apply_mv_delta(st, r, s, 1, dy, pic.f_code[s][1], field_motion)

            if mb.fwd or cmv:
                write_dir(0)
            if mb.bwd:
                write_dir(1)
            if cmv:
                w.write(1, 1)  # marker

            # PMV bookkeeping (Table 7-9) to stay in sync with the decoder
            if not field_motion:
                if mb.intra:
                    st.pmv[1, 0] = st.pmv[0, 0]
                elif mb.fwd and mb.bwd:
                    st.pmv[1] = st.pmv[0]
                elif mb.fwd:
                    st.pmv[1, 0] = st.pmv[0, 0]
                elif mb.bwd:
                    st.pmv[1, 1] = st.pmv[0, 1]
            if (mb.intra and not cmv) or (pct == H.PCT_P and not mb.intra and not mb.fwd):
                st.pmv[:] = 0

            if mb.skip_before > 0 or not mb.intra:
                st.dc_pred = [1 << (pic.intra_dc_precision + 7)] * 3

            # coded block pattern
            if mb.intra:
                cbp = (1 << n_blocks) - 1
            elif mb.pattern:
                cbp = mb.cbp
                base = 0
                for i in range(6):
                    if cbp & (1 << i):
                        base |= 1 << (5 - i)
                w.write_code(T.CBP[base])
                if chroma_format == 2:
                    ext = 0
                    for i in range(2):
                        if cbp & (1 << (6 + i)):
                            ext |= 1 << (1 - i)
                    w.write(ext, 2)
                elif chroma_format == 3:
                    ext = 0
                    for i in range(6):
                        if cbp & (1 << (6 + i)):
                            ext |= 1 << (5 - i)
                    w.write(ext, 6)
            else:
                cbp = 0

            table = 1 if (pic.intra_vlc_format and mb.intra) else 0
            for b in range(n_blocks):
                if not (cbp & (1 << b)):
                    continue
                luma = b < 4
                comp = 0 if luma else 1 + ((b - 4) & 1)
                dc_target, acs = mb.blocks.get(b, (None, []))
                first_ac = True
                if mb.intra:
                    dc_target = dc_target if dc_target is not None else st.dc_pred[comp]
                    _write_dc(w, dc_target - st.dc_pred[comp], luma)
                    st.dc_pred[comp] = dc_target
                for run, level in acs:
                    if (not mb.intra) and table == 0 and first_ac and run == 0 and abs(level) == 1:
                        w.write(1, 1)
                        w.write(1 if level < 0 else 0, 1)
                    else:
                        _write_coeff(w, run, level, table)
                    first_ac = False
                w.write_code(T.EOB_ZERO if table == 0 else T.EOB_ONE)
            first = False
        w.align()


def encode_stream(width: int, height: int, chroma_format: int,
                  pictures: List[PictureSpec],
                  seq_intra_matrix: Optional[np.ndarray] = None,
                  seq_non_intra_matrix: Optional[np.ndarray] = None) -> bytes:
    w = BitWriter()
    sh = H.SequenceHeader(
        horizontal_size_value=width, vertical_size_value=height,
        load_intra_quantiser_matrix=int(seq_intra_matrix is not None),
        intra_quantiser_matrix=seq_intra_matrix,
        load_non_intra_quantiser_matrix=int(seq_non_intra_matrix is not None),
        non_intra_quantiser_matrix=seq_non_intra_matrix)
    sh.write(w)
    H.SequenceExtension(chroma_format=chroma_format).write(w)
    H.GroupOfPicturesHeader().write(w)
    mb_width = (width + 15) // 16
    for pic in pictures:
        encode_picture(w, pic, mb_width, chroma_format, height)
    w.align()
    w.start_code(H.SEQUENCE_END_CODE)
    return w.getvalue()


# ---------------------------------------------------------------------------
# Random but valid picture generation
# ---------------------------------------------------------------------------

def _delta_for_target(pred: int, target: int, f_code: int) -> int:
    """Motion delta that makes the decoder's wrap (update_motion_predictor)
    land exactly on ``target`` (half-pel units) from predictor ``pred``."""
    f = 1 << (f_code - 1)
    low, high, rng_ = -16 * f, 16 * f - 1, 32 * f
    d = target - pred
    if d > high:
        d -= rng_
    elif d < low:
        d += rng_
    assert low <= d <= high
    return d


def _target_range(pos: int, size: int, plane: int, f_code: int):
    """Valid half-pel MV target range keeping the (size+1)-tap half-pel MC
    window fully inside a ``plane``-px dimension from position ``pos``:
    start = pos + (mv >> 1) must satisfy 0 <= start, and start + size <=
    plane-1 for odd (half-pel) mv / start + size <= plane for even mv — which
    makes the valid set the contiguous range [-2*pos, 2*(plane-size-pos)].
    Intersected with the f_code representable range [-16f, 16f-1]."""
    f = 1 << (f_code - 1)
    lo = max(-2 * pos, -16 * f)
    hi = min(2 * (plane - size - pos), 16 * f - 1)
    assert lo <= hi, (pos, size, plane, f_code)
    return lo, hi


def _mv_window_ok(mvx: int, mvy: int, col: int, row: int,
                  mb_width: int, mb_height: int) -> bool:
    """True if a frame-motion MV (half-pel) keeps the MC window in-frame for
    a macroblock at (col, row)."""
    xlo, xhi = -2 * col * 16, 2 * ((mb_width - 1 - col) * 16)
    ylo, yhi = -2 * row * 16, 2 * ((mb_height - 1 - row) * 16)
    return xlo <= mvx <= xhi and ylo <= mvy <= yhi


def _random_block(rng, intra: bool, start_i: int, max_level: int = 600,
                  ref_compat: bool = True):
    """Random list of (run, level) with scan positions staying < 64.
    Non-intra coded blocks must carry at least one coefficient (an empty
    block would make EOB the first code, which B.14 reserves).

    ``ref_compat``: the reference decoder applies B.14's dct_coefficient_first
    short form ('1s' = run 0, level ±1) to *intra* blocks too
    (mb_decoder.cpp:76-88 has no intra guard), although per ISO 13818-2 the
    first coefficient of an intra block is an ordinary dct_coefficient_next
    — so an intra block whose first AC code starts with bit '1' (EOB '10' of
    a DC-only block, or '11s' run-0 ±1) desyncs it.  With ref_compat=True,
    intra blocks always carry a first AC whose code starts with '0' (run>=1
    or |level|>=2), keeping streams inside the subset both the spec and the
    reference decode identically."""
    acs = []
    i = start_i
    while i < 64 and (rng.random() < 0.75 or (not intra and not acs)
                      or (ref_compat and intra and not acs)):
        first = not acs
        run = int(rng.integers(0, min(8, 64 - i)))
        i += run
        if i >= 64:
            break
        if rng.random() < 0.1:
            level = int(rng.integers(512, 2047 + 1)) * (1 if rng.random() < 0.5 else -1)
        else:
            level = int(rng.integers(1, max_level)) * (1 if rng.random() < 0.5 else -1)
        if ref_compat and intra and first and run == 0 and abs(level) == 1:
            level = 2 * level
        acs.append((run, level))
        i += 1
    return acs


def random_picture(rng, mb_width: int, mb_height: int, chroma_format: int,
                   pct: int, *, f_code_max: int = 4, fpfd: bool = True,
                   q_scale_type: int = 0, intra_vlc_format: int = 0,
                   alternate_scan: int = 0, intra_dc_precision: int = 0,
                   allow_field_motion: bool = False,
                   cmv: int = 0) -> PictureSpec:
    n_cb = {1: 1, 2: 2, 3: 4}[chroma_format]
    n_blocks = 4 + 2 * n_cb
    fc = int(rng.integers(2, f_code_max + 1))
    pic = PictureSpec(
        picture_coding_type=pct,
        f_code=((fc, fc), (fc, fc)) if pct != H.PCT_I or cmv else ((15, 15), (15, 15)),
        intra_dc_precision=intra_dc_precision,
        frame_pred_frame_dct=1 if fpfd else 0,
        concealment_motion_vectors=cmv,
        q_scale_type=q_scale_type,
        intra_vlc_format=intra_vlc_format,
        alternate_scan=alternate_scan,
    )
    max_delta = 16 << (fc - 1)
    dc_max = (1 << (8 + intra_dc_precision)) - 1

    for row in range(mb_height):
        sl = SliceSpec(mb_row=row, qscale_code=int(rng.integers(1, 32)))
        st = _EncState(pic)   # simulated PMV state, kept in sync with encode
        col = 0
        prev_nonintra_pred = False
        prev_dirs = (False, False)
        while col < mb_width:
            mb = MBSpec()
            # skipped run (not first in slice; B needs a previous predicted
            # MB).  B-skipped MBs inherit the previous MB's MVs (its PMVs),
            # so the run is trimmed to columns where those MVs keep the MC
            # window in-frame; P-skipped MBs use MV=0 (always in-frame).
            can_skip = col > 0 and col < mb_width - 1 and (
                pct == H.PCT_P or (pct == H.PCT_B and prev_nonintra_pred))
            if can_skip and rng.random() < 0.2:
                want = int(rng.integers(1, min(40, mb_width - col - 1) + 1))
                if pct == H.PCT_B:
                    k = 0
                    for j in range(want):
                        ok = True
                        for s in range(2):
                            if prev_dirs[s] and not _mv_window_ok(
                                    int(st.pmv[0, s, 0]), int(st.pmv[0, s, 1]),
                                    col + j, row, mb_width, mb_height):
                                ok = False
                        if not ok:
                            break
                        k += 1
                    want = k
                mb.skip_before = want
                col += mb.skip_before
                if pct == H.PCT_P and mb.skip_before > 0:
                    st.pmv[:] = 0

            if pct == H.PCT_I:
                mb.intra = True
            elif pct == H.PCT_P:
                r = rng.random()
                if r < 0.15:
                    mb.intra = True
                elif r < 0.55:
                    mb.fwd, mb.pattern = True, True
                elif r < 0.7:
                    mb.fwd = True
                elif r < 0.85:
                    mb.pattern = True
                else:
                    mb.fwd, mb.pattern = True, False
            else:
                r = rng.random()
                if r < 0.1:
                    mb.intra = True
                elif r < 0.4:
                    mb.fwd, mb.bwd = True, True
                    mb.pattern = rng.random() < 0.5
                elif r < 0.7:
                    mb.fwd = True
                    mb.pattern = rng.random() < 0.5
                else:
                    mb.bwd = True
                    mb.pattern = rng.random() < 0.5

            if mb.intra or mb.pattern:
                if rng.random() < 0.3:
                    mb.quant = True
                    mb.qscale_code = int(rng.integers(1, 32))

            if (mb.fwd or mb.bwd) and not fpfd:
                mb.motion_type = 1 if (allow_field_motion and rng.random() < 0.3) else 2
            if not fpfd and (mb.intra or mb.pattern):
                mb.dct_type = int(rng.random() < 0.5)

            # Motion vectors: sample in-frame *targets* (half-pel, window
            # fully inside the picture) and derive the wrapped deltas from
            # the simulated PMV state — generated streams are conformant, so
            # decoders that do not clamp MC reads (like the reference) stay
            # in-bounds.
            field_motion = mb.motion_type == 1 and not mb.intra
            n_units = 2 if field_motion else 1
            xlo, xhi = _target_range(col * 16, 16, mb_width * 16, fc)
            if field_motion:
                ylo, yhi = _target_range(row * 8, 8, mb_height * 8, fc)
            else:
                ylo, yhi = _target_range(row * 16, 16, mb_height * 16, fc)
            for s, on in ((0, mb.fwd or (mb.intra and cmv)), (1, mb.bwd)):
                if not on:
                    continue
                for r_idx in range(n_units):
                    tx = int(rng.integers(xlo, xhi + 1))
                    ty = int(rng.integers(ylo, yhi + 1))
                    px = int(st.pmv[r_idx, s, 0])
                    py = int(st.pmv[r_idx, s, 1])
                    if field_motion:
                        py >>= 1
                    dx = _delta_for_target(px, tx, fc)
                    dy = _delta_for_target(py, ty, fc)
                    mb.mv_deltas[(r_idx, s)] = (dx, dy)
                    mb.mvfs[(r_idx, s)] = int(rng.integers(0, 2))
                    _apply_mv_delta(st, r_idx, s, 0, dx, fc, field_motion)
                    _apply_mv_delta(st, r_idx, s, 1, dy, fc, field_motion)
            # Table 7-9 bookkeeping + resets (mirrors encode_picture)
            if not field_motion:
                if mb.intra:
                    st.pmv[1, 0] = st.pmv[0, 0]
                elif mb.fwd and mb.bwd:
                    st.pmv[1] = st.pmv[0]
                elif mb.fwd:
                    st.pmv[1, 0] = st.pmv[0, 0]
                elif mb.bwd:
                    st.pmv[1, 1] = st.pmv[0, 1]
            if (mb.intra and not cmv) or (
                    pct == H.PCT_P and not mb.intra and not mb.fwd):
                st.pmv[:] = 0

            if mb.intra:
                cbp = (1 << n_blocks) - 1
            elif mb.pattern:
                cbp = int(rng.integers(1, 1 << n_blocks))
            else:
                cbp = 0
            mb.cbp = cbp
            for b in range(n_blocks):
                if cbp & (1 << b):
                    dc = int(rng.integers(0, dc_max + 1)) if mb.intra else None
                    mb.blocks[b] = (dc, _random_block(rng, mb.intra, 1 if mb.intra else 0))

            prev_nonintra_pred = (mb.fwd or mb.bwd) and not mb.intra and mb.motion_type == 2
            prev_dirs = (mb.fwd, mb.bwd)
            sl.macroblocks.append(mb)
            col += 1
        pic.slices.append(sl)
    return pic
