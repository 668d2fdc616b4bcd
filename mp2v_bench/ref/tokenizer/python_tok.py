"""Pure-Python slice tokenizer — the golden model of the native tokenizer.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/tokenizer/python_tok.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/tokenizer/python_tok.py``, so that the port
runs where the JAX package cannot be imported.  The golden model and the
tests are its only callers: the decoder never falls back to it.

Implements the full ISO/IEC 13818-2 macroblock layer (spec 6.2.5/7.2-7.6;
reference hot path: src/core/mb_decoder.cpp:521-641, decoder.cpp:107-152) and
emits :class:`PictureTokens`.  Slices are independently decodable (the spec
resets VLC/PMV/DC state at slice start), which is what makes both the
reference's slice-level threading and our multi-core native tokenizer legal.

Conformance policy — the REFERENCE BINARY is the bit-exactness target
(enforced by tests/test_reference_bitexact.py); where its de-facto behavior
differs from ISO 13818-2 we match the reference and document it:
  * mismatch-control parity EXCLUDES the intra DC coefficient (reference
    parse_block accumulates parity only over its own output,
    mb_decoder.cpp:74-155, QFS[0] set outside at :160; spec 7.4.4 sums all
    64 — only intra_dc_precision=3 could differ, where DC may be odd).
  * chroma quant matrices W[2]/W[3] apply only to 4:2:2/4:4:4 *extension*
    blocks (bitstream index >= 6); the first chroma pair uses W[0]/W[1]
    (mb_decoder.cpp:177-196; spec 7.4.2.2 would use them for all chroma
    blocks).
  * quant-matrix defaults/downloads follow the reference's shuffle
    semantics (headers.build_quant_matrices ref_compat).

Remaining deliberate spec-over-reference choices (cases the reference
mis-parses so no bitstream-compatible behavior exists; conformance streams
avoid them, see tests/test_reference_bitexact.py docstring):
  * concealment MVs are parsed as the single vector Table 6-17 specifies
    (the reference parses two, desyncing the cursor, mb_decoder.cpp:567-574),
    and their predictor bookkeeping also runs in I pictures (spec 7.6.3.1).
  * B.14's dct_coefficient_first short form is applied only to non-intra
    blocks (the reference applies it to intra too, mb_decoder.cpp:76-88).
  * skipped B macroblocks predict from PMV unit 0 only (spec 7.6.6; the
    reference replays unit 1 over the same destination, mb_decoder.cpp:547
    — identical output whenever the previous MB used frame motion, which
    Table 7-9 guarantees keeps the units equal; only field-motion
    predecessors could differ, and real encoders do not skip after them).
"""
from __future__ import annotations

import numpy as np

from ..headers import PCT_B, PCT_I, PCT_P, PS_FRAME, quantiser_scale_from_code, SliceHeader
from ..utils.bits import BitReader
from ..utils.scan import SCAN_RASTER, TRANSPOSE64
from ..vlc import lut
from ..vlc.tables import (
    MB_INTRA, MB_MOTION_BWD, MB_MOTION_FWD, MB_PATTERN, MB_QUANT, MB_STWCF,
)
from .types import CHROMA_INFO, PictureGeometry, PictureParams, PictureTokens

# prediction_type values
PT_FIELD = 0
PT_FRAME = 1
PT_DUAL_PRIME = 2
PT_16X8 = 3

# Bitstream block index -> token slot, per chroma format.
# Token slots: luma 0-3 row-major, then Cb spatial row-major, then Cr.
_BLOCK_SLOT = {
    1: [0, 1, 2, 3, 4, 5],
    2: [0, 1, 2, 3, 4, 6, 5, 7],
    # 4:4:4 bitstream order: 4=Cb(0,0) 5=Cr(0,0) 6=Cb(8,0) 7=Cr(8,0)
    #                        8=Cb(0,8) 9=Cr(0,8) 10=Cb(8,8) 11=Cr(8,8)
    # (reference block layout: mb_decoder.cpp:182-196)
    3: [0, 1, 2, 3, 4, 8, 6, 10, 5, 9, 7, 11],
}


class _SliceState:
    __slots__ = ("pmv", "dc_pred", "qscale", "prev_fwd", "prev_bwd")

    def __init__(self, params: PictureParams, qscale_code: int):
        self.pmv = np.zeros((2, 2, 2), np.int32)  # [r][s][t]; t: 0=x, 1=y
        self.dc_pred = [1 << (params.intra_dc_precision + 7)] * 3
        self.qscale = quantiser_scale_from_code(qscale_code, params.q_scale_type)
        self.prev_fwd = False
        self.prev_bwd = False


def _decode(r: BitReader, val_lut, len_lut, maxlen: int) -> int:
    peek = r.peek(maxlen)
    length = int(len_lut[peek])
    if length == 0:
        raise ValueError(f"invalid VLC at bit {r.pos}")
    r.skip(length)
    return int(val_lut[peek])


def _decode_motion_delta(r: BitReader, f_code: int) -> int:
    code = _decode(r, lut.MOTION_VAL, lut.MOTION_LEN, lut.MOTION_MAXLEN) - 16
    if f_code != 1 and code != 0:
        residual = r.read(f_code - 1)
        delta = (abs(code) - 1) * (1 << (f_code - 1)) + residual + 1
        return -delta if code < 0 else delta
    return code


def _update_motion_predictor(pmv, r_idx, s, t, delta, f_code, field_in_frame: bool) -> int:
    """Spec 7.6.3.1 prediction + range wrap (reference mb_decoder.cpp:447-477)."""
    fsize = 1 << (f_code - 1)
    high, low, rng = 16 * fsize - 1, -16 * fsize, 32 * fsize
    prediction = int(pmv[r_idx, s, t])
    if field_in_frame and t == 1:
        prediction >>= 1
    mv = prediction + delta
    if mv < low:
        mv += rng
    if mv > high:
        mv -= rng
    pmv[r_idx, s, t] = mv * 2 if (field_in_frame and t == 1) else mv
    return mv


def _parse_motion_vector(r, st, r_idx, s, f_code_s, mv_out, field_in_frame, dmv):
    for t in (0, 1):
        delta = _decode_motion_delta(r, f_code_s[t])
        mv_out[t] = _update_motion_predictor(
            st.pmv, r_idx, s, t, delta, f_code_s[t], field_in_frame)
        if dmv:
            _decode(r, lut.DMV_VAL, lut.DMV_LEN, lut.DMV_MAXLEN)  # parse-only


def _parse_block(r: BitReader, params: PictureParams, st: _SliceState,
                 out64: np.ndarray, intra: bool, luma: bool, chroma_idx: int,
                 use_chroma_w: bool) -> None:
    """Coefficient VLC + fused dequant + inverse scan + mismatch control
    (spec 7.4; reference: mb_decoder.cpp:74-155).

    ``use_chroma_w`` selects the chroma quantiser matrices (W[2]/W[3]).
    Reference-compat policy: the reference applies them only to the
    4:2:2/4:4:4 *extension* blocks (bitstream block index >= 6,
    mb_decoder.cpp:177-196 passes W[0]/W[1] for chroma blocks 4-5 in every
    chroma format), while spec 7.4.2.2 uses them for all chroma blocks in
    4:2:2/4:4:4.  We match the reference — the bit-exactness target."""
    alt = params.alternate_scan
    w_sel = (2 if intra else 3) if use_chroma_w else (0 if intra else 1)
    W = params.quant_matrices[w_sel]
    qs = st.qscale
    use_one = bool(params.intra_vlc_format) and intra
    scan = SCAN_RASTER[alt]
    parity = 0

    if intra:
        # DC: size VLC + differential, predictor per component
        if luma:
            size = _decode(r, lut.DCSIZE_LUMA_VAL, lut.DCSIZE_LUMA_LEN, lut.DCSIZE_MAXLEN)
        else:
            size = _decode(r, lut.DCSIZE_CHROMA_VAL, lut.DCSIZE_CHROMA_LEN, lut.DCSIZE_MAXLEN)
        if size:
            diff_bits = r.read(size)
            half = 1 << (size - 1)
            diff = diff_bits if diff_bits >= half else diff_bits + 1 - 2 * half
        else:
            diff = 0
        comp = 0 if luma else chroma_idx
        st.dc_pred[comp] += diff
        dc = st.dc_pred[comp] << (3 - params.intra_dc_precision)
        out64[0] = dc
        # NOTE: the intra DC is NOT in the mismatch-control sum — the
        # reference accumulates parity only inside parse_block
        # (mb_decoder.cpp:74-155; QFS[0] is set outside it at :160).  Spec
        # 7.4.4 sums all 64 coefficients, but for intra_dc_precision<3 the
        # DC is always even so only precision 3 could differ, and the
        # reference's de-facto behavior is the bit-exactness target.
        i = 1
    else:
        i = 0
        if not use_one:
            # B.14 first-coefficient short form '1s'
            if r.peek(1) == 1:
                r.skip(1)
                sign = r.read(1)
                # the reference's first-coefficient special case applies NO
                # ±2048 saturation (mb_decoder.cpp:80-87: int16 val, direct
                # store); max value 3*255*112>>5 = 2677 fits int16
                val = (3 * int(W[0]) * qs) >> 5
                val = -val if sign else val
                out64[0] = val
                parity += val
                i = 1

    run_lut, lvl_lut, len_lut = (
        (lut.COEFF1_RUN, lut.COEFF1_LVL, lut.COEFF1_LEN) if use_one
        else (lut.COEFF0_RUN, lut.COEFF0_LVL, lut.COEFF0_LEN))

    while True:
        peek = r.peek(lut.COEFF_MAXLEN)
        length = int(len_lut[peek])
        if length == 0:
            raise ValueError(f"invalid coefficient VLC at bit {r.pos}")
        run = int(run_lut[peek])
        if run == lut.COEFF_EOB:
            r.skip(length)
            break
        if run == lut.COEFF_ESC:
            r.skip(length)
            run = r.read(6)
            level = r.read(12)
            if level & 0x800:
                level -= 0x1000
            sign = level < 0
            level = abs(level)
        else:
            level = int(lvl_lut[peek])
            r.skip(length)
            sign = r.read(1) == 1

        i += run
        if i > 63:
            raise ValueError("coefficient run past block end")
        raster = int(scan[i])
        if intra:
            val = (level * int(W[raster]) * qs) >> 4
        else:
            val = ((2 * level + 1) * int(W[raster]) * qs) >> 5
        val = -val if sign else val
        # reference saturation semantics (mb_decoder.cpp:146):
        # std::min/max<int16_t> convert the int32 product to int16 FIRST
        # (two's-complement wrap), then clamp to [-2048, 2047]
        val = ((val + 32768) & 65535) - 32768
        val = max(-2048, min(2047, val))
        out64[TRANSPOSE64[raster]] = val
        parity += val
        i += 1

    # Mismatch control (spec 7.4.4): if the coefficient sum is even, toggle
    # the LSB of F[7][7].
    if (parity & 1) == 0:
        out64[63] = np.int16(out64[63]) ^ 1


def tokenize_slice(data: bytes, slice_bit_pos: int, start_code: int,
                   params: PictureParams, geom: PictureGeometry,
                   tokens: PictureTokens) -> None:
    """Tokenize one slice into the picture's token tensors.

    ``slice_bit_pos`` is the bit position just after the 4-byte start code.
    """
    r = BitReader(data, slice_bit_pos)
    sh = SliceHeader.parse(r, start_code, params.vertical_size)
    st = _SliceState(params, sh.quantiser_scale_code)
    mb_row = sh.mb_row
    pct = params.picture_coding_type
    frame_pic = params.picture_structure == PS_FRAME
    fpfd = params.frame_pred_frame_dct
    cmv = params.concealment_motion_vectors
    cf = params.chroma_format
    n_cb = CHROMA_INFO[cf][2]
    n_blocks = 4 + 2 * n_cb
    block_slot = _BLOCK_SLOT[cf]
    mb_addr = mb_row * geom.mb_width - 1

    first_mb = True
    while True:
        # --- macroblock_address_increment (+ escapes) ---
        increment = 0
        while True:
            v = _decode(r, lut.MBA_VAL, lut.MBA_LEN, lut.MBA_MAXLEN)
            if v == lut.MBA_ESC_VALUE:
                increment += 33
            else:
                increment += v
                break

        # --- skipped macroblocks (spec 7.6.6) ---
        if increment > 1:
            if pct == PCT_P:
                st.pmv[:] = 0
            for k in range(increment - 1):
                mb_addr += 1
                m = mb_addr
                if first_mb:
                    continue  # gaps before the first MB of a slice are simply uncoded
                tokens.coded[m] = True
                tokens.dct_type[m] = False
                if pct == PCT_P:
                    tokens.fwd[m] = True
                    tokens.mv[m] = 0
                elif pct == PCT_B:
                    tokens.fwd[m] = st.prev_fwd
                    tokens.bwd[m] = st.prev_bwd
                    tokens.mv[m, 0, 0, 0] = st.pmv[0, 0, 0]
                    tokens.mv[m, 0, 0, 1] = st.pmv[0, 0, 1]
                    tokens.mv[m, 0, 1, 0] = st.pmv[0, 1, 0]
                    tokens.mv[m, 0, 1, 1] = st.pmv[0, 1, 1]
            mb_addr += 1
        else:
            mb_addr += increment
        first_mb = False
        m = mb_addr

        # --- macroblock modes (spec 6.3.17.1; reference parse_modes) ---
        val_lut, len_lut = lut.MBTYPE[pct]
        mb_type = _decode(r, val_lut, len_lut, lut.MBTYPE_MAXLEN)
        intra = bool(mb_type & MB_INTRA)
        has_fwd = bool(mb_type & MB_MOTION_FWD)
        has_bwd = bool(mb_type & MB_MOTION_BWD)
        pattern = bool(mb_type & MB_PATTERN)

        motion_type = 2  # frame-based default
        if has_fwd or has_bwd:
            if frame_pic:
                if fpfd == 0:
                    motion_type = r.read(2)
            else:
                motion_type = r.read(2)

        dct_type = False
        if frame_pic and fpfd == 0 and (intra or pattern):
            dct_type = r.read(1) == 1

        # decode prediction metadata
        if intra:
            # concealment MVs are coded as a single vector (spec 6.3.17.1
            # table 6-17; the reference instead falls into its two-vector
            # branch here, mb_decoder.cpp:507-517 with count 0)
            mv_count, mv_field, pred_type, dmv = (1 if cmv else 0), not frame_pic, (
                PT_FRAME if frame_pic else PT_FIELD), False
        else:
            mv_count, dmv = 1, False
            if frame_pic:
                if motion_type == 1:
                    mv_count, mv_field, pred_type = 2, True, PT_FIELD
                elif motion_type == 3:
                    mv_field, pred_type, dmv = True, PT_DUAL_PRIME, True
                else:
                    mv_field, pred_type = False, PT_FRAME
            else:
                if motion_type == 2:
                    mv_count, mv_field, pred_type = 2, True, PT_16X8
                elif motion_type == 3:
                    mv_field, pred_type, dmv = True, PT_DUAL_PRIME, True
                else:
                    mv_field, pred_type = True, PT_FIELD

        # --- quantiser scale update ---
        if mb_type & MB_QUANT:
            st.qscale = quantiser_scale_from_code(r.read(5), params.q_scale_type)

        # --- motion vectors ---
        mvs = np.zeros((2, 2, 2), np.int32)
        mvfs = np.zeros((2, 2), np.uint8)
        field_in_frame = mv_field and frame_pic

        def parse_direction(s):
            if mv_count == 1:
                if mv_field and not dmv:
                    mvfs[0, s] = r.read(1)
                _parse_motion_vector(r, st, 0, s, params.f_code[s], mvs[0, s],
                                     field_in_frame, dmv)
            else:
                mvfs[0, s] = r.read(1)
                _parse_motion_vector(r, st, 0, s, params.f_code[s], mvs[0, s],
                                     field_in_frame, dmv)
                mvfs[1, s] = r.read(1)
                _parse_motion_vector(r, st, 1, s, params.f_code[s], mvs[1, s],
                                     field_in_frame, dmv)

        if has_fwd or (intra and cmv):
            parse_direction(0)
        if has_bwd:
            parse_direction(1)
        if intra and cmv:
            r.skip(1)  # marker_bit

        # --- PMV bookkeeping, Table 7-9 (reference mb_decoder.cpp:580-604) ---
        if pred_type == PT_FRAME or (intra and cmv):
            if intra:
                st.pmv[1, 0] = st.pmv[0, 0]
            elif has_fwd and has_bwd:
                st.pmv[1, 0] = st.pmv[0, 0]
                st.pmv[1, 1] = st.pmv[0, 1]
            elif has_fwd:
                st.pmv[1, 0] = st.pmv[0, 0]
            elif has_bwd:
                st.pmv[1, 1] = st.pmv[0, 1]
        if pred_type == PT_DUAL_PRIME and has_fwd and not has_bwd and not intra:
            st.pmv[1, 0] = st.pmv[0, 0]

        # 7.6.3.4 predictor resets
        if (intra and not cmv) or (pct == PCT_P and not intra and not has_fwd):
            st.pmv[:] = 0
            mvs[:] = 0
            pred_type = PT_FRAME if frame_pic else PT_FIELD
            mv_count = 1 if not intra else 0
            field_in_frame = False

        # --- emit prediction tokens ---
        tokens.coded[m] = True
        tokens.intra[m] = intra
        tokens.dct_type[m] = dct_type
        if not intra:
            if pred_type == PT_DUAL_PRIME or pred_type == PT_16X8:
                # parsed but not reconstructed (reference parity:
                # mb_decoder.cpp:617-618) — residual-only output
                tokens.fwd[m] = False
                tokens.bwd[m] = False
            else:
                tokens.fwd[m] = has_fwd or (pct == PCT_P and not has_bwd)
                tokens.bwd[m] = has_bwd
                tokens.field_pred[m] = pred_type == PT_FIELD and frame_pic
                tokens.mv[m] = mvs.astype(np.int16)
                tokens.mvfs[m] = mvfs
            st.prev_fwd = bool(tokens.fwd[m])
            st.prev_bwd = bool(tokens.bwd[m])

        # --- DC predictor reset (spec 7.2.1) ---
        if increment > 1 or not intra:
            st.dc_pred = [1 << (params.intra_dc_precision + 7)] * 3

        # --- coded block pattern ---
        if intra:
            cbp = (1 << n_blocks) - 1
        elif pattern:
            base = _decode(r, lut.CBP_VAL, lut.CBP_LEN, lut.CBP_MAXLEN)
            cbp = 0
            for i in range(6):
                if base & (1 << (5 - i)):
                    cbp |= 1 << i
            if cf == 2:
                ext = r.read(2)
                for i in range(2):
                    if ext & (1 << (1 - i)):
                        cbp |= 1 << (6 + i)
            elif cf == 3:
                ext = r.read(6)
                for i in range(6):
                    if ext & (1 << (5 - i)):
                        cbp |= 1 << (6 + i)
        else:
            cbp = 0

        # --- coefficient blocks ---
        for b in range(n_blocks):
            if cbp & (1 << b):
                luma = b < 4
                chroma_idx = 0 if luma else 1 + ((b - 4) & 1)
                slot = block_slot[b]
                _parse_block(r, params, st, tokens.alloc_block(m, slot),
                             intra, luma, chroma_idx, use_chroma_w=b >= 6)

        if r.peek(23) == 0:
            break
