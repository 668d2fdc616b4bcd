"""Flat lookup tables derived from the canonical Annex-B code tables.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/vlc/lut.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/vlc/lut.py`` (numpy only), so that the port
runs where the JAX package cannot be imported.

Decode strategy: peek ``maxlen`` bits once and index a dense 2**maxlen LUT
that yields (payload, code length) — a single table hit per symbol instead of
the reference's count-leading-zeros two-level scheme (reference:
src/core/mp2v_vlc_dec.hpp).  The same LUTs are generated into the C++
tokenizer, so Python and native decode paths are table-identical by
construction.

Building the LUT also *validates* the canonical tables: any pair of codes
where one is a prefix of the other would collide while filling and raises.
"""
from __future__ import annotations

import numpy as np

from . import tables as T

# Sentinel payloads for the coefficient LUTs
COEFF_EOB = 64
COEFF_ESC = 65
INVALID = -1


def build_lut(entries, maxlen: int, n_payload: int = 1):
    """entries: iterable of (code, length, *payload).

    Returns (payload_luts, len_lut): each payload LUT is an int16 array of
    size 2**maxlen; len_lut is int8 with 0 marking an invalid/unassigned code.
    """
    size = 1 << maxlen
    len_lut = np.zeros(size, dtype=np.int8)
    payload_luts = [np.full(size, INVALID, dtype=np.int16) for _ in range(n_payload)]
    for entry in entries:
        code, length, *payload = entry
        assert 0 < length <= maxlen, entry
        assert len(payload) == n_payload, entry
        base = code << (maxlen - length)
        span = 1 << (maxlen - length)
        if len_lut[base:base + span].any():
            raise ValueError(f"VLC overlap at {entry}")
        len_lut[base:base + span] = length
        for lut, p in zip(payload_luts, payload):
            lut[base:base + span] = p
    return payload_luts, len_lut


def _from_dict(d):
    return [(code, length, value) for value, (code, length) in d.items()]


# --- macroblock_address_increment (B.1): 11-bit peek ------------------------
MBA_MAXLEN = 11
MBA_ESC_VALUE = 99
(_mba_val,), MBA_LEN = build_lut(
    _from_dict(T.MBA) + [(T.MBA_ESCAPE[0], T.MBA_ESCAPE[1], MBA_ESC_VALUE)],
    MBA_MAXLEN)
MBA_VAL = _mba_val

# --- macroblock_type (B.2-B.8): 9-bit peek ----------------------------------
MBTYPE_MAXLEN = 9


def _mbtype_lut(table):
    (val,), ln = build_lut([(c, l, f) for (c, l), f in table], MBTYPE_MAXLEN)
    return val, ln


MBTYPE = {
    1: _mbtype_lut(T.MB_TYPE_I),
    2: _mbtype_lut(T.MB_TYPE_P),
    3: _mbtype_lut(T.MB_TYPE_B),
}
MBTYPE_SS = {
    1: _mbtype_lut(T.MB_TYPE_SS_I),
    2: _mbtype_lut(T.MB_TYPE_SS_P),
    3: _mbtype_lut(T.MB_TYPE_SS_B),
}
MBTYPE_SNR = _mbtype_lut(T.MB_TYPE_SNR)

# --- coded_block_pattern (B.9): 9-bit peek ----------------------------------
CBP_MAXLEN = 9
(CBP_VAL,), CBP_LEN = build_lut(_from_dict(T.CBP), CBP_MAXLEN)

# --- motion_code (B.10): 11-bit peek; payload stored as value+16 ------------
MOTION_MAXLEN = 11
(_mv_val,), MOTION_LEN = build_lut(
    [(c, l, v + 16) for v, (c, l) in T.MOTION_CODE.items()], MOTION_MAXLEN)
MOTION_VAL = _mv_val  # subtract 16 after lookup

# --- dmvector (B.11): 2-bit peek --------------------------------------------
DMV_MAXLEN = 2
(_dmv_val,), DMV_LEN = build_lut(
    [(c, l, v + 1) for v, (c, l) in T.DMVECTOR.items()], DMV_MAXLEN)
DMV_VAL = _dmv_val  # subtract 1 after lookup

# --- dct_dc_size (B.12/B.13) ------------------------------------------------
DCSIZE_MAXLEN = 10
(DCSIZE_LUMA_VAL,), DCSIZE_LUMA_LEN = build_lut(_from_dict(T.DCT_SIZE_LUMA), DCSIZE_MAXLEN)
(DCSIZE_CHROMA_VAL,), DCSIZE_CHROMA_LEN = build_lut(_from_dict(T.DCT_SIZE_CHROMA), DCSIZE_MAXLEN)

# --- DCT coefficients (B.14/B.15): 16-bit peek ------------------------------
COEFF_MAXLEN = 16


def _coeff_lut(table, eob):
    entries = [(c, l, run, lvl) for (c, l, run, lvl) in table]
    entries.append((eob[0], eob[1], COEFF_EOB, 0))
    entries.append((T.COEFF_ESCAPE[0], T.COEFF_ESCAPE[1], COEFF_ESC, 0))
    (run, lvl), ln = build_lut(entries, COEFF_MAXLEN, n_payload=2)
    return run, lvl, ln


# B.14: note the table's (0b11,2,run0,level1) entry is the "subsequent
# coefficient" form; the first-coefficient '1s' form is special-cased by the
# tokenizer before consulting this LUT.
COEFF0_RUN, COEFF0_LVL, COEFF0_LEN = _coeff_lut(T.COEFF_ZERO, T.EOB_ZERO)
COEFF1_RUN, COEFF1_LVL, COEFF1_LEN = _coeff_lut(T.COEFF_ONE, T.EOB_ONE)
