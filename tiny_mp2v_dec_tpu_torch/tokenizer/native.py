"""ctypes wrapper around the native tokenizer (the JAX package's
``tokenizer/csrc/tokenizer.cpp``, built by :mod:`.build`)."""
from __future__ import annotations

import ctypes as C

import numpy as np

from .build import build
from .types import PictureGeometry, PictureParams, PictureTokens


class _PicParams(C.Structure):
    _fields_ = [
        ("picture_coding_type", C.c_int32),
        ("f_code", (C.c_int32 * 2) * 2),
        ("intra_dc_precision", C.c_int32),
        ("picture_structure", C.c_int32),
        ("frame_pred_frame_dct", C.c_int32),
        ("concealment_motion_vectors", C.c_int32),
        ("q_scale_type", C.c_int32),
        ("intra_vlc_format", C.c_int32),
        ("alternate_scan", C.c_int32),
        ("chroma_format", C.c_int32),
        ("vertical_size", C.c_int32),
        ("mb_width", C.c_int32),
        ("mb_height", C.c_int32),
        ("quant_matrices", (C.c_uint8 * 64) * 4),
    ]


class _TokenOut(C.Structure):
    _fields_ = [
        ("cblk", C.POINTER(C.c_int16)),
        ("cblk_idx", C.POINTER(C.c_int32)),
        ("cblk_count", C.POINTER(C.c_int32)),
        ("intra", C.POINTER(C.c_uint8)),
        ("fwd", C.POINTER(C.c_uint8)),
        ("bwd", C.POINTER(C.c_uint8)),
        ("field_pred", C.POINTER(C.c_uint8)),
        ("dct_type", C.POINTER(C.c_uint8)),
        ("coded", C.POINTER(C.c_uint8)),
        ("mv", C.POINTER(C.c_int16)),
        ("mvfs", C.POINTER(C.c_uint8)),
        ("cblk_capacity", C.c_int32),
        ("row_nnz", C.POINTER(C.c_uint8)),
    ]


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = C.CDLL(build())
        lib.mp2v_tokenize_picture.restype = C.c_int
        lib.mp2v_tokenize_picture.argtypes = [
            C.c_char_p, C.c_size_t, C.POINTER(C.c_uint64),
            C.POINTER(C.c_int32), C.c_int, C.POINTER(_PicParams),
            C.POINTER(_TokenOut), C.c_int, C.c_int, C.POINTER(C.c_int32)]
        lib.mp2v_count_pairs.restype = C.c_longlong
        lib.mp2v_count_pairs.argtypes = [
            C.POINTER(C.c_int16), C.c_int32, C.POINTER(C.c_uint8)]
        lib.mp2v_pack_pairs.restype = C.c_longlong
        lib.mp2v_pack_pairs.argtypes = [
            C.POINTER(C.c_int16), C.c_int32, C.POINTER(C.c_uint8),
            C.POINTER(C.c_int16)]
        lib.mp2v_tokenizer_abi_version.restype = C.c_int
        version = lib.mp2v_tokenizer_abi_version()
        if version != 5:
            raise RuntimeError(f"native tokenizer ABI {version}, expected 5")
        _lib = lib
    return _lib


def pair_packers():
    """(count_pairs, pack_pairs) numpy-facing wrappers of the library's
    nonzero-pair scans (the chunk transport's packing loops)."""
    lib = _load()

    def count_pairs(rows: np.ndarray, nnz_out: np.ndarray) -> int:
        _check_rows(rows)
        return int(lib.mp2v_count_pairs(
            _ptr(rows, C.c_int16), rows.shape[0], _ptr(nnz_out, C.c_uint8)))

    def pack_pairs(rows: np.ndarray, pos_out: np.ndarray,
                   val_out: np.ndarray) -> int:
        _check_rows(rows)
        return int(lib.mp2v_pack_pairs(
            _ptr(rows, C.c_int16), rows.shape[0],
            _ptr(pos_out, C.c_uint8), _ptr(val_out, C.c_int16)))

    return count_pairs, pack_pairs


def _check_rows(rows: np.ndarray) -> None:
    if rows.dtype != np.int16 or not rows.flags.c_contiguous:
        raise ValueError("coefficient rows must be C-contiguous int16")


def _ptr(arr, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


def native_tokenizer(num_threads: int = 0, on_error: str = "raise"):
    lib = _load()
    tolerate = 1 if on_error == "drop_slice" else 0

    def tokenize(data: bytes, slices, params: PictureParams,
                 geom: PictureGeometry) -> PictureTokens:
        tokens = PictureTokens.empty(geom)
        tokens.row_nnz = np.empty(tokens.cblk.shape[0], np.uint8)
        if not slices:
            return tokens
        bitpos = np.asarray([bp for bp, _ in slices], np.uint64)
        codes = np.asarray([code for _, code in slices], np.int32)

        p = _PicParams()
        p.picture_coding_type = params.picture_coding_type
        for s in range(2):
            for t in range(2):
                p.f_code[s][t] = params.f_code[s][t]
        p.intra_dc_precision = params.intra_dc_precision
        p.picture_structure = params.picture_structure
        p.frame_pred_frame_dct = params.frame_pred_frame_dct
        p.concealment_motion_vectors = params.concealment_motion_vectors
        p.q_scale_type = params.q_scale_type
        p.intra_vlc_format = params.intra_vlc_format
        p.alternate_scan = params.alternate_scan
        p.chroma_format = params.chroma_format
        p.vertical_size = params.vertical_size
        p.mb_width = geom.mb_width
        p.mb_height = geom.mb_height
        qm = np.ascontiguousarray(params.quant_matrices, np.uint8)
        C.memmove(p.quant_matrices, qm.ctypes.data, 256)

        # bool arrays are uint8-compatible in memory
        count = np.zeros(1, np.int32)
        o = _TokenOut(
            cblk=_ptr(tokens.cblk, C.c_int16),
            cblk_idx=_ptr(tokens.cblk_idx, C.c_int32),
            cblk_count=_ptr(count, C.c_int32),
            intra=_ptr(tokens.intra, C.c_uint8),
            fwd=_ptr(tokens.fwd, C.c_uint8),
            bwd=_ptr(tokens.bwd, C.c_uint8),
            field_pred=_ptr(tokens.field_pred, C.c_uint8),
            dct_type=_ptr(tokens.dct_type, C.c_uint8),
            coded=_ptr(tokens.coded, C.c_uint8),
            mv=_ptr(tokens.mv, C.c_int16),
            mvfs=_ptr(tokens.mvfs, C.c_uint8),
            cblk_capacity=tokens.cblk.shape[0],
            row_nnz=_ptr(tokens.row_nnz, C.c_uint8),
        )
        bad = np.zeros(1, np.int32)
        rc = lib.mp2v_tokenize_picture(
            data, len(data), _ptr(bitpos, C.c_uint64), _ptr(codes, C.c_int32),
            len(slices), C.byref(p), C.byref(o), num_threads, tolerate,
            bad.ctypes.data_as(C.POINTER(C.c_int32)))
        if rc != 0:
            raise ValueError(
                f"native tokenizer error {rc} (invalid VLC / run overflow / "
                f"bad MB address / coefficient capacity exceeded)")
        tokens.n_coded_blocks = int(count[0])
        tokens.bad_slices = int(bad[0])
        return tokens

    return tokenize
