"""Golden end-to-end MPEG-2 decoder: pure Python/numpy, bit-exact oracle.

Frozen copy of ``tiny_mp2v_dec_tpu_torch/golden/decoder.py`` at
commit fcc0a56b588b, kept with the benchmark as its plain reference;
it imports nothing of the port, of JAX or of the JAX package.
``GoldenDecoder.picture_params`` is split out of ``_decode_picture``.
Below, the source's own text.

Copy of ``tiny_mp2v_dec_tpu/golden/decoder.py``, so that the port has a
reference of its own where the JAX package cannot be imported.

Mirrors the reference's sequence-level control flow (reference:
src/core/decoder.cpp:278-329 start-code dispatch, 346-379 display
reordering) on top of the Python tokenizer and numpy reconstruction.  The
production path (runtime/decoder.py) must produce byte-identical YUV.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from .. import headers as H
from ..tokenizer.python_tok import tokenize_slice
from ..tokenizer.types import PictureGeometry, PictureParams, PictureTokens
from .recon import reconstruct_picture


def scan_start_codes(data: bytes) -> np.ndarray:
    """Byte offsets of every 00 00 01 prefix (vectorized equivalent of the
    reference's SIMD scanner, src/core/start_codes_search.hpp:7-39)."""
    b = np.frombuffer(data, np.uint8)
    if len(b) < 4:
        return np.empty(0, np.int64)
    hits = (b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1)
    return np.nonzero(hits)[0]


@dataclass
class DecodedFrame:
    """One output frame: cropped YUV planes + display metadata."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    temporal_reference: int = 0
    picture_coding_type: int = 0

    def tobytes(self) -> bytes:
        return self.y.tobytes() + self.u.tobytes() + self.v.tobytes()


def crop_frame(planes, geom: PictureGeometry, pic: H.PictureHeader) -> DecodedFrame:
    from ..tokenizer.types import CHROMA_INFO
    xs, ys, _ = CHROMA_INFO[geom.chroma_format]
    cw = (geom.width + (1 << xs) - 1) >> xs
    ch = (geom.height + (1 << ys) - 1) >> ys
    return DecodedFrame(
        y=planes[0][:geom.height, :geom.width].copy(),
        u=planes[1][:ch, :cw].copy(),
        v=planes[2][:ch, :cw].copy(),
        temporal_reference=pic.temporal_reference,
        picture_coding_type=pic.picture_coding_type,
    )


class GoldenDecoder:
    """Decode a whole elementary stream; frames delivered via callback or
    collected in display order (``reordering=True``) or decode order."""

    def __init__(self, reordering: bool = True):
        self.reordering = reordering
        self.seq: Optional[H.SequenceHeader] = None
        self.sext = H.SequenceExtension()
        self.sscal: Optional[H.SequenceScalableExtension] = None
        self.gop: Optional[H.GroupOfPicturesHeader] = None
        # active quant-matrix extension; persists across pictures until the
        # next sequence header (spec 6.3.11)
        self.qmext: Optional[H.QuantMatrixExtension] = None
        self.frames: List[DecodedFrame] = []
        # reference planes in decode order: [older, newer]
        self._refs: List[Optional[tuple]] = [None, None]
        self._reorder_slot: Optional[DecodedFrame] = None
        self._tokens_out = None        # set by tokenize_stream

    def tokenize_stream(self, data: bytes):
        """Parse + tokenize only (no reconstruction): per-picture
        PictureTokens in decode order."""
        self._tokens_out = []
        try:
            self.decode(data)
        finally:
            out, self._tokens_out = self._tokens_out, None
        return out

    # -- per-picture state assembled during parsing --
    def _new_picture_state(self, ph: H.PictureHeader):
        return {
            "header": ph,
            "pcext": H.PictureCodingExtension(
                # MPEG-1-style defaults from the picture header f_codes
                f_code=((ph.forward_f_code, ph.forward_f_code),
                        (ph.backward_f_code, ph.backward_f_code))),
            "slices": [],
        }

    def decode(self, data: bytes) -> List[DecodedFrame]:
        offsets = scan_start_codes(data)
        cur = None
        for off in offsets:
            off = int(off)
            code = data[off + 3]
            r_pos = (off + 4) * 8
            if code == H.SEQUENCE_HEADER_CODE:
                self.seq = H.SequenceHeader.parse(H.BitReader(data, r_pos))
                # spec 6.3.11: downloaded matrices persist until the next
                # sequence header resets them
                self.qmext = None
            elif code == H.EXTENSION_START_CODE:
                r = H.BitReader(data, r_pos)
                ext_id = r.read(4)
                if ext_id == H.SEQUENCE_EXTENSION_ID:
                    self.sext = H.SequenceExtension.parse(r)
                elif ext_id == H.SEQUENCE_SCALABLE_EXTENSION_ID:
                    self.sscal = H.SequenceScalableExtension.parse(r)
                elif ext_id == H.PICTURE_CODING_EXTENSION_ID and cur is not None:
                    cur["pcext"] = H.PictureCodingExtension.parse(r)
                elif ext_id == H.QUANT_MATRIX_EXTENSION_ID:
                    self.qmext = H.QuantMatrixExtension.parse(r)
                # display/copyright/scalable picture extensions: parsed on
                # demand, no effect on reconstruction
            elif code == H.GROUP_START_CODE:
                self.gop = H.GroupOfPicturesHeader.parse(H.BitReader(data, r_pos))
            elif code == H.PICTURE_START_CODE:
                if cur is not None:
                    self._decode_picture(data, cur)
                cur = self._new_picture_state(
                    H.PictureHeader.parse(H.BitReader(data, r_pos)))
            elif code in (H.SEQUENCE_END_CODE, H.SEQUENCE_ERROR_CODE):
                break
            elif H.SLICE_START_CODE_MIN <= code <= H.SLICE_START_CODE_MAX:
                if cur is not None:
                    cur["slices"].append((r_pos, code))
        if cur is not None:
            self._decode_picture(data, cur)
        self._flush()
        return self.frames

    def picture_params(self, cur) -> tuple:
        """``(geometry, parameters)`` of the picture ``cur`` under the
        headers parsed so far (split out of ``_decode_picture`` in the
        benchmark's copy, whose reference tokenizes pictures on several
        processes)."""
        assert self.seq is not None, "no sequence header before picture"
        ph: H.PictureHeader = cur["header"]
        pcext: H.PictureCodingExtension = cur["pcext"]
        geom = PictureGeometry(
            width=self.seq.horizontal_size_value
            | (self.sext.horizontal_size_extension << 12),
            height=self.seq.vertical_size_value
            | (self.sext.vertical_size_extension << 12),
            chroma_format=self.sext.chroma_format,
        )
        params = PictureParams(
            picture_coding_type=ph.picture_coding_type,
            f_code=pcext.f_code,
            intra_dc_precision=pcext.intra_dc_precision,
            picture_structure=pcext.picture_structure,
            frame_pred_frame_dct=pcext.frame_pred_frame_dct,
            concealment_motion_vectors=pcext.concealment_motion_vectors,
            q_scale_type=pcext.q_scale_type,
            intra_vlc_format=pcext.intra_vlc_format,
            alternate_scan=pcext.alternate_scan,
            chroma_format=self.sext.chroma_format,
            vertical_size=geom.height,
            quant_matrices=H.build_quant_matrices(self.seq, self.qmext),
        )
        return geom, params

    def _decode_picture(self, data: bytes, cur) -> None:
        ph: H.PictureHeader = cur["header"]
        geom, params = self.picture_params(cur)
        tokens = PictureTokens.empty(geom)
        for bit_pos, code in cur["slices"]:
            tokenize_slice(data, bit_pos, code, params, geom, tokens)
        if self._tokens_out is not None:
            self._tokens_out.append(tokens)
            return

        if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
            ref0, ref1 = self._refs[1], None
        else:
            ref0, ref1 = self._refs[0], self._refs[1]
        planes = reconstruct_picture(tokens, ref0=ref0, ref1=ref1)
        frame = crop_frame(planes, geom, ph)

        if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
            self._refs = [self._refs[1], planes]
            if self.reordering:
                if self._reorder_slot is not None:
                    self.frames.append(self._reorder_slot)
                self._reorder_slot = frame
            else:
                self.frames.append(frame)
        else:
            self.frames.append(frame)

    def _flush(self) -> None:
        if self._reorder_slot is not None:
            self.frames.append(self._reorder_slot)
            self._reorder_slot = None


def decode_stream(data: bytes, reordering: bool = True) -> List[DecodedFrame]:
    return GoldenDecoder(reordering=reordering).decode(data)
