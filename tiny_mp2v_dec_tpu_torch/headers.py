"""ISO/IEC 13818-2 syntax-layer headers: dataclasses, parsers, serializers.

Covers every header/extension the reference parses (reference:
src/core/mp2v_hdr.h:61-327, mp2v_hdr.cpp) — sequence header, sequence /
display / scalable extensions, GOP, picture header, picture coding extension,
quant matrix extension, picture display extension, temporal & spatial
scalable extensions, copyright extension, slice header.  Unlike the
reference we also implement the *serializers*, which drive the synthetic
stream generator used by the end-to-end tests.

Headers are pure host-side control flow (a few hundred bits per picture), so
plain Python is the right tool; the hot bit-serial work lives in the
tokenizer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .utils.bits import BitReader, BitWriter
from .utils.scan import (
    DEFAULT_INTRA_QUANT_MATRIX,
    DEFAULT_NON_INTRA_QUANT_MATRIX,
    dezigzag,
)

# Start codes (13818-2 table 6-1)
PICTURE_START_CODE = 0x00
SLICE_START_CODE_MIN = 0x01
SLICE_START_CODE_MAX = 0xAF
USER_DATA_START_CODE = 0xB2
SEQUENCE_HEADER_CODE = 0xB3
SEQUENCE_ERROR_CODE = 0xB4
EXTENSION_START_CODE = 0xB5
SEQUENCE_END_CODE = 0xB7
GROUP_START_CODE = 0xB8

# Extension ids (table 6-2)
SEQUENCE_EXTENSION_ID = 1
SEQUENCE_DISPLAY_EXTENSION_ID = 2
QUANT_MATRIX_EXTENSION_ID = 3
COPYRIGHT_EXTENSION_ID = 4
SEQUENCE_SCALABLE_EXTENSION_ID = 5
PICTURE_DISPLAY_EXTENSION_ID = 7
PICTURE_CODING_EXTENSION_ID = 8
PICTURE_SPATIAL_SCALABLE_EXTENSION_ID = 9
PICTURE_TEMPORAL_SCALABLE_EXTENSION_ID = 10
PICTURE_CAMERA_PARAMETERS_EXTENSION_ID = 11

# Scalable modes (6.3.8)
SCALABLE_MODE_DATA_PARTITIONING = 0
SCALABLE_MODE_SPATIAL = 1
SCALABLE_MODE_SNR = 2
SCALABLE_MODE_TEMPORAL = 3

# Picture structure (table 6-14)
PS_TOP_FIELD = 1
PS_BOTTOM_FIELD = 2
PS_FRAME = 3

# Picture coding type (table 6-12)
PCT_I = 1
PCT_P = 2
PCT_B = 3

# Chroma format (table 6-5)
CHROMA_420 = 1
CHROMA_422 = 2
CHROMA_444 = 3


@dataclass
class SequenceHeader:
    horizontal_size_value: int = 0
    vertical_size_value: int = 0
    aspect_ratio_information: int = 1
    frame_rate_code: int = 1
    bit_rate_value: int = 0x3FFFF
    vbv_buffer_size_value: int = 0
    constrained_parameters_flag: int = 0
    load_intra_quantiser_matrix: int = 0
    intra_quantiser_matrix: Optional[np.ndarray] = None      # raster order
    load_non_intra_quantiser_matrix: int = 0
    non_intra_quantiser_matrix: Optional[np.ndarray] = None  # raster order

    @classmethod
    def parse(cls, r: BitReader) -> "SequenceHeader":
        h = cls()
        h.horizontal_size_value = r.read(12)
        h.vertical_size_value = r.read(12)
        h.aspect_ratio_information = r.read(4)
        h.frame_rate_code = r.read(4)
        h.bit_rate_value = r.read(18)
        r.skip(1)  # marker
        h.vbv_buffer_size_value = r.read(10)
        h.constrained_parameters_flag = r.read(1)
        h.load_intra_quantiser_matrix = r.read(1)
        if h.load_intra_quantiser_matrix:
            h.intra_quantiser_matrix = dezigzag([r.read(8) for _ in range(64)])
        h.load_non_intra_quantiser_matrix = r.read(1)
        if h.load_non_intra_quantiser_matrix:
            h.non_intra_quantiser_matrix = dezigzag([r.read(8) for _ in range(64)])
        return h

    def write(self, w: BitWriter) -> None:
        from .utils.scan import SCAN_RASTER
        w.start_code(SEQUENCE_HEADER_CODE)
        w.write(self.horizontal_size_value, 12)
        w.write(self.vertical_size_value, 12)
        w.write(self.aspect_ratio_information, 4)
        w.write(self.frame_rate_code, 4)
        w.write(self.bit_rate_value, 18)
        w.write(1, 1)
        w.write(self.vbv_buffer_size_value, 10)
        w.write(self.constrained_parameters_flag, 1)
        w.write(self.load_intra_quantiser_matrix, 1)
        if self.load_intra_quantiser_matrix:
            for pos in SCAN_RASTER[0]:
                w.write(int(self.intra_quantiser_matrix[pos]), 8)
        w.write(self.load_non_intra_quantiser_matrix, 1)
        if self.load_non_intra_quantiser_matrix:
            for pos in SCAN_RASTER[0]:
                w.write(int(self.non_intra_quantiser_matrix[pos]), 8)


@dataclass
class SequenceExtension:
    profile_and_level_indication: int = 0x48  # MP@HL
    progressive_sequence: int = 1
    chroma_format: int = CHROMA_420
    horizontal_size_extension: int = 0
    vertical_size_extension: int = 0
    bit_rate_extension: int = 0
    vbv_buffer_size_extension: int = 0
    low_delay: int = 0
    frame_rate_extension_n: int = 0
    frame_rate_extension_d: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "SequenceExtension":
        e = cls()
        e.profile_and_level_indication = r.read(8)
        e.progressive_sequence = r.read(1)
        e.chroma_format = r.read(2)
        e.horizontal_size_extension = r.read(2)
        e.vertical_size_extension = r.read(2)
        e.bit_rate_extension = r.read(12)
        r.skip(1)  # marker
        e.vbv_buffer_size_extension = r.read(8)
        e.low_delay = r.read(1)
        e.frame_rate_extension_n = r.read(2)
        e.frame_rate_extension_d = r.read(5)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(SEQUENCE_EXTENSION_ID, 4)
        w.write(self.profile_and_level_indication, 8)
        w.write(self.progressive_sequence, 1)
        w.write(self.chroma_format, 2)
        w.write(self.horizontal_size_extension, 2)
        w.write(self.vertical_size_extension, 2)
        w.write(self.bit_rate_extension, 12)
        w.write(1, 1)
        w.write(self.vbv_buffer_size_extension, 8)
        w.write(self.low_delay, 1)
        w.write(self.frame_rate_extension_n, 2)
        w.write(self.frame_rate_extension_d, 5)


@dataclass
class SequenceDisplayExtension:
    video_format: int = 0
    colour_description: int = 0
    colour_primaries: int = 1
    transfer_characteristics: int = 1
    matrix_coefficients: int = 1
    display_horizontal_size: int = 0
    display_vertical_size: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "SequenceDisplayExtension":
        e = cls()
        e.video_format = r.read(3)
        e.colour_description = r.read(1)
        if e.colour_description:
            e.colour_primaries = r.read(8)
            e.transfer_characteristics = r.read(8)
            e.matrix_coefficients = r.read(8)
        e.display_horizontal_size = r.read(14)
        r.skip(1)  # marker
        e.display_vertical_size = r.read(14)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(SEQUENCE_DISPLAY_EXTENSION_ID, 4)
        w.write(self.video_format, 3)
        w.write(self.colour_description, 1)
        if self.colour_description:
            w.write(self.colour_primaries, 8)
            w.write(self.transfer_characteristics, 8)
            w.write(self.matrix_coefficients, 8)
        w.write(self.display_horizontal_size, 14)
        w.write(1, 1)
        w.write(self.display_vertical_size, 14)


@dataclass
class SequenceScalableExtension:
    scalable_mode: int = 0
    layer_id: int = 0
    lower_layer_prediction_horizontal_size: int = 0
    lower_layer_prediction_vertical_size: int = 0
    horizontal_subsampling_factor_m: int = 1
    horizontal_subsampling_factor_n: int = 1
    vertical_subsampling_factor_m: int = 1
    vertical_subsampling_factor_n: int = 1
    picture_mux_enable: int = 0
    mux_to_progressive_sequence: int = 0
    picture_mux_order: int = 0
    picture_mux_factor: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "SequenceScalableExtension":
        e = cls()
        e.scalable_mode = r.read(2)
        e.layer_id = r.read(4)
        if e.scalable_mode == SCALABLE_MODE_SPATIAL:
            e.lower_layer_prediction_horizontal_size = r.read(14)
            r.skip(1)
            e.lower_layer_prediction_vertical_size = r.read(14)
            e.horizontal_subsampling_factor_m = r.read(5)
            e.horizontal_subsampling_factor_n = r.read(5)
            e.vertical_subsampling_factor_m = r.read(5)
            e.vertical_subsampling_factor_n = r.read(5)
        elif e.scalable_mode == SCALABLE_MODE_TEMPORAL:
            e.picture_mux_enable = r.read(1)
            if e.picture_mux_enable:
                e.mux_to_progressive_sequence = r.read(1)
            e.picture_mux_order = r.read(3)
            e.picture_mux_factor = r.read(3)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(SEQUENCE_SCALABLE_EXTENSION_ID, 4)
        w.write(self.scalable_mode, 2)
        w.write(self.layer_id, 4)
        if self.scalable_mode == SCALABLE_MODE_SPATIAL:
            w.write(self.lower_layer_prediction_horizontal_size, 14)
            w.write(1, 1)
            w.write(self.lower_layer_prediction_vertical_size, 14)
            w.write(self.horizontal_subsampling_factor_m, 5)
            w.write(self.horizontal_subsampling_factor_n, 5)
            w.write(self.vertical_subsampling_factor_m, 5)
            w.write(self.vertical_subsampling_factor_n, 5)
        elif self.scalable_mode == SCALABLE_MODE_TEMPORAL:
            w.write(self.picture_mux_enable, 1)
            if self.picture_mux_enable:
                w.write(self.mux_to_progressive_sequence, 1)
            w.write(self.picture_mux_order, 3)
            w.write(self.picture_mux_factor, 3)


@dataclass
class GroupOfPicturesHeader:
    time_code: int = 0
    closed_gop: int = 1
    broken_link: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "GroupOfPicturesHeader":
        g = cls()
        g.time_code = r.read(25)
        g.closed_gop = r.read(1)
        g.broken_link = r.read(1)
        return g

    def write(self, w: BitWriter) -> None:
        w.start_code(GROUP_START_CODE)
        w.write(self.time_code, 25)
        w.write(self.closed_gop, 1)
        w.write(self.broken_link, 1)


@dataclass
class PictureHeader:
    temporal_reference: int = 0
    picture_coding_type: int = PCT_I
    vbv_delay: int = 0xFFFF
    full_pel_forward_vector: int = 0
    forward_f_code: int = 7
    full_pel_backward_vector: int = 0
    backward_f_code: int = 7

    @classmethod
    def parse(cls, r: BitReader) -> "PictureHeader":
        p = cls()
        p.temporal_reference = r.read(10)
        p.picture_coding_type = r.read(3)
        p.vbv_delay = r.read(16)
        if p.picture_coding_type in (PCT_P, PCT_B):
            p.full_pel_forward_vector = r.read(1)
            p.forward_f_code = r.read(3)
        if p.picture_coding_type == PCT_B:
            p.full_pel_backward_vector = r.read(1)
            p.backward_f_code = r.read(3)
        return p

    def write(self, w: BitWriter) -> None:
        w.start_code(PICTURE_START_CODE)
        w.write(self.temporal_reference, 10)
        w.write(self.picture_coding_type, 3)
        w.write(self.vbv_delay, 16)
        if self.picture_coding_type in (PCT_P, PCT_B):
            w.write(self.full_pel_forward_vector, 1)
            w.write(self.forward_f_code, 3)
        if self.picture_coding_type == PCT_B:
            w.write(self.full_pel_backward_vector, 1)
            w.write(self.backward_f_code, 3)


@dataclass
class PictureCodingExtension:
    f_code: tuple = ((15, 15), (15, 15))  # [s][t]
    intra_dc_precision: int = 0
    picture_structure: int = PS_FRAME
    top_field_first: int = 0
    frame_pred_frame_dct: int = 1
    concealment_motion_vectors: int = 0
    q_scale_type: int = 0
    intra_vlc_format: int = 0
    alternate_scan: int = 0
    repeat_first_field: int = 0
    chroma_420_type: int = 0
    progressive_frame: int = 1
    composite_display_flag: int = 0
    v_axis: int = 0
    field_sequence: int = 0
    sub_carrier: int = 0
    burst_amplitude: int = 0
    sub_carrier_phase: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "PictureCodingExtension":
        e = cls()
        e.f_code = ((r.read(4), r.read(4)), (r.read(4), r.read(4)))
        e.intra_dc_precision = r.read(2)
        e.picture_structure = r.read(2)
        e.top_field_first = r.read(1)
        e.frame_pred_frame_dct = r.read(1)
        e.concealment_motion_vectors = r.read(1)
        e.q_scale_type = r.read(1)
        e.intra_vlc_format = r.read(1)
        e.alternate_scan = r.read(1)
        e.repeat_first_field = r.read(1)
        e.chroma_420_type = r.read(1)
        e.progressive_frame = r.read(1)
        e.composite_display_flag = r.read(1)
        if e.composite_display_flag:
            e.v_axis = r.read(1)
            e.field_sequence = r.read(3)
            e.sub_carrier = r.read(1)
            e.burst_amplitude = r.read(7)
            e.sub_carrier_phase = r.read(8)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(PICTURE_CODING_EXTENSION_ID, 4)
        for s in range(2):
            for t in range(2):
                w.write(self.f_code[s][t], 4)
        w.write(self.intra_dc_precision, 2)
        w.write(self.picture_structure, 2)
        w.write(self.top_field_first, 1)
        w.write(self.frame_pred_frame_dct, 1)
        w.write(self.concealment_motion_vectors, 1)
        w.write(self.q_scale_type, 1)
        w.write(self.intra_vlc_format, 1)
        w.write(self.alternate_scan, 1)
        w.write(self.repeat_first_field, 1)
        w.write(self.chroma_420_type, 1)
        w.write(self.progressive_frame, 1)
        w.write(self.composite_display_flag, 1)
        if self.composite_display_flag:
            w.write(self.v_axis, 1)
            w.write(self.field_sequence, 3)
            w.write(self.sub_carrier, 1)
            w.write(self.burst_amplitude, 7)
            w.write(self.sub_carrier_phase, 8)


@dataclass
class QuantMatrixExtension:
    load_intra_quantiser_matrix: int = 0
    intra_quantiser_matrix: Optional[np.ndarray] = None
    load_non_intra_quantiser_matrix: int = 0
    non_intra_quantiser_matrix: Optional[np.ndarray] = None
    load_chroma_intra_quantiser_matrix: int = 0
    chroma_intra_quantiser_matrix: Optional[np.ndarray] = None
    load_chroma_non_intra_quantiser_matrix: int = 0
    chroma_non_intra_quantiser_matrix: Optional[np.ndarray] = None

    @classmethod
    def parse(cls, r: BitReader) -> "QuantMatrixExtension":
        e = cls()
        for load_attr, mat_attr in (
            ("load_intra_quantiser_matrix", "intra_quantiser_matrix"),
            ("load_non_intra_quantiser_matrix", "non_intra_quantiser_matrix"),
            ("load_chroma_intra_quantiser_matrix", "chroma_intra_quantiser_matrix"),
            ("load_chroma_non_intra_quantiser_matrix", "chroma_non_intra_quantiser_matrix"),
        ):
            flag = r.read(1)
            setattr(e, load_attr, flag)
            if flag:
                setattr(e, mat_attr, dezigzag([r.read(8) for _ in range(64)]))
        return e

    def write(self, w: BitWriter) -> None:
        from .utils.scan import SCAN_RASTER
        w.start_code(EXTENSION_START_CODE)
        w.write(QUANT_MATRIX_EXTENSION_ID, 4)
        for load_attr, mat_attr in (
            ("load_intra_quantiser_matrix", "intra_quantiser_matrix"),
            ("load_non_intra_quantiser_matrix", "non_intra_quantiser_matrix"),
            ("load_chroma_intra_quantiser_matrix", "chroma_intra_quantiser_matrix"),
            ("load_chroma_non_intra_quantiser_matrix", "chroma_non_intra_quantiser_matrix"),
        ):
            flag = getattr(self, load_attr)
            w.write(flag, 1)
            if flag:
                mat = getattr(self, mat_attr)
                for pos in SCAN_RASTER[0]:
                    w.write(int(mat[pos]), 8)


@dataclass
class PictureDisplayExtension:
    frame_centre_horizontal_offset: list = field(default_factory=list)
    frame_centre_vertical_offset: list = field(default_factory=list)

    @staticmethod
    def num_frame_centre_offsets(sext: SequenceExtension, pcext: PictureCodingExtension) -> int:
        """Spec 6.3.12 number_of_frame_centre_offsets."""
        if sext.progressive_sequence:
            if pcext.repeat_first_field:
                return 3 if pcext.top_field_first else 2
            return 1
        if pcext.picture_structure in (PS_TOP_FIELD, PS_BOTTOM_FIELD):
            return 1
        return 3 if pcext.repeat_first_field else 2

    @classmethod
    def parse(cls, r: BitReader, sext: SequenceExtension,
              pcext: PictureCodingExtension) -> "PictureDisplayExtension":
        e = cls()
        for _ in range(cls.num_frame_centre_offsets(sext, pcext)):
            h = r.read(16)
            r.skip(1)
            v = r.read(16)
            r.skip(1)
            e.frame_centre_horizontal_offset.append(h - 0x10000 if h & 0x8000 else h)
            e.frame_centre_vertical_offset.append(v - 0x10000 if v & 0x8000 else v)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(PICTURE_DISPLAY_EXTENSION_ID, 4)
        for h, v in zip(self.frame_centre_horizontal_offset,
                        self.frame_centre_vertical_offset):
            w.write(h & 0xFFFF, 16)
            w.write(1, 1)
            w.write(v & 0xFFFF, 16)
            w.write(1, 1)


@dataclass
class PictureTemporalScalableExtension:
    reference_select_code: int = 0
    forward_temporal_reference: int = 0
    backward_temporal_reference: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "PictureTemporalScalableExtension":
        e = cls()
        e.reference_select_code = r.read(2)
        e.forward_temporal_reference = r.read(10)
        r.skip(1)
        e.backward_temporal_reference = r.read(10)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(PICTURE_TEMPORAL_SCALABLE_EXTENSION_ID, 4)
        w.write(self.reference_select_code, 2)
        w.write(self.forward_temporal_reference, 10)
        w.write(1, 1)
        w.write(self.backward_temporal_reference, 10)


@dataclass
class PictureSpatialScalableExtension:
    lower_layer_temporal_reference: int = 0
    lower_layer_horizontal_offset: int = 0
    lower_layer_vertical_offset: int = 0
    spatial_temporal_weight_code_table_index: int = 0
    lower_layer_progressive_frame: int = 1
    lower_layer_deinterlaced_field_select: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "PictureSpatialScalableExtension":
        e = cls()
        e.lower_layer_temporal_reference = r.read(10)
        r.skip(1)
        h = r.read(15)
        e.lower_layer_horizontal_offset = h - 0x8000 if h & 0x4000 else h
        r.skip(1)
        v = r.read(15)
        e.lower_layer_vertical_offset = v - 0x8000 if v & 0x4000 else v
        e.spatial_temporal_weight_code_table_index = r.read(2)
        e.lower_layer_progressive_frame = r.read(1)
        e.lower_layer_deinterlaced_field_select = r.read(1)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(PICTURE_SPATIAL_SCALABLE_EXTENSION_ID, 4)
        w.write(self.lower_layer_temporal_reference, 10)
        w.write(1, 1)
        w.write(self.lower_layer_horizontal_offset & 0x7FFF, 15)
        w.write(1, 1)
        w.write(self.lower_layer_vertical_offset & 0x7FFF, 15)
        w.write(self.spatial_temporal_weight_code_table_index, 2)
        w.write(self.lower_layer_progressive_frame, 1)
        w.write(self.lower_layer_deinterlaced_field_select, 1)


@dataclass
class CopyrightExtension:
    copyright_flag: int = 0
    copyright_identifier: int = 0
    original_or_copy: int = 0
    copyright_number_1: int = 0
    copyright_number_2: int = 0
    copyright_number_3: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "CopyrightExtension":
        e = cls()
        e.copyright_flag = r.read(1)
        e.copyright_identifier = r.read(8)
        e.original_or_copy = r.read(1)
        r.skip(7)  # reserved
        r.skip(1)
        e.copyright_number_1 = r.read(20)
        r.skip(1)
        e.copyright_number_2 = r.read(22)
        r.skip(1)
        e.copyright_number_3 = r.read(22)
        return e

    def write(self, w: BitWriter) -> None:
        w.start_code(EXTENSION_START_CODE)
        w.write(COPYRIGHT_EXTENSION_ID, 4)
        w.write(self.copyright_flag, 1)
        w.write(self.copyright_identifier, 8)
        w.write(self.original_or_copy, 1)
        w.write(0, 7)
        w.write(1, 1)
        w.write(self.copyright_number_1, 20)
        w.write(1, 1)
        w.write(self.copyright_number_2, 22)
        w.write(1, 1)
        w.write(self.copyright_number_3, 22)


@dataclass
class SliceHeader:
    slice_vertical_position: int = 1  # low 8 bits of the start code
    slice_vertical_position_extension: int = 0
    priority_breakpoint: int = 0
    quantiser_scale_code: int = 1
    intra_slice_flag: int = 0
    intra_slice: int = 0
    slice_picture_id_enable: int = 0
    slice_picture_id: int = 0

    @classmethod
    def parse(cls, r: BitReader, start_code: int, vertical_size: int,
              scalable: Optional[SequenceScalableExtension] = None) -> "SliceHeader":
        """Parse the slice header fields following the start code (spec 6.2.4).
        ``r`` must be positioned just after the 4-byte start code."""
        s = cls()
        s.slice_vertical_position = start_code & 0xFF
        if vertical_size > 2800:
            s.slice_vertical_position_extension = r.read(3)
        if scalable is not None and scalable.scalable_mode == SCALABLE_MODE_DATA_PARTITIONING:
            s.priority_breakpoint = r.read(7)
        s.quantiser_scale_code = r.read(5)
        if r.peek(1) == 1:
            s.intra_slice_flag = r.read(1)
            s.intra_slice = r.read(1)
            s.slice_picture_id_enable = r.read(1)
            s.slice_picture_id = r.read(6)
            while r.peek(1) == 1:
                r.skip(9)  # extra_information_slice
        r.skip(1)  # extra_bit_slice == 0
        return s

    @property
    def mb_row(self) -> int:
        return (self.slice_vertical_position_extension << 7) + self.slice_vertical_position - 1

    def write(self, w: BitWriter, vertical_size: int,
              scalable: Optional[SequenceScalableExtension] = None) -> None:
        w.start_code(self.slice_vertical_position)
        if vertical_size > 2800:
            w.write(self.slice_vertical_position_extension, 3)
        if scalable is not None and scalable.scalable_mode == SCALABLE_MODE_DATA_PARTITIONING:
            w.write(self.priority_breakpoint, 7)
        w.write(self.quantiser_scale_code, 5)
        if self.intra_slice_flag:
            w.write(1, 1)
            w.write(self.intra_slice, 1)
            w.write(self.slice_picture_id_enable, 1)
            w.write(self.slice_picture_id, 6)
        w.write(0, 1)  # extra_bit_slice


def quantiser_scale_from_code(code: int, q_scale_type: int) -> int:
    """Table 7-6 quantiser_scale mapping."""
    if not q_scale_type:
        return code << 1
    if code < 9:
        return code
    if code < 17:
        return (code - 4) << 1
    if code < 25:
        return (code - 10) << 2
    return (code - 17) << 3


def build_quant_matrices(seq: SequenceHeader,
                         qmext: Optional[QuantMatrixExtension],
                         ref_compat: bool = True) -> np.ndarray:
    """Return the four active quantiser matrices (raster order), indexed
    0: intra, 1: non-intra, 2: chroma-intra, 3: chroma-non-intra
    (spec 6.3.7/6.3.11: sequence-header downloads update intra/non-intra for
    all components; a quant matrix extension can additionally override the
    chroma matrices for 4:2:2/4:4:4).

    ``ref_compat=True`` reproduces the reference decoder's de-facto quant
    behavior for bit-exact output parity (reference decoder.cpp:167-191):
    (a) its built-in default intra matrix constant is stored in raster order
    (decoder.cpp:10-19) but run through the zigzag de-shuffle meant for
    bitstream-downloaded (scan-order) matrices, so the effective default
    weight at scan position i is the raster table read *at* i — replicated
    here by dezigzagging the raster constant; and (b) sequence-header
    downloaded matrices are ignored (only the quant-matrix-extension path
    applies downloads, which it does spec-correctly).  ``ref_compat=False``
    gives the ISO 13818-2 behavior."""
    if ref_compat:
        intra = dezigzag(DEFAULT_INTRA_QUANT_MATRIX)
        non_intra = DEFAULT_NON_INTRA_QUANT_MATRIX  # flat 16s: shuffle-invariant
    else:
        intra = seq.intra_quantiser_matrix if seq.load_intra_quantiser_matrix \
            else DEFAULT_INTRA_QUANT_MATRIX
        non_intra = seq.non_intra_quantiser_matrix if seq.load_non_intra_quantiser_matrix \
            else DEFAULT_NON_INTRA_QUANT_MATRIX
    w = np.stack([intra, non_intra, intra, non_intra]).astype(np.uint8)
    if qmext is not None:
        if qmext.load_intra_quantiser_matrix:
            w[0] = qmext.intra_quantiser_matrix
            w[2] = qmext.intra_quantiser_matrix
        if qmext.load_non_intra_quantiser_matrix:
            w[1] = qmext.non_intra_quantiser_matrix
            w[3] = qmext.non_intra_quantiser_matrix
        if qmext.load_chroma_intra_quantiser_matrix:
            w[2] = qmext.chroma_intra_quantiser_matrix
        if qmext.load_chroma_non_intra_quantiser_matrix:
            w[3] = qmext.chroma_non_intra_quantiser_matrix
    return w
