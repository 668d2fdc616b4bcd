"""Dense per-picture token tensors — the host/device interface.

Copy of ``tiny_mp2v_dec_tpu/tokenizer/types.py`` (numpy only), so that the
port runs where the JAX package cannot be imported.

The native C++ tokenizer resolves every bit-serial,
sequential dependency of the MPEG-2 macroblock layer on the host — VLC
decode, PMV motion-vector prediction, DC prediction, quantiser-scale
tracking, skipped-macroblock semantics, dequantisation, inverse scan and
mismatch control — and emits *dense, static-shaped tensors* over the whole
picture.  Everything after this point (IDCT, motion compensation, residual
add, saturation) is data-parallel and runs on device.

This split is the accelerator-side redesign of the reference's per-macroblock
interleaved parse+reconstruct loop (reference: src/core/mb_decoder.cpp:521-641).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..headers import CHROMA_420, CHROMA_422, CHROMA_444

# Chroma geometry per format: (x_shift, y_shift, blocks_per_component)
CHROMA_INFO = {
    CHROMA_420: (1, 1, 1),
    CHROMA_422: (1, 0, 2),
    CHROMA_444: (0, 0, 4),
}


@dataclass(frozen=True)
class PictureGeometry:
    """Static shape information for one coded picture size/format."""
    width: int
    height: int
    chroma_format: int

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def n_mb(self) -> int:
        return self.mb_width * self.mb_height

    @property
    def luma_padded(self):
        return self.mb_height * 16, self.mb_width * 16

    @property
    def chroma_padded(self):
        xs, ys, _ = CHROMA_INFO[self.chroma_format]
        return (self.mb_height * 16) >> ys, (self.mb_width * 16) >> xs

    @property
    def chroma_blocks(self) -> int:
        return CHROMA_INFO[self.chroma_format][2]

    @property
    def blocks_per_mb(self) -> int:
        return 4 + 2 * self.chroma_blocks


@dataclass(frozen=True)
class PictureParams:
    """Per-picture decode parameters gathered from the headers."""
    picture_coding_type: int
    f_code: tuple  # ((f[0][0], f[0][1]), (f[1][0], f[1][1]))
    intra_dc_precision: int
    picture_structure: int
    frame_pred_frame_dct: int
    concealment_motion_vectors: int
    q_scale_type: int
    intra_vlc_format: int
    alternate_scan: int
    chroma_format: int
    vertical_size: int
    quant_matrices: np.ndarray  # (4, 64) uint8 raster order


@dataclass
class PictureTokens:
    """Reconstruction inputs for one picture.

    Block slot order within a macroblock: 4 luma blocks row-major
    ((0,0),(0,8),(8,0),(8,8)), then Cb blocks in spatial row-major order,
    then Cr blocks.  Coefficients are dequantised int16 in transposed-raster
    storage (see utils/scan.py); the DC of intra blocks is already
    prediction-resolved.

    Coefficients are SPARSE — only coded blocks are stored (coded data is
    typically a few percent of the dense volume, and the host->device upload
    is a dominant cost):
      ``cblk[:n_coded_blocks]``      (k, 64) int16 coefficient rows
      ``cblk_idx[:n_coded_blocks]``  (k,) int32 global block index
                                     (= mb_index * blocks_per_mb + slot)
    The device reconstruction scatters IDCT outputs by ``cblk_idx``; tests
    use :meth:`dense_coeff`.
    """
    geom: PictureGeometry
    cblk: np.ndarray        # (capacity, 64) int16 — rows [:n_coded_blocks] valid
    cblk_idx: np.ndarray    # (capacity,) int32
    intra: np.ndarray       # (n_mb,) bool
    fwd: np.ndarray         # (n_mb,) bool — use forward prediction
    bwd: np.ndarray         # (n_mb,) bool
    field_pred: np.ndarray  # (n_mb,) bool — field-based motion in a frame picture
    dct_type: np.ndarray    # (n_mb,) bool — field-interleaved residual layout
    mv: np.ndarray          # (n_mb, 2, 2, 2) int16 [unit r][dir s][x, y] half-pel
    mvfs: np.ndarray        # (n_mb, 2, 2) uint8 motion_vertical_field_select
    coded: np.ndarray       # (n_mb,) bool — any residual present / mb coded in slice
    # (capacity,) uint8 — nonzero count per coded row, filled DURING the
    # native parse (None from the Python tokenizer; the chunk transport
    # falls back to a counting scan then)
    row_nnz: Optional[np.ndarray] = None
    n_coded_blocks: int = 0
    # slices dropped by error containment (tokenizer on_error="drop_slice");
    # their successfully parsed prefix is retained, the rest of the picture
    # is unaffected
    bad_slices: int = 0
    _dense: Optional[np.ndarray] = field(default=None, repr=False)

    @classmethod
    def empty(cls, geom: PictureGeometry) -> "PictureTokens":
        n = geom.n_mb
        cap = n * geom.blocks_per_mb
        return cls(
            geom=geom,
            # np.empty: rows are zeroed at allocation time (alloc_block) so
            # the whole capacity never needs a memset
            cblk=np.empty((cap, 64), np.int16),
            cblk_idx=np.empty(cap, np.int32),
            intra=np.zeros(n, bool),
            fwd=np.zeros(n, bool),
            bwd=np.zeros(n, bool),
            field_pred=np.zeros(n, bool),
            dct_type=np.zeros(n, bool),
            mv=np.zeros((n, 2, 2, 2), np.int16),
            mvfs=np.zeros((n, 2, 2), np.uint8),
            coded=np.zeros(n, bool),
        )

    def alloc_block(self, mb_index: int, slot: int) -> np.ndarray:
        """Claim the next sparse row for block ``slot`` of ``mb_index``;
        returns the zeroed (64,) int16 coefficient row to fill."""
        k = self.n_coded_blocks
        self.cblk_idx[k] = mb_index * self.geom.blocks_per_mb + slot
        row = self.cblk[k]
        row.fill(0)
        self.n_coded_blocks = k + 1
        self._dense = None
        return row

    def dense_coeff(self) -> np.ndarray:
        """(n_mb, blocks_per_mb, 64) int16 densified coefficients (cached)."""
        if self._dense is None:
            n_rows = self.geom.n_mb * self.geom.blocks_per_mb
            d = np.zeros((n_rows, 64), np.int16)
            k = self.n_coded_blocks
            d[self.cblk_idx[:k]] = self.cblk[:k]
            self._dense = d.reshape(self.geom.n_mb, self.geom.blocks_per_mb, 64)
        return self._dense

    def set_dense_coeff(self, coeff: np.ndarray) -> None:
        """Adopt a dense (n_mb, blocks_per_mb, 64) array (helper for
        synthetic tokens): every block becomes a sparse row."""
        cap = self.geom.n_mb * self.geom.blocks_per_mb
        self.cblk = np.ascontiguousarray(coeff, np.int16).reshape(cap, 64)
        self.cblk_idx = np.arange(cap, dtype=np.int32)
        self.n_coded_blocks = cap
        self._dense = None
