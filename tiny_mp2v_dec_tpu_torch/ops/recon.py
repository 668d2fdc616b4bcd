"""Device reconstruction of GOP chunks: transport, IDCT, fused MC.

Counterpart of ``tiny_mp2v_dec_tpu/ops/recon.py`` for frame-prediction
4:2:0 content.  :class:`GopRecon` decodes a chunk of pictures:

1. :meth:`GopRecon.prepare` (host, numpy) packs the chunk's nonzero
   coefficients as (column, value) pairs, per-row nonzero counts, block
   positions, per-picture row counts, step flags and per-MB metadata into
   one uint8 blob, byte-identical to the JAX package's;
2. :meth:`GopRecon.dispatch` uploads the blob and runs
   :meth:`GopRecon._decode_blob` — the pairs become coefficient rows,
   kernel K1 transforms every coded block of the chunk in one launch, and
   the residual blocks land in each picture's dense block grid;
3. :meth:`GopRecon._gop` loops over the pictures in Python: per picture
   the residual is laid out as planes and kernels K2 (luma) and K3 (U+V)
   predict, add and saturate; the reference list is updated on the host,
   where picture types are known.

The reference planes are the decoder's only device state: tuples
``(y, u, v)`` of ``luma_padded`` / ``chroma_padded`` uint8 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..headers import CHROMA_420
from ..tokenizer.native import pair_packers
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureTokens
from .idct import idct_blocks
from .mc_fused import fused_mc_recon, fused_mc_recon_uv, mc_meta


def _tiles_from_blocks(blocks, rows, cols, interleave_mask):
    """(n, rows*cols, 8, 8) spatial-row-major blocks -> (n, rows*8, cols*8)
    tiles, with per-MB field interleave (dct_type) selected by mask."""
    n = blocks.shape[0]
    grid = blocks.reshape(n, rows, cols, 8, 8)
    normal = grid.permute(0, 1, 3, 2, 4).reshape(n, rows * 8, cols * 8)
    if rows == 1 or interleave_mask is None:
        return normal
    top = grid[:, 0].permute(0, 2, 1, 3).reshape(n, 8, cols * 8)
    bot = grid[:, 1].permute(0, 2, 1, 3).reshape(n, 8, cols * 8)
    field = torch.stack([top, bot], dim=2).reshape(n, 16, cols * 8)
    return torch.where(interleave_mask[:, None, None], field, normal)


def _plane_from_tiles(tiles, mb_h, mb_w, th, tw):
    return tiles.reshape(mb_h, mb_w, th, tw).permute(0, 2, 1, 3).reshape(
        mb_h * th, mb_w * tw)


def _scale_mv(mv, cf):
    """Vectorized chroma MV derivation; mv: (..., 2) [x, y] int16."""
    mvx, mvy = mv[..., 0], mv[..., 1]
    if cf < 3:
        mvx = mvx >> 1
    if cf < 2:
        mvy = mvy >> 1
    return torch.stack([mvx, mvy], dim=-1)


# Compact chunk-path metadata, frame-prediction form (the JAX package's
# field_support=False layout): one flags column (bit0 dct_type, 1 fwd,
# 2 bwd, 3 field_pred, 4 coded) + the first unit's MVs [dir][x, y].
META2_COLS = 5


def pack_meta2(tokens: PictureTokens,
               out: np.ndarray | None = None) -> np.ndarray:
    n = tokens.geom.n_mb
    meta = out if out is not None else np.zeros((n, META2_COLS), np.int16)
    meta[:, 0] = (tokens.dct_type.astype(np.int16)
                  | (tokens.fwd.astype(np.int16) << 1)
                  | (tokens.bwd.astype(np.int16) << 2)
                  | (tokens.field_pred.astype(np.int16) << 3)
                  | (tokens.coded.astype(np.int16) << 4))
    meta[:, 1:5] = tokens.mv[:, 0].reshape(n, 4)
    return meta


def _unpack_meta2(meta):
    """(n, 5) metadata -> (dct_type, fwd, bwd, coded) bool vectors and the
    (n, 2:dir, 2:xy) int16 MVs."""
    n = meta.shape[0]
    flags = meta[:, 0]
    return ((flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
            (flags & 16) != 0, meta[:, 1:5].reshape(n, 2, 2))


def _ladder(n: int, lo: int = 2048) -> int:
    """Size bucket on a {2^k, 1.5*2^k} ladder: at most 33% padding waste.
    Kept from the JAX package, where it bounded compiled shape variants,
    because it fixes the blob layout.  All rungs are multiples of 1024."""
    b = lo
    while b < n:
        if (b & (b - 1)) == 0:
            b += b >> 1
        else:
            b = (b // 3) << 2
    return b


def _require_420(geom: PictureGeometry) -> None:
    if geom.chroma_format != CHROMA_420:
        raise NotImplementedError(
            f"chroma_format {geom.chroma_format}: the port reconstructs "
            f"4:2:0 only so far")


class DeviceRecon:
    """Per-geometry reconstruction of one picture from its residual blocks
    (frame prediction, 4:2:0)."""

    def __init__(self, geom: PictureGeometry, device):
        _require_420(geom)
        self.geom = geom
        self.device = torch.device(device)
        xs, ys, _ = CHROMA_INFO[geom.chroma_format]
        mb_y, mb_x = np.divmod(np.arange(geom.n_mb), geom.mb_width)

        def vec(a):
            return torch.as_tensor(a, dtype=torch.int32, device=self.device)

        self._pos = {
            0: (vec(mb_y * 16), vec(mb_x * 16)),
            1: (vec((mb_y * 16) >> ys), vec((mb_x * 16) >> xs)),
        }
        self._zero_refs = None

    def _recon_from_residual(self, residual, dct_type, fwd, bwd, coded, mv,
                             r0y, r0u, r0v, r1y, r1u, r1v,
                             bidir: bool = True):
        """residual: (n_mb, 6, 8, 8) int16 blocks; mv: (n_mb, 2:dir, 2:xy)
        int16; returns the reconstructed (y, u, v) planes."""
        res = {
            0: _tiles_from_blocks(residual[:, :4], 2, 2, dct_type),
            1: _tiles_from_blocks(residual[:, 4:5], 1, 1, None),
            2: _tiles_from_blocks(residual[:, 5:], 1, 1, None),
        }
        refs = {0: (r0y, r1y), 1: (r0u, r1u), 2: (r0v, r1v)}
        return self._planes(res, refs, fwd, bwd, coded, mv, bidir)

    def _planes(self, res, refs, fwd, bwd, coded, mv, bidir: bool = True):
        """Fused-kernel reconstruction: per component, the int16 residual in
        plane layout, then one K2 launch for luma and one K3 launch for U
        and V together (MC, bidir average, residual add, saturation and
        uncoded masking)."""
        geom = self.geom
        mbh, mbw = geom.mb_height, geom.mb_width
        mode = (fwd.to(torch.int32) + 2 * bwd.to(torch.int32)
                + 4 * coded.to(torch.int32))
        # window-start clamps are in full-reference coordinates
        Hr, Wr = mbh * 16, mbw * 16
        pos_y, pos_x = self._pos[0]
        syf, sxf, phf = mc_meta(pos_y, pos_x, mv[:, 0, 0], mv[:, 0, 1],
                                Hr, Wr, 16, 16)
        syb, sxb, phb = mc_meta(pos_y, pos_x, mv[:, 1, 0], mv[:, 1, 1],
                                Hr, Wr, 16, 16)
        luma = fused_mc_recon(
            refs[0][0], refs[0][1], _plane_from_tiles(res[0], mbh, mbw, 16, 16),
            syf, sxf, phf, syb, sxb, phb, mode, h=16, w=16, bidir=bidir)
        cpos_y, cpos_x = self._pos[1]
        mvc = _scale_mv(mv, geom.chroma_format)
        csyf, csxf, cphf = mc_meta(cpos_y, cpos_x, mvc[:, 0, 0], mvc[:, 0, 1],
                                   Hr >> 1, Wr >> 1, 8, 8)
        csyb, csxb, cphb = mc_meta(cpos_y, cpos_x, mvc[:, 1, 0], mvc[:, 1, 1],
                                   Hr >> 1, Wr >> 1, 8, 8)
        u, v = fused_mc_recon_uv(
            (refs[1][0], refs[2][0]), (refs[1][1], refs[2][1]),
            (_plane_from_tiles(res[1], mbh, mbw, 8, 8),
             _plane_from_tiles(res[2], mbh, mbw, 8, 8)),
            csyf, csxf, cphf, csyb, csxb, cphb, mode, h=8, w=8, bidir=bidir)
        return luma, u, v

    def zero_planes(self):
        if self._zero_refs is None:
            g = self.geom
            self._zero_refs = tuple(
                torch.zeros(s, dtype=torch.uint8, device=self.device)
                for s in (g.luma_padded, g.chroma_padded, g.chroma_padded))
        return self._zero_refs


class GopRecon:
    """A chunk of pictures decoded from one uploaded blob (see the module
    docstring).  ``chunk=1`` is the per-picture latency path."""

    def __init__(self, geom: PictureGeometry, chunk: int, device):
        self.geom = geom
        self.chunk = chunk
        self.device = torch.device(device)
        self.inner = DeviceRecon(geom, self.device)
        # within-picture dense-grid index fits uint16 for every geometry up
        # to ~2.7K-wide video; 0xFFFF is the padding sentinel
        self._scat_u16 = geom.n_mb * geom.blocks_per_mb < 0xFFFF
        self._stage = {}       # keyed by (pair cap, row cap)
        self._packers = None
        self._nnz_scratch = None

    def _layout(self, cap_pairs: int, cap_k: int):
        """Byte offsets of the seven sections inside the blob (each 4-byte
        aligned): pair_pos uint8 (column of each nonzero, 255 for padding),
        pair_val int16, row_nnz uint8 (nonzeros per coded row), scat_pos
        (uint16 within-picture block index when the dense grid fits, else
        int32 absolute), pic_k int32 (coded rows per picture), step flags
        uint8 (bit0 is_b, bit1 is_ip), meta int16."""
        g = self.geom
        sb = 2 if self._scat_u16 else 4
        o0 = 0
        o1 = (o0 + cap_pairs + 3) & ~3           # pair_val
        o2 = (o1 + cap_pairs * 2 + 3) & ~3       # row_nnz
        o3 = (o2 + cap_k + 3) & ~3               # scat_pos
        o4 = (o3 + cap_k * sb + 3) & ~3          # pic_k
        o5 = o4 + self.chunk * 4                 # step flags
        o6 = (o5 + self.chunk + 3) & ~3          # meta
        total = o6 + ((self.chunk * g.n_mb * META2_COLS * 2 + 3) & ~3)
        return (o0, o1, o2, o3, o4, o5, o6, total)

    def _decode_blob(self, blob, *, cap_pairs, cap_k):
        """Device-side transport decode: uint8 blob tensor -> (residual
        dense (chunk, n_rows, 64) int16, meta (chunk, n_mb, 5) int16,
        step flags (chunk,) uint8)."""
        geom = self.geom
        dev = blob.device
        n_rows = geom.n_mb * geom.blocks_per_mb
        span = self.chunk * n_rows
        o0, o1, o2, o3, o4, o5, o6, _ = self._layout(cap_pairs, cap_k)
        i64 = torch.int64
        pair_pos = blob[o0:o0 + cap_pairs].to(i64)
        pair_val = blob[o1:o1 + cap_pairs * 2].view(torch.int16)
        row_nnz = blob[o2:o2 + cap_k].to(i64)
        iota_k = torch.arange(cap_k, dtype=i64, device=dev)
        if self._scat_u16:
            # within-picture index + picture id rebuilt from per-picture
            # row counts (same scatter-add + cumsum trick as the pair row
            # ids below); 0xFFFF rows are padding
            s16 = blob[o3:o3 + cap_k * 2].view(torch.int16).to(i64) & 0xFFFF
            pic_k = blob[o4:o4 + self.chunk * 4].view(torch.int32).to(i64)
            offp = torch.cumsum(pic_k, 0) - pic_k
            markp = torch.zeros(cap_k, dtype=i64, device=dev).index_add_(
                0, offp, torch.ones_like(offp))
            pic = torch.cumsum(markp, 0) - 1
            scat_pos = torch.where(s16 == 0xFFFF, span + iota_k,
                                   pic * n_rows + s16)
        else:
            scat_pos = blob[o3:o3 + cap_k * 4].view(torch.int32).to(i64)
            # padding rows get distinct indices past the grid
            scat_pos = torch.where(scat_pos >= span, span + iota_k, scat_pos)
        flags = blob[o5:o5 + self.chunk]
        nm = self.chunk * geom.n_mb * META2_COLS
        meta = blob[o6:o6 + nm * 2].view(torch.int16).reshape(
            self.chunk, geom.n_mb, META2_COLS)

        # 1) nonzero pairs -> coded coefficient rows.  The row id of each
        #    pair is rebuilt from per-row nonzero counts: rows mark their
        #    start offset (scatter-add — empty rows and the padding rows
        #    collapse onto the same offset), an inclusive cumsum then counts
        #    the rows whose offset <= pair position.  Padding pairs
        #    (pos=255) go to one spare slot past the rows, cut off below.
        off = torch.cumsum(row_nnz, 0) - row_nnz
        mark = torch.zeros(cap_pairs, dtype=i64, device=dev).index_add_(
            0, off, torch.ones_like(off))
        row = torch.cumsum(mark, 0) - 1
        pair_idx = torch.where(pair_pos == 255, cap_k * 64,
                               row * 64 + pair_pos)
        coeff = torch.zeros(cap_k * 64 + 1, dtype=torch.int16, device=dev)
        coeff.index_put_((pair_idx,), pair_val)
        # 2) one IDCT over every coded block of the whole chunk (K1)
        res_rows = idct_blocks(coeff[:cap_k * 64].view(cap_k, 64))
        # 3) place residual blocks into the per-picture dense grid
        dense = torch.zeros((span + cap_k, 64), dtype=torch.int16,
                            device=dev)
        dense.index_copy_(0, scat_pos, res_rows.reshape(cap_k, 64))
        return dense[:span].view(self.chunk, n_rows, 64), meta, flags

    def _gop(self, blob, r0, r1, *, cap_pairs, cap_k, step_flags, bidir):
        """Reconstruct the chunk's pictures in order.  ``step_flags``: the
        host copy of the real pictures' flags (bit0 is_b, bit1 is_ip).
        B pictures predict from (r0, r1), I/P pictures from (r1, r1) with
        the forward-only kernels (their MBs carry no backward bit); an I/P
        output then becomes the newer reference.  Returns (r0, r1, packed
        (t, frame_bytes) uint8)."""
        geom = self.geom
        dense, meta, _ = self._decode_blob(blob, cap_pairs=cap_pairs,
                                           cap_k=cap_k)
        xs, ys, _ = CHROMA_INFO[geom.chroma_format]
        cw = (geom.width + (1 << xs) - 1) >> xs
        ch = (geom.height + (1 << ys) - 1) >> ys
        ny, nc = geom.height * geom.width, ch * cw
        packs = torch.empty((len(step_flags), ny + 2 * nc),
                            dtype=torch.uint8, device=blob.device)
        for i, fl in enumerate(step_flags):
            is_b, is_ip = bool(fl & 1), bool(fl & 2)
            dct_type, fwd, bwd, coded, mv = _unpack_meta2(meta[i])
            residual = dense[i].view(geom.n_mb, geom.blocks_per_mb, 8, 8)
            out = self.inner._recon_from_residual(
                residual, dct_type, fwd, bwd, coded, mv,
                *(r0 if is_b else r1), *r1, bidir=bidir and is_b)
            packs[i, :ny].view(geom.height, geom.width).copy_(
                out[0][:geom.height, :geom.width])
            packs[i, ny:ny + nc].view(ch, cw).copy_(out[1][:ch, :cw])
            packs[i, ny + nc:].view(ch, cw).copy_(out[2][:ch, :cw])
            # reference-list update (reference: decoder.cpp:299-304)
            if is_ip:
                r0, r1 = r1, out
        return r0, r1, packs

    def _staging(self, cap_pairs, cap_k):
        """Persistent host staging blob + typed section views.  Upload is
        synchronous, so one slot per shape is never rewritten while read."""
        key = (cap_pairs, cap_k)
        if key not in self._stage:
            g = self.geom
            o0, o1, o2, o3, o4, o5, o6, total = self._layout(cap_pairs,
                                                             cap_k)
            sdt, sb = (np.uint16, 2) if self._scat_u16 else (np.int32, 4)
            blob = np.zeros(total, np.uint8)
            self._stage[key] = (
                blob,
                blob[o0:o0 + cap_pairs],
                blob[o1:o1 + cap_pairs * 2].view(np.int16),
                blob[o2:o2 + cap_k],
                blob[o3:o3 + cap_k * sb].view(sdt),
                blob[o4:o4 + self.chunk * 4].view(np.int32),
                blob[o5:o5 + self.chunk],
                blob[o6:o6 + self.chunk * g.n_mb * META2_COLS * 2].view(
                    np.int16).reshape(self.chunk, g.n_mb, META2_COLS))
        return self._stage[key]

    def prepare(self, tokens_list, pct_list):
        """Stage 1, host-only: pack nonzero (column, value) pairs + per-row
        counts + metadata into a staging blob.  Pairs are globally sorted:
        sparse rows are numbered in claim order per picture, pictures in
        chunk order, each row walked column-major.  Returns an opaque staged
        tuple for :meth:`dispatch`."""
        t = len(tokens_list)
        if not 0 < t <= self.chunk:
            raise ValueError(f"{t} pictures for a chunk of {self.chunk}")
        if any(tok.field_pred.any() for tok in tokens_list):
            raise NotImplementedError(
                "field-based motion compensation is not ported yet")
        g = self.geom
        n_rows = g.n_mb * g.blocks_per_mb

        if self._packers is None:
            self._packers = pair_packers()
        count_pairs, pack_pairs_fn = self._packers
        total_k = sum(tok.n_coded_blocks for tok in tokens_list)
        cap_k = _ladder(total_k + 1)
        if self._nnz_scratch is None or len(self._nnz_scratch) < cap_k:
            self._nnz_scratch = np.empty(cap_k, np.uint8)
        nnz = self._nnz_scratch
        total_nz = 0
        off = 0
        for tok in tokens_list:
            k = tok.n_coded_blocks
            if tok.row_nnz is not None:
                # per-row nonzero counts were produced DURING the native
                # parse — no counting re-read of the coefficient rows
                nnz[off:off + k] = tok.row_nnz[:k]
                total_nz += int(tok.row_nnz[:k].sum(dtype=np.int64))
            else:
                total_nz += count_pairs(np.ascontiguousarray(tok.cblk[:k]),
                                        nnz[off:off + k])
            off += k
        cap_pairs = _ladder(total_nz + 1, lo=4096)
        blob, pp, pv, pn, sp, pk, fl, sm = self._staging(cap_pairs, cap_k)
        pn[:off] = nnz[:off]
        p = 0
        off = 0
        for i, tok in enumerate(tokens_list):
            k = tok.n_coded_blocks
            p += pack_pairs_fn(np.ascontiguousarray(tok.cblk[:k]),
                               pp[p:], pv[p:])
            if self._scat_u16:
                sp[off:off + k] = tok.cblk_idx[:k].astype(np.uint16)
            else:
                sp[off:off + k] = i * n_rows + tok.cblk_idx[:k]
            pk[i] = k
            off += k
            pack_meta2(tok, out=sm[i])
        if p != total_nz:
            raise RuntimeError(f"packed {p} pairs, counted {total_nz}")
        pp[p:] = 255                 # padding pairs resolve out of range
        pn[off:] = 0
        sp[off:] = 0xFFFF if self._scat_u16 else self.chunk * n_rows
        pk[t:] = 0
        if t < self.chunk:
            sm[t:] = 0
        is_b = np.zeros(self.chunk, bool)
        is_b[:t] = [pc == 3 for pc in pct_list]
        is_b[t:] = True  # padding steps must not touch the reference list
        fl[:] = is_b.astype(np.uint8) | ((~is_b).astype(np.uint8) << 1)
        return ((cap_pairs, cap_k), blob, t)

    def dispatch(self, staged, ref0=None, ref1=None, bidir: bool = True):
        """Stage 2: upload the staged blob and reconstruct the chunk.  Must
        be called in chunk order (the reference planes carry over); returns
        (ref0, ref1, packed (t, frame_bytes) uint8).  ``bidir=False``
        selects the forward-only kernels for every picture — only valid
        when no picture in the chunk is B-coded."""
        (cap_pairs, cap_k), blob, t = staged
        o5 = self._layout(cap_pairs, cap_k)[5]
        step_flags = blob[o5:o5 + t].copy()
        if ref0 is None:
            ref0 = self.inner.zero_planes()
        if ref1 is None:
            ref1 = self.inner.zero_planes()
        # synchronous copy: the staging slot is free again on return (on
        # the CPU, copy=True keeps the tensors off the staging memory)
        up = torch.from_numpy(blob).to(self.device, copy=True)
        return self._gop(up, tuple(ref0), tuple(ref1), cap_pairs=cap_pairs,
                         cap_k=cap_k, step_flags=step_flags, bidir=bidir)
