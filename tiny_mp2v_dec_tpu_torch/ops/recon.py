"""Device reconstruction of GOP chunks: transport, IDCT, fused MC.

Counterpart of ``tiny_mp2v_dec_tpu/ops/recon.py`` for frame pictures in
every chroma format (4:2:0, 4:2:2, 4:4:4), with frame- or field-based
motion.  :class:`GopRecon` decodes a chunk of pictures:

1. :meth:`GopRecon.prepare` (host, numpy) packs the chunk's nonzero
   coefficients as (column, value) pairs, per-row nonzero counts, block
   positions, per-picture row counts, step flags and per-MB metadata into
   one uint8 blob, byte-identical to the JAX package's, written into one
   of :attr:`GopRecon.N_SLOTS` staging slots per blob shape (pinned host
   memory on ``cuda``);
2. :meth:`GopRecon.dispatch` uploads the blob without blocking the host
   and runs :meth:`GopRecon._decode_blob` — the pairs become coefficient
   rows, K1's transform runs on every coded block of the chunk, and the
   residual blocks land in each picture's dense block grid, all in the
   chunk transport's three launches (``csrc/transport.cu``,
   :func:`transport_grid`);
3. :meth:`GopRecon._gop` splits the chunk into groups of pictures none
   of which reads another's output (:func:`mc_groups`: a group closes
   after each I/P picture, whose output becomes the newer reference), and
   per group one launch of kernels K2 (luma) and K3 (U+V) — or, in a chunk
   with field-predicted MBs (``field_support=True``), their field form K4
   — predicts, adds and saturates every picture of the group, in their
   grouped blocks form, which reads each picture's metadata rows and
   residual block grid as the blob's decode leaves them; then the three
   copies that pack each frame; the reference list is updated on the
   host, where picture types are known.

The MC kernels are those of the JAX package's ``mc_impl`` (see
:func:`resolve_mc_impl`): ``mxu`` K2/K3/K4 (the default), ``roll`` K5/K6
(frame prediction), ``swar`` K7 (packed prediction, one launch per
picture) or K8 (per component, in a chunk with field MBs).
``roll`` and ``swar`` take their per-MB vectors and residual planes from
:func:`.mc_fused.blocks_to_vectors`.  ``use_kernels=False`` (the JAX
package's ``use_pallas_idct`` / ``use_pallas_mc`` together) takes the plain
versions — of the chunk transport, of the MC kernels — on any device,
which is what the kernel gate (``tools/perf_gate.py``) holds the kernels
against; the decoder never passes it.

The reference planes are the decoder's only device state: tuples
``(y, u, v)`` of ``luma_padded`` / ``chroma_padded`` uint8 tensors.

``prepare`` and ``dispatch`` may run on two threads, as the decoder's fill
and dispatch threads run them (``runtime/decoder.py``): a condition
variable keeps at most ``N_SLOTS - 1`` chunks prepared and not yet
dispatched, and a slot is rewritten only once the CUDA event recorded after
its upload has completed.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..runtime.spans import Spans
from ..tokenizer.native import pair_packers
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureTokens
from . import _build
from .idct import idct_blocks_ref
from .mc_fused import (GROUP_MAX, blocks_planes, blocks_to_vectors,
                       fused_mc_pred_swar_field, fused_mc_pred_swar_field_ref,
                       fused_mc_pred_swar_yuv, fused_mc_pred_swar_yuv_ref,
                       fused_mc_recon_blocks_group,
                       fused_mc_recon_blocks_group_ref, fused_mc_recon_ref,
                       fused_mc_recon_roll, fused_mc_recon_uv_ref,
                       fused_mc_recon_uv_roll, unpack_words)

MC_IMPLS = ("mxu", "roll", "swar")
# the grouped blocks form: its kernel wrapper and its plain version
_BLOCKS = (fused_mc_recon_blocks_group, fused_mc_recon_blocks_group_ref)
# (impl, field support) -> (kernel wrapper(s), plain version(s)): the
# grouped blocks form, which reads the metadata rows and the residual block
# grid of a group of pictures (mxu; and roll with field support, which has
# no kernel); a (luma, U+V) pair of the vector form (roll); or swar's one
# prediction function: of a whole picture, or under field support of one
# component
_MC_FNS = {
    ("mxu", False): _BLOCKS,
    ("mxu", True): _BLOCKS,
    ("roll", False): ((fused_mc_recon_roll, fused_mc_recon_uv_roll),
                      (fused_mc_recon_ref, fused_mc_recon_uv_ref)),
    ("roll", True): (None, _BLOCKS[1]),
    ("swar", False): (fused_mc_pred_swar_yuv, fused_mc_pred_swar_yuv_ref),
    ("swar", True): (fused_mc_pred_swar_field, fused_mc_pred_swar_field_ref),
}


def resolve_mc_impl(mc_impl: str | None, field_support: bool) -> str:
    """The MC implementation a recon runs, by the JAX package's rule:
    ``None`` takes ``MP2V_MC_IMPL`` (default ``"mxu"``), and a ``roll``
    that came from the environment becomes ``mxu`` under field support,
    since the roll kernels have no field form.  The variable is read here,
    when a recon is built — not once at import, as the JAX package reads
    it — so that one process can build recons of each implementation."""
    impl = mc_impl if mc_impl is not None else os.environ.get(
        "MP2V_MC_IMPL", "mxu")
    if impl not in MC_IMPLS:
        raise ValueError(f"MC implementation {impl!r}: not one of "
                         f"{MC_IMPLS}")
    if field_support and impl == "roll" and mc_impl is None:
        return "mxu"
    return impl


# Compact chunk-path metadata, as in the JAX package: one flags column
# (bit0 dct_type, 1 fwd, 2 bwd, 3 field_pred, 4 coded, 5..8 mvfs[r][s] at
# bit 5+2r+s) + MV columns.  Frame-prediction chunks
# (field_support=False) carry the first unit's MVs [dir][x, y] (5
# columns); field-capable chunks carry all 8 [unit][dir][x, y] + mvfs (9).
def meta2_cols(field_support: bool) -> int:
    return 9 if field_support else 5


def pack_meta2(tokens: PictureTokens, field_support: bool,
               out: np.ndarray | None = None) -> np.ndarray:
    n = tokens.geom.n_mb
    meta = (out if out is not None
            else np.zeros((n, meta2_cols(field_support)), np.int16))
    flags = (tokens.dct_type.astype(np.int16)
             | (tokens.fwd.astype(np.int16) << 1)
             | (tokens.bwd.astype(np.int16) << 2)
             | (tokens.field_pred.astype(np.int16) << 3)
             | (tokens.coded.astype(np.int16) << 4))
    if field_support:
        mvfs = tokens.mvfs.reshape(n, 4).astype(np.int16)
        for b in range(4):
            flags |= mvfs[:, b] << (5 + b)
        meta[:, 1:9] = tokens.mv.reshape(n, 8)
    else:
        meta[:, 1:5] = tokens.mv[:, 0].reshape(n, 4)
    meta[:, 0] = flags
    return meta


def mc_groups(step_flags) -> list:
    """The chunk's pictures (by their step flags: bit0 is_b, bit1 is_ip) in
    groups of consecutive indices that read no output of one another: a
    group closes after each I/P picture, whose output becomes the newer
    reference, after :data:`~.mc_fused.GROUP_MAX` pictures, and at the
    chunk's end."""
    groups, cur = [], []
    for i, fl in enumerate(step_flags):
        cur.append(i)
        if fl & 2 or len(cur) == GROUP_MAX:
            groups.append(cur)
            cur = []
    return groups + [cur] if cur else groups


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


class DeviceRecon:
    """Per-geometry reconstruction of one picture from its residual blocks.

    ``field_support=False`` takes the frame-prediction kernels (K2/K3,
    K5/K6 or K7) and ignores field motion; ``True`` takes a field form (K4
    or K8), which predicts each MB frame- or field-based by its field_pred
    flag.  ``mc_impl`` as :func:`resolve_mc_impl`.  ``use_kernels=True``
    takes the MC kernel wrappers (the kernels on ``cuda``, their plain
    versions on the CPU), ``False`` the plain versions on any device.  An
    explicit ``"roll"`` with field support has no kernel: the JAX package
    takes its XLA gather path there; the port takes the blocks form's
    plain version on the CPU and raises on any other device rather than
    run it on the card, unless ``use_kernels=False`` asks for the plain
    version."""

    def __init__(self, geom: PictureGeometry, device,
                 field_support: bool = False, mc_impl: str | None = None,
                 use_kernels: bool = True):
        self.geom = geom
        self.device = torch.device(device)
        self.field_support = field_support
        self.mc_impl = resolve_mc_impl(mc_impl, field_support)
        kernels, plain = _MC_FNS[self.mc_impl, field_support]
        if kernels is None and use_kernels:
            if self.device.type != "cpu":
                raise ValueError("mc_impl='roll' has no field-prediction "
                                 "kernel; use 'mxu' or 'swar'")
            use_kernels = False
        self.use_kernels = use_kernels
        # the grouped blocks form; (luma, U+V) reconstruction functions;
        # swar's one prediction function
        self._mc_fns = kernels if self.use_kernels else plain
        self._zero_refs = None
        self._transport = None
        # MC kernel calls since the recon was made (:meth:`_mc`): launches
        # on the card, on the CPU the plain versions that take their place
        self.mc_launches = 0
        # the blocks form's pictures waiting for their group's launch, a
        # list while :meth:`_recon_group` gathers them (one thread drives a
        # recon at a time)
        self._group = None

    def _mc(self, fn, *args, **kw):
        """One MC kernel call (or its plain version's), counted."""
        self.mc_launches += 1
        return fn(*args, **kw)

    def _recon_group(self, pictures, band=None):
        """Reconstruct pictures none of which reads another's output:
        ``pictures`` holds ``(ref0, ref1, dense, meta, bidir)`` a picture,
        the references ``(y, u, v)`` tuples, the rest as
        :meth:`_recon_from_residual` takes them; returns their ``(y, u,
        v)`` planes.  Each picture passes through
        :meth:`_recon_from_residual`: the other forms reconstruct it there,
        the blocks form only makes its planes and adds it to the group,
        which then takes one launch of luma and U+V a
        :data:`~.mc_fused.GROUP_MAX` pictures."""
        self._group = []
        try:
            outs = [self._recon_from_residual(d, m, *r0, *r1, bidir=b,
                                              band=band)
                    for r0, r1, d, m, b in pictures]
            group = self._group
        finally:
            self._group = None
        for k in range(0, len(group), GROUP_MAX):
            self._launch_group(group[k:k + GROUP_MAX], band)
        return outs

    def _launch_group(self, group, band):
        """One launch of the grouped blocks form over ``group``'s
        ``(picture, planes)`` pairs, each picture's output into its
        planes."""
        geom = self.geom
        self._mc(self._mc_fns, [p for p, _ in group],
                 chroma_format=geom.chroma_format, mbw=geom.mb_width,
                 mb0=0 if band is None else band[0] * geom.mb_width,
                 out=[o for _, o in group])

    def _recon_from_residual(self, dense, meta, r0y, r0u, r0v, r1y, r1u,
                             r1v, bidir: bool = True, band=None):
        """dense: the picture's (n_mb * blocks_per_mb, 64) int16 residual
        block grid; meta: its (n_mb, cols) int16 metadata rows
        (:func:`pack_meta2`); returns the reconstructed (y, u, v) planes.
        ``band=(row0, mbh_local)`` reconstructs only those MB rows (the
        row-sharded path's band): the grid and the rows cover the band's
        MBs, the reference planes stay whole (motion reaches anywhere in
        them), and the planes returned are the band's rows.  The blocks
        form takes both inputs as they are: the picture's planes are made
        here and written by its group's launch (:meth:`_recon_group`), or
        alone, as a group of one, by one launch for luma and U+V.  The
        other forms take the vectors and residual planes of
        :func:`.mc_fused.blocks_to_vectors`: the vector form (K5 and K6) one
        launch for luma and one for U and V, swar one prediction launch for
        the picture's three components (K7), or under field support one per
        component (K8), then a plain PyTorch epilogue per component."""
        geom = self.geom
        if self._mc_fns in _BLOCKS:
            planes = blocks_planes(meta, chroma_format=geom.chroma_format,
                                   mbw=geom.mb_width, device=dense.device)
            picture = ((r0y, r0u, r0v), (r1y, r1u, r1v), dense, meta, bidir)
            if self._group is None:
                self._launch_group([(picture, planes)], band)
            else:
                self._group.append((picture, planes))
            return planes
        fns = self._mc_fns
        kw = dict(chroma_format=geom.chroma_format, mbw=geom.mb_width,
                  mb0=0 if band is None else band[0] * geom.mb_width)
        (res_y,), vy, _, _ = blocks_to_vectors(r0y, dense, meta, **kw)
        res_c, vc, ch, cw = blocks_to_vectors(r0u, dense, meta, uv=True,
                                              **kw)
        if isinstance(fns, tuple):
            luma = self._mc(fns[0], r0y, r1y, res_y, *vy, h=16, w=16,
                            bidir=bidir)
            u, v = self._mc(fns[1], (r0u, r0v), (r1u, r1v), res_c, *vc,
                            h=ch, w=cw, bidir=bidir)
            return luma, u, v
        mbw = geom.mb_width
        mbh = meta.shape[0] // mbw
        refs0, refs1 = (r0y, r0u, r0v), (r1y, r1u, r1v)
        tiles = ((16, 16), (ch, cw), (ch, cw))
        if self.field_support:
            words = [self._mc(fns, r0, r1, *v, h=h, w=w, bidir=bidir,
                              H=mbh * h)
                     for r0, r1, v, (h, w) in zip(refs0, refs1, (vy, vc, vc),
                                                  tiles)]
        else:
            words = self._mc(fns, refs0, refs1, vy[:6], vc[:6], vy[6], h=ch,
                             w=cw, bidir=bidir, H=mbh * 16)
        coded = ((vy[6] & 4) != 0).reshape(mbh, 1, mbw, 1)

        def epilogue(word, res, h, w):
            # the uncoded-MB mask rides the residual: -256 saturates to 0
            # after the clip.  The sum is int32, as the other forms': the
            # JAX epilogue's int16 sum wraps at the residual's extremes
            res = torch.where(coded.expand(mbh, h, mbw, w).reshape(res.shape),
                              res, -256)
            pred = unpack_words(word).to(torch.int32)
            return torch.clamp(pred + res, 0, 255).to(torch.uint8)

        return tuple(epilogue(word, res, h, w) for word, res, (h, w)
                     in zip(words, (res_y, *res_c), tiles))

    def __call__(self, tokens: PictureTokens, ref0=None, ref1=None):
        """One picture (the JAX package's ``DeviceRecon.__call__``):
        ``tokens`` reconstructed with forward prediction from ``ref0`` and
        backward from ``ref1`` (``(y, u, v)`` tuples, zero planes when
        ``None``), both directions' kernels.  The tokens travel as the
        chunk path's blob, through a chunk-1 :class:`GopRecon` of this
        recon's configuration; returns the padded (y, u, v) planes."""
        if self._transport is None:
            self._transport = GopRecon(self.geom, 1, self.device,
                                       self.field_support, self.mc_impl,
                                       self.use_kernels)
        dense, meta, _ = self._transport.upload_decode(
            self._transport.prepare([tokens], [3]), [self.device])[
                self.device]
        zero = self.zero_planes()
        return self._recon_from_residual(
            dense[0], meta[0], *(zero if ref0 is None else ref0),
            *(zero if ref1 is None else ref1))

    def zero_planes(self):
        if self._zero_refs is None:
            g = self.geom
            self._zero_refs = tuple(
                torch.zeros(s, dtype=torch.uint8, device=self.device)
                for s in (g.luma_padded, g.chroma_padded, g.chroma_padded))
        return self._zero_refs


class GopRecon:
    """A chunk of pictures decoded from one uploaded blob (see the module
    docstring).  ``chunk=1`` is the per-picture latency path.
    ``field_support`` selects the metadata form and, with ``mc_impl``, the
    kernels (see :class:`DeviceRecon`); a frame-prediction recon refuses
    field-predicted MBs, whose second-unit vectors its 5-column metadata
    would drop.  ``use_kernels=False`` takes the plain versions: of the
    chunk transport (:meth:`_decode_blob_ref`) and of :class:`DeviceRecon`'s
    MC kernels."""

    def __init__(self, geom: PictureGeometry, chunk: int, device,
                 field_support: bool = False, mc_impl: str | None = None,
                 use_kernels: bool = True):
        self.geom = geom
        self.chunk = chunk
        self.device = torch.device(device)
        self.use_kernels = use_kernels
        self.inner = DeviceRecon(geom, self.device, field_support, mc_impl,
                                 use_kernels)
        self._cols = meta2_cols(field_support)
        # within-picture dense-grid index fits uint16 for every geometry up
        # to ~2.7K-wide video; 0xFFFF is the padding sentinel
        self._scat_u16 = geom.n_mb * geom.blocks_per_mb < 0xFFFF
        # (pair cap, row cap) -> N_SLOTS staging slots, made on first use
        self._stage = {}
        self._stage_idx = 0
        self._packers = None
        self._nnz_scratch = None
        # prepare() may run on a fill thread while a dispatch thread
        # uploads earlier chunks: the lock serializes prepare calls (the
        # scratch, the packers, the slot index); the condition bounds the
        # chunks prepared and not yet dispatched, so that a slot is never
        # refilled before its blob was uploaded
        self._call_lock = threading.Lock()
        self._cv = threading.Condition()
        self._seq_prep = 0
        self._seq_disp = 0
        # the spans prepare and dispatch record: a decoder hands its own
        # in; this one never records
        self.spans = Spans()
        # nanoseconds the last prepare waited for its staging slot: for a
        # free slot, then for the slot's last upload (the first use of a
        # blob shape also makes its slot)
        self.slot_wait_ns = 0

    @property
    def mc_launches(self) -> int:
        """The MC kernel calls of this recon's pictures (see
        :class:`DeviceRecon`)."""
        return self.inner.mc_launches

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
        total = o6 + ((self.chunk * g.n_mb * self._cols * 2 + 3) & ~3)
        return (o0, o1, o2, o3, o4, o5, o6, total)

    def _decode_blob(self, blob, *, cap_pairs, cap_k):
        """Device-side transport decode: uint8 blob tensor -> (residual
        dense (chunk, n_rows, 64) int16, meta (chunk, n_mb, cols) int16,
        step flags (chunk,) uint8); ``meta`` and the flags are views of
        the blob.  A CUDA tensor takes the chunk transport kernel
        (:func:`transport_grid`); a CPU tensor, or any device under
        ``use_kernels=False``, the plain version
        (:meth:`_decode_blob_ref`); anything else raises."""
        dev = blob.device
        if dev.type == "cpu" or not self.use_kernels:
            return self._decode_blob_ref(blob, cap_pairs=cap_pairs,
                                         cap_k=cap_k)
        if dev.type != "cuda":
            raise ValueError(f"_decode_blob: no kernel for device {dev}")
        geom = self.geom
        n_rows = geom.n_mb * geom.blocks_per_mb
        layout = self._layout(cap_pairs, cap_k)
        dense = transport_grid(blob, layout, cap_pairs=cap_pairs,
                               cap_k=cap_k, chunk=self.chunk, n_rows=n_rows,
                               scat_u16=self._scat_u16)
        return (dense.view(self.chunk, n_rows, 64),
                *self._meta_flags(blob, layout))

    def _meta_flags(self, blob, layout):
        """The blob's metadata rows (chunk, n_mb, cols) int16 and step
        flags (chunk,) uint8, as views of it."""
        o5, o6 = layout[5:7]
        nm = self.chunk * self.geom.n_mb * self._cols
        meta = blob[o6:o6 + nm * 2].view(torch.int16).reshape(
            self.chunk, self.geom.n_mb, self._cols)
        return meta, blob[o5:o5 + self.chunk]

    def _decode_blob_ref(self, blob, *, cap_pairs, cap_k):
        """The plain version of :meth:`_decode_blob`, on any device: the
        JAX package's ops in PyTorch (row ids rebuilt by scatter-adds and
        cumsums, the pairs expanded into a zeroed coefficient buffer, K1's
        plain version on the rows, the rows scattered into a zeroed
        grid)."""
        geom = self.geom
        dev = blob.device
        n_rows = geom.n_mb * geom.blocks_per_mb
        span = self.chunk * n_rows
        layout = self._layout(cap_pairs, cap_k)
        o0, o1, o2, o3, o4 = layout[:5]
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
        # 2) one IDCT over every coded block of the whole chunk
        res_rows = idct_blocks_ref(coeff[:cap_k * 64].view(cap_k, 64))
        # 3) place residual blocks into the per-picture dense grid
        dense = torch.zeros((span + cap_k, 64), dtype=torch.int16,
                            device=dev)
        dense.index_copy_(0, scat_pos, res_rows.reshape(cap_k, 64))
        return (dense[:span].view(self.chunk, n_rows, 64),
                *self._meta_flags(blob, layout))

    def _gop(self, blob, r0, r1, *, cap_pairs, cap_k, step_flags, bidir):
        """Reconstruct the chunk's pictures in order, a group of
        :func:`mc_groups` at a time.  ``step_flags``: the host copy of the
        real pictures' flags (bit0 is_b, bit1 is_ip).  B pictures predict
        from (r0, r1), I/P pictures from (r1, r1) with the forward-only
        kernels (their MBs carry no backward bit); an I/P output, the last
        of its group, then becomes the newer reference.  Returns (r0, r1,
        packed (t, frame_bytes) uint8)."""
        geom = self.geom
        dense, meta, _ = self._decode_blob(blob, cap_pairs=cap_pairs,
                                           cap_k=cap_k)
        xs, ys, _ = CHROMA_INFO[geom.chroma_format]
        cw = (geom.width + (1 << xs) - 1) >> xs
        ch = (geom.height + (1 << ys) - 1) >> ys
        ny, nc = geom.height * geom.width, ch * cw
        packs = torch.empty((len(step_flags), ny + 2 * nc),
                            dtype=torch.uint8, device=blob.device)
        for group in mc_groups(step_flags):
            is_b = [bool(step_flags[i] & 1) for i in group]
            outs = self.inner._recon_group([
                (r0 if b else r1, r1, dense[i], meta[i], bidir and b)
                for i, b in zip(group, is_b)])
            for i, out in zip(group, outs):
                packs[i, :ny].view(geom.height, geom.width).copy_(
                    out[0][:geom.height, :geom.width])
                packs[i, ny:ny + nc].view(ch, cw).copy_(out[1][:ch, :cw])
                packs[i, ny + nc:].view(ch, cw).copy_(out[2][:ch, :cw])
            # reference-list update (reference: decoder.cpp:299-304)
            if step_flags[group[-1]] & 2:
                r0, r1 = r1, outs[-1]
        return r0, r1, packs

    # staging slots per (cap_pairs, cap_k), taken in turn: one being
    # uploaded, one prepared and waiting, one being filled
    N_SLOTS = 3

    def _staging(self, cap_pairs, cap_k, index) -> "_Slot":
        """Staging slot ``index`` of a blob shape, made on first use:
        pinned host memory on ``cuda`` (so that the upload can run without
        blocking the host), plain numpy on the CPU, where torch cannot
        pin."""
        slots = self._stage.setdefault((cap_pairs, cap_k),
                                       [None] * self.N_SLOTS)
        if slots[index] is None:
            total = self._layout(cap_pairs, cap_k)[-1]
            if self.device.type == "cuda":
                pinned = torch.zeros(total, dtype=torch.uint8,
                                     pin_memory=True)
                blob = pinned.numpy()
            else:
                pinned, blob = None, np.zeros(total, np.uint8)
            slots[index] = _Slot(blob, pinned)
        return slots[index]

    def _views(self, blob, cap_pairs, cap_k):
        """The typed sections of a staging blob (see :meth:`_layout`)."""
        g = self.geom
        o0, o1, o2, o3, o4, o5, o6, _ = self._layout(cap_pairs, cap_k)
        sdt, sb = (np.uint16, 2) if self._scat_u16 else (np.int32, 4)
        return (blob[o0:o0 + cap_pairs],
                blob[o1:o1 + cap_pairs * 2].view(np.int16),
                blob[o2:o2 + cap_k],
                blob[o3:o3 + cap_k * sb].view(sdt),
                blob[o4:o4 + self.chunk * 4].view(np.int32),
                blob[o5:o5 + self.chunk],
                blob[o6:o6 + self.chunk * g.n_mb * self._cols * 2].view(
                    np.int16).reshape(self.chunk, g.n_mb, self._cols))

    def _slot_of(self, staged) -> "_Slot":
        (cap_pairs, cap_k), blob, _ = staged
        return next(s for s in self._stage[cap_pairs, cap_k]
                    if s is not None and s.blob is blob)

    def prepare(self, tokens_list, pct_list, unit: int = 0):
        """Stage 1, host-only: pack nonzero (column, value) pairs + per-row
        counts + metadata into a staging slot.  Pairs are globally sorted:
        sparse rows are numbered in claim order per picture, pictures in
        chunk order, each row walked column-major.  Returns the staged
        tuple ``((cap_pairs, cap_k), blob, t)`` for :meth:`dispatch`.
        ``unit``: the chunk's number in the ``slot_wait`` spans it records
        (:attr:`spans`); the wait itself is left in :attr:`slot_wait_ns`.

        Safe to call from a fill thread while another thread dispatches
        earlier chunks: calls are serialized by a lock, wait while
        ``N_SLOTS - 1`` chunks are prepared and not dispatched, and
        rewrite a slot only after the event recorded after its last upload.
        A caller that uploads the blob itself releases the slot with
        :meth:`mark_dispatched`."""
        with self._call_lock:
            return self._prepare_impl(tokens_list, pct_list, unit)

    def _prepare_impl(self, tokens_list, pct_list, unit):
        t = len(tokens_list)
        if not 0 < t <= self.chunk:
            raise ValueError(f"{t} pictures for a chunk of {self.chunk}")
        fs = self.inner.field_support
        if not fs and any(tok.field_pred.any() for tok in tokens_list):
            raise ValueError("field-predicted MBs need a GopRecon with "
                             "field_support=True")
        if self._packers is None:
            self._packers = pair_packers()
        count_pairs = self._packers[0]
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
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        with self._cv:
            while self._seq_prep - self._seq_disp >= self.N_SLOTS - 1:
                self._cv.wait()
            self._seq_prep += 1
        try:
            slot = self._staging(cap_pairs, cap_k, self._stage_idx)
            self._stage_idx = (self._stage_idx + 1) % self.N_SLOTS
            if slot.guard is not None:
                slot.guard.synchronize()
                slot.guard = None
            t1 = time.time_ns()
            self.spans.end(span, "slot_wait", unit, t1)
            self.slot_wait_ns = t1 - t0
            self._fill(slot.blob, tokens_list, pct_list, cap_pairs, cap_k,
                       nnz[:off], total_nz)
        except BaseException:
            # nothing will dispatch this chunk: give its place back
            with self._cv:
                self._seq_prep -= 1
                self._cv.notify_all()
            raise
        return ((cap_pairs, cap_k), slot.blob, t)

    def _fill(self, blob, tokens_list, pct_list, cap_pairs, cap_k, nnz,
              total_nz):
        """Write one chunk into a staging blob (the layout of
        :meth:`_layout`); ``nnz``: the nonzeros of every coded row."""
        g = self.geom
        n_rows = g.n_mb * g.blocks_per_mb
        fs = self.inner.field_support
        t = len(tokens_list)
        pp, pv, pn, sp, pk, fl, sm = self._views(blob, cap_pairs, cap_k)
        pack_pairs_fn = self._packers[1]
        pn[:len(nnz)] = nnz
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
            pack_meta2(tok, fs, out=sm[i])
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

    def upload(self, staged):
        """The staged blob on the device, and the slot's guard: on ``cuda``
        a copy from the pinned slot that does not block the host, on the
        current stream, with a CUDA event recorded after it (the guard);
        on the CPU a copy, so that no tensor aliases the slot (no guard).
        The slot stays taken until :meth:`mark_dispatched`."""
        slot = self._slot_of(staged)
        if slot.pinned is None:
            return torch.from_numpy(slot.blob).to(self.device,
                                                  copy=True), None
        up = slot.pinned.to(self.device, non_blocking=True)
        guard = torch.cuda.Event()
        guard.record()
        return up, guard

    def mark_dispatched(self, staged, guard) -> None:
        """Release a staged slot once its blob is uploaded (the JAX
        package's ``GopRecon.mark_dispatched``): ``guard``, the event
        recorded after the upload (``None`` when the upload has completed),
        is waited on before the slot is rewritten, and one more chunk may
        be prepared.  :meth:`dispatch` calls it; so must any caller that
        prepares and uploads by itself, or its third ``prepare`` waits
        forever."""
        self._slot_of(staged).guard = guard
        with self._cv:
            self._seq_disp += 1
            self._cv.notify_all()

    def upload_decode(self, staged, devices) -> dict:
        """Upload a staged chunk (:meth:`upload`), release its slot, and
        decode its blob (:meth:`_decode_blob`: the chunk transport) once
        on each distinct device of ``devices``, the uploaded blob copied
        from this recon's device to the others: a dict device -> ``(dense,
        meta, step flags)``."""
        (cap_pairs, cap_k), _, _ = staged
        up = self._upload_released(staged)
        out = {}
        for dev in devices:
            if dev not in out:
                with on_device(dev):
                    out[dev] = self._decode_blob(
                        up.to(dev), cap_pairs=cap_pairs, cap_k=cap_k)
        return out

    def _upload_released(self, staged):
        """:meth:`upload`, then :meth:`mark_dispatched`, which releases
        the slot even when the upload failed: a fill thread waiting in
        ``prepare`` would otherwise wait forever."""
        guard = None
        try:
            up, guard = self.upload(staged)
        finally:
            self.mark_dispatched(staged, guard)
        return up

    def dispatch(self, staged, ref0=None, ref1=None, bidir: bool = True,
                 unit: int = 0):
        """Stage 2: upload the staged blob (:meth:`upload`), release its
        slot and reconstruct the chunk.  Must be called in chunk order (the
        reference planes carry over); returns (ref0, ref1, packed
        (t, frame_bytes) uint8).  ``bidir=False`` selects the forward-only
        kernels for every picture — only valid when no picture in the chunk
        is B-coded.  The same staged chunk may be dispatched again while
        no later ``prepare`` has taken its slot.  ``unit``: the chunk's
        number in the ``upload`` and ``recon`` spans it records."""
        (cap_pairs, cap_k), blob, t = staged
        o5 = self._layout(cap_pairs, cap_k)[5]
        step_flags = blob[o5:o5 + t].copy()
        if ref0 is None:
            ref0 = self.inner.zero_planes()
        if ref1 is None:
            ref1 = self.inner.zero_planes()
        span = self.spans.begin()
        up = self._upload_released(staged)
        self.spans.end(span, "upload", unit)
        span = self.spans.begin()
        out = self._gop(up, tuple(ref0), tuple(ref1), cap_pairs=cap_pairs,
                        cap_k=cap_k, step_flags=step_flags, bidir=bidir)
        self.spans.end(span, "recon", unit)
        return out


# kernels the chunk transport launches a call (csrc/transport.cu)
TRANSPORT_LAUNCHES = 3


def transport_grid(blob, layout, *, cap_pairs, cap_k, chunk, n_rows,
                   scat_u16):
    """The chunk transport kernel (``csrc/transport.cu``) on a CUDA blob,
    on the current stream of its device: the blob's pairs, row counts,
    block positions and per-picture row counts (the sections of
    ``layout``, :meth:`GopRecon._layout`) -> the residual block grid
    ``(chunk * n_rows, 64)`` int16, every block written once by the
    kernel.  Raises unless the blob is a contiguous 1-D uint8 tensor of at
    least the layout's length, 4-byte aligned (its int16 and int32
    sections are read in place).  Counts :data:`TRANSPORT_LAUNCHES` under
    ``"transport"`` in ``_build.LAUNCHES``."""
    if (blob.dtype != torch.uint8 or blob.dim() != 1
            or not blob.is_contiguous() or blob.numel() < layout[-1]):
        raise ValueError("transport_grid: expected a contiguous 1-D uint8 "
                         f"blob of at least {layout[-1]} bytes, got "
                         f"{tuple(blob.shape)} {blob.dtype}")
    if blob.data_ptr() % 4:
        raise ValueError("transport_grid: the blob must be 4-byte aligned "
                         "(its sections are read in their own widths)")
    span = chunk * n_rows
    dev = blob.device
    dense = torch.empty((span, 64), dtype=torch.int16, device=dev)
    # rowblk, blkrow and the tiles' pair offsets: the kernel reads no entry
    # it has not written in the same call
    scratch = torch.empty(cap_k + span + (cap_k + 31) // 32,
                          dtype=torch.int32, device=dev)
    base = blob.data_ptr()
    rc = _build.kernel_library().mp2v_transport(
        *(base + o for o in layout[:5]), cap_pairs, cap_k, chunk, n_rows,
        int(scat_u16), scratch.data_ptr(), dense.data_ptr(),
        _build.stream_handle(dev))
    _build.check("mp2v_transport", rc)
    _build.LAUNCHES["transport"] += TRANSPORT_LAUNCHES
    return dense


def on_device(dev):
    """A context in which ``dev``'s kernels launch: a CUDA device made
    current (the kernels launch on the current device's stream), or for the
    CPU nothing."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class _Slot:
    """One staging buffer of :class:`GopRecon`: the blob (a numpy view of
    ``pinned`` on ``cuda``), and ``guard``, the CUDA event recorded after
    its last upload, or ``None`` when it may be rewritten at once."""

    __slots__ = ("blob", "pinned", "guard")

    def __init__(self, blob: np.ndarray, pinned):
        self.blob = blob
        self.pinned = pinned
        self.guard = None
