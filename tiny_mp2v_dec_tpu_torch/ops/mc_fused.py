"""Fused motion compensation + residual add + saturation, per plane.

Counterpart of ``tiny_mp2v_dec_tpu/ops/mc_pallas.py``:

* :func:`fused_mc_recon` — one luma plane; CUDA kernel K2
  (``csrc/mc_recon.cu``, replaces ``fused_mc_recon_mxu``);
* :func:`fused_mc_recon_uv` — both chroma planes in one pass, sharing each
  MB's window start, phase and mode; CUDA kernel K3 (replaces
  ``fused_mc_recon_uv_mxu``) at the chroma tile of every format: 8x8
  (4:2:0), 16x8 (4:2:2, 16 rows by 8 columns) and 16x16 (4:4:4).  U and V
  stay planar: the JAX package's column interleave was a Mosaic
  workaround.

Both take the JAX kernels' per-MB int32 vectors (clamped window starts
``sy``/``sx`` and phase ``ph`` per direction from :func:`mc_meta`, and
``mode`` bits 1 = forward, 2 = backward, 4 = coded, 8 = field prediction)
and ``bidir`` (``False`` is the forward-only form, which ignores mode bit
2).  Given the per-direction field tuples ``fld_f``/``fld_b`` of
:func:`mc_field_meta`, an MB whose mode has bit 8 set takes field-based
prediction: kernel K4, the field form of K2/K3 (replaces
``_field_pred_mxu``).  Without them bit 8 is ignored.  Reference planes
are unpadded ``(Hr, Wr)`` uint8; taps beyond them read 0.  A CPU tensor
takes the plain version (``*_ref``), built from :mod:`.mc`; a CUDA tensor
takes the kernel; any other device raises.  K2, K3 and K4 are forms of one
kernel (``csrc/mc_recon.cu``, one thread per 8-pixel row segment): they
read the references as 32-bit words and the residual 8 pixels at a time,
so on the card they raise unless the references are 4-byte aligned with
``Wr % 4 == 0`` and each residual plane is 16-byte aligned.

The decoder's ``mxu`` path takes the blocks form of K2/K3/K4:
:func:`fused_mc_recon_blocks` (luma) and :func:`fused_mc_recon_uv_blocks`
(U and V) read a picture's int16 metadata rows as the chunk blob carries
them (``ops/recon.py`` ``pack_meta2``: 5 columns, or 9 with field motion,
which selects the field form) and the IDCT's residual block grid
``(n_mb * blocks_per_mb, 64)`` int16, and each kernel thread derives its
MB's mode, positions, window starts, phases, field units and residual row
itself.  Their plain versions are the per-picture PyTorch glue that turns
those two inputs into the vector form's (:func:`blocks_to_vectors`),
then the vector form's plain versions.  The decoder launches them grouped:
:func:`fused_mc_recon_blocks_group` reconstructs luma and U+V of up to
:data:`GROUP_MAX` pictures of one geometry, none of which reads another's
output, in one launch.

The JAX package's two other MC implementations (``MP2V_MC_IMPL``, see
:mod:`.recon`) have their kernels here too:

* ``roll``: :func:`fused_mc_recon_roll` (K5, ``csrc/mc_roll.cu``, replaces
  ``fused_mc_recon``) and :func:`fused_mc_recon_uv_roll` (K6, replaces
  ``fused_mc_recon_uv``) — K2's and K3's function, frame prediction only,
  each aligned word of an MB's window loaded once by one lane, the words
  rotated into place by funnel shifts and warp shuffles, one 8-pixel row
  segment per lane: K5 one warp per MB, K6 a warp per 16x16 plane tile,
  per plane of two 16x8 MBs, or per U and V of two 8x8 MBs (both read the
  residual 16 bytes at a time, as K2);
* ``swar``: the prediction alone, four pixels per 32-bit word
  (:func:`pack_ref_words`), no residual and no coded bit.  K7
  (``csrc/mc_swar.cu``) has two entry points:
  :func:`fused_mc_pred_swar_yuv`, the three components of one picture in
  one launch (one thread per 8-pixel row segment), which the decode path
  takes, and :func:`fused_mc_pred_swar`, one component per call as the JAX
  kernel (one thread per word).
  The field form :func:`fused_mc_pred_swar_field` (K8, a form of K4's
  segment kernel in ``csrc/mc_recon.cu``) takes one component per call.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..headers import CHROMA_420
from ..tokenizer.types import CHROMA_INFO
from . import _build
from .mc import (field_views, gather_windows, gather_windows_fields,
                 halfpel_select, mc_bidir_tiles, pad_for_mc)


def mc_meta(pos_y, pos_x, mvx, mvy, H: int, W: int, h: int, w: int):
    """Per-MB window start + phase from half-pel MVs (clamp identical to
    :func:`.mc.gather_windows`: [0, H-h] x [0, W-w])."""
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    sy = torch.clamp(pos_y + (mvy >> 1), 0, H - h).to(torch.int32)
    sx = torch.clamp(pos_x + (mvx >> 1), 0, W - w).to(torch.int32)
    ph = ((mvx & 1) + 2 * (mvy & 1)).to(torch.int32)
    return sy, sx, ph


def mc_field_meta(pos_y, pos_x, mvc_dir, mvfs_dir, H: int, W: int,
                  h: int, w: int):
    """Per-MB field-prediction vectors for one direction.

    ``mvc_dir``: (n, 2:unit, 2:xy) component-scaled half-pel MVs;
    ``mvfs_dir``: (n, 2:unit) motion_vertical_field_select.  Returns the
    6-tuple (C0, sx0, ph0, C1, sx1, ph1) of (n,) int32: ``C_r = 2*syf_r +
    sel_r - r`` is unit r's affine row base in frame rows, with the field
    window start ``syf_r`` clamped to [0, H/2 - h/2] in *field* rows and
    ``sx_r`` to [0, W - w], as :func:`.mc.mc_field_tiles` clamps them."""
    out = []
    for r in range(2):
        mvx = mvc_dir[:, r, 0].to(torch.int32)
        mvy = mvc_dir[:, r, 1].to(torch.int32)
        syf = torch.clamp((pos_y >> 1) + (mvy >> 1), 0, H // 2 - h // 2)
        sx = torch.clamp(pos_x + (mvx >> 1), 0, W - w)
        ph = (mvx & 1) + 2 * (mvy & 1)
        c = 2 * syf + mvfs_dir[:, r].to(torch.int32) - r
        out += [c.to(torch.int32), sx.to(torch.int32), ph.to(torch.int32)]
    return tuple(out)


# ----------------------------------------------------------------------
# the blocks form's inputs as the vector form's: the per-picture glue of
# the plain versions of the blocks form, and of the roll and swar paths
# (ops/recon.py)


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
    """Vectorized chroma MV derivation, frame and field vectors alike;
    mv: (..., 2) [x, y] int16."""
    mvx, mvy = mv[..., 0], mv[..., 1]
    if cf < 3:
        mvx = mvx >> 1
    if cf < 2:
        mvy = mvy >> 1
    return torch.stack([mvx, mvy], dim=-1)


def _unpack_meta2(meta, field_support: bool):
    """(n, cols) metadata -> (dct_type, fwd, bwd, field_pred, coded) bool
    vectors, the (n, units, 2:dir, 2:xy) int16 MVs (one unit without field
    support, two with) and the (n, 2:unit, 2:dir) motion_vertical_field
    selects (``None`` without field support)."""
    n = meta.shape[0]
    flags = meta[:, 0]
    if field_support:
        mvfs = torch.stack([(flags >> (5 + b)) & 1 for b in range(4)],
                           dim=-1).reshape(n, 2, 2)
        mv = meta[:, 1:9].reshape(n, 2, 2, 2)
    else:
        mvfs = None
        mv = meta[:, 1:5].reshape(n, 1, 2, 2)
    return ((flags & 1) != 0, (flags & 2) != 0, (flags & 4) != 0,
            (flags & 8) != 0, (flags & 16) != 0, mv, mvfs)


def blocks_to_vectors(ref, dense, meta, chroma_format: int, mbw: int,
                      mb0: int = 0, uv: bool = False):
    """The vector form's inputs for one call of the blocks form: luma, or
    with ``uv`` U and V.  ``dense``: the (n_mb * blocks_per_mb, 64) int16
    residual block grid; ``meta``: the (n_mb, 5 or 9) int16 metadata rows
    (9: field motion); MB ``i`` is MB ``mb0 + i`` of a picture ``mbw`` MBs
    wide; ``ref``: a reference plane of the component, whose shape the
    window starts are clamped to.  Returns (residual planes — one, or U
    and V — the vectors ``(syf, sxf, phf, syb, sxb, phb, mode, fld_f,
    fld_b)``, the field tuples ``None`` without field motion, tile rows,
    tile columns)."""
    fs = meta.shape[1] == 9
    dct_type, fwd, bwd, field_pred, coded, mv, mvfs = _unpack_meta2(meta,
                                                                    fs)
    n = meta.shape[0]
    xs, ys, n_cb = CHROMA_INFO[chroma_format]
    residual = dense.view(n, 4 + 2 * n_cb, 8, 8)
    mode = (fwd.to(torch.int32) + 2 * bwd.to(torch.int32)
            + 4 * coded.to(torch.int32))
    if fs:
        mode = mode + 8 * field_pred.to(torch.int32)
    g = mb0 + torch.arange(n, dtype=torch.int32, device=meta.device)
    py, px = (g // mbw) * 16, (g % mbw) * 16
    if uv:
        h, w = 16 >> ys, 16 >> xs
        py, px = py >> ys, px >> xs
        # U and V share the scaled MVs (planar, so no doubled sx)
        mv = _scale_mv(mv, chroma_format)
        # field DCT interleaves chroma rows too where a chroma block column
        # spans the MB's 16 rows (4:2:2, 4:4:4)
        inter = dct_type if chroma_format != CHROMA_420 else None
        blocks = (residual[:, 4:4 + n_cb], residual[:, 4 + n_cb:])
    else:
        h = w = 16
        inter = dct_type
        blocks = (residual[:, :4],)
    res = tuple(_plane_from_tiles(_tiles_from_blocks(b, h // 8, w // 8,
                                                     inter),
                                  n // mbw, mbw, h, w) for b in blocks)
    H, W = ref.shape
    vecs = [*mc_meta(py, px, mv[:, 0, 0, 0], mv[:, 0, 0, 1], H, W, h, w),
            *mc_meta(py, px, mv[:, 0, 1, 0], mv[:, 0, 1, 1], H, W, h, w),
            mode]
    vecs += ([mc_field_meta(py, px, mv[:, :, s], mvfs[:, :, s], H, W, h, w)
              for s in range(2)] if fs else [None, None])
    return res, vecs, h, w


# ----------------------------------------------------------------------
# plain versions


def _pred(ref, sy, sx, ph, h, w):
    win = gather_windows(pad_for_mc(ref), sy, sx, h, w)
    return halfpel_select(win, ph & 1, (ph >> 1) & 1, h, w)


def _field_pred(ref, fld, h, w):
    """Field-based prediction of (n, h, w) tiles from the two padded field
    views: unit r fills the tile rows of parity r.  The field window start
    and select come back out of the affine row base (``C_r + r = 2*syf_r +
    sel_r``), and each unit is :func:`.mc.mc_field_tiles`' gather + phase
    select — the JAX package's XLA formulation, not the kernel's."""
    fields = field_views(ref)
    units = []
    for r in range(2):
        c, sx, ph = fld[3 * r:3 * r + 3]
        row = c + r
        win = gather_windows_fields(fields, row & 1, row >> 1, sx, h // 2, w)
        units.append(halfpel_select(win, ph & 1, (ph >> 1) & 1, h // 2, w))
    return torch.stack(units, dim=2).reshape(-1, h, w)


def fused_mc_recon_ref(ref0, ref1, res_plane, syf, sxf, phf, syb, sxb, phb,
                       mode, fld_f=None, fld_b=None, *, h: int, w: int,
                       bidir: bool = True):
    """Plain PyTorch version of K2 (and, with the field tuples, K4) on any
    device: (H, W) uint8."""
    H, W = res_plane.shape
    mbh, mbw = H // h, W // w
    f = ((mode & 1) != 0)[:, None, None]
    fld = ((mode & 8) != 0)[:, None, None]
    pf = _pred(ref0, syf, sxf, phf, h, w)
    if fld_f is not None:
        pf = torch.where(fld, _field_pred(ref0, fld_f, h, w), pf)
    zero = torch.zeros((), dtype=torch.uint8, device=pf.device)
    if bidir:
        b = ((mode & 2) != 0)[:, None, None]
        pb = _pred(ref1, syb, sxb, phb, h, w)
        if fld_b is not None:
            pb = torch.where(fld, _field_pred(ref1, fld_b, h, w), pb)
        pred = torch.where(f & b, mc_bidir_tiles(pf, pb),
                           torch.where(f, pf, torch.where(b, pb, zero)))
    else:
        pred = torch.where(f, pf, zero)
    res = res_plane.reshape(mbh, h, mbw, w).permute(0, 2, 1, 3).reshape(
        mbh * mbw, h, w)
    val = torch.clamp(pred.to(torch.int32) + res.to(torch.int32), 0, 255)
    val = torch.where(((mode & 4) != 0)[:, None, None], val, 0)
    return val.to(torch.uint8).reshape(mbh, mbw, h, w).permute(
        0, 2, 1, 3).reshape(H, W)


def fused_mc_recon_uv_ref(ref0, ref1, res, syf, sxf, phf, syb, sxb, phb,
                          mode, fld_f=None, fld_b=None, *, h: int, w: int,
                          bidir: bool = True):
    """Plain PyTorch version of K3 (and, with the field tuples, K4) on any
    device.  ``ref0``/``ref1``/``res`` are (U, V) pairs; returns the (U, V)
    pair of (H, W) uint8 planes."""
    return tuple(
        fused_mc_recon_ref(ref0[k], ref1[k], res[k], syf, sxf, phf, syb,
                           sxb, phb, mode, fld_f, fld_b, h=h, w=w,
                           bidir=bidir)
        for k in range(2))


def fused_mc_recon_blocks_ref(ref0, ref1, dense, meta, *,
                              chroma_format: int, mbw: int, mb0: int = 0,
                              bidir: bool = True):
    """Plain PyTorch version of the blocks form's luma on any device:
    :func:`blocks_to_vectors`, then :func:`fused_mc_recon_ref`."""
    (res,), vecs, h, w = blocks_to_vectors(ref0, dense, meta, chroma_format,
                                           mbw, mb0)
    return fused_mc_recon_ref(ref0, ref1, res, *vecs, h=h, w=w, bidir=bidir)


def fused_mc_recon_uv_blocks_ref(ref0, ref1, dense, meta, *,
                                 chroma_format: int, mbw: int, mb0: int = 0,
                                 bidir: bool = True):
    """Plain PyTorch version of the blocks form's U and V on any device:
    :func:`blocks_to_vectors`, then :func:`fused_mc_recon_uv_ref`."""
    res, vecs, h, w = blocks_to_vectors(ref0[0], dense, meta, chroma_format,
                                        mbw, mb0, uv=True)
    return fused_mc_recon_uv_ref(ref0, ref1, res, *vecs, h=h, w=w,
                                 bidir=bidir)


# ----------------------------------------------------------------------
# SWAR words: four pixels per 32-bit word.  Words are held in int32 (the
# kernels' output) or, in the plain versions, in int64 holding the unsigned
# value: PyTorch's CPU shifts have no ``torch.uint32`` form.


def pack_ref_words(plane):
    """(H, W) uint8 -> (H, W // 4) int32 words, pixel x at byte x % 4 (least
    significant first) of word x // 4.  A byte view of the plane (the
    kernels read the unpadded plane as words the same way)."""
    return plane.contiguous().view(torch.int32)


def unpack_words(words):
    """(H, W // 4) int32 words -> (H, W) uint8 (inverse of
    :func:`pack_ref_words`), a byte view."""
    return words.contiguous().view(torch.uint8)


def avg_up(x, y):
    """Per-byte ``(x + y + 1) >> 1`` of packed words, free of carries
    across bytes: ``(x | y) - (((x ^ y) >> 1) & 0x7F7F7F7F)``.  The mask
    also clears what an arithmetic shift of a negative int32 brings in."""
    return (x | y) - (((x ^ y) >> 1) & 0x7F7F7F7F)


def _funnel(lo, hi, s):
    """Low 32 bits of ``(hi:lo) >> s`` for 0 <= s <= 32 (CUDA's
    ``__funnelshift_rc``) on int64 words holding unsigned values."""
    return (lo >> s) | ((hi & ((torch.ones_like(s) << s) - 1)) << (32 - s))


def _swar_words(ref):
    """int64 words of an unpadded (Hr, Wr) plane with one zero word past
    each row and two zero rows below: every tap the predictions take beyond
    the plane reads 0 there, as the kernels' bounds checks make it."""
    words = pack_ref_words(ref).to(torch.int64) & 0xFFFFFFFF
    return F.pad(words, (0, 1, 0, 2))


def _swar_pred(words, row, sx, ph, vs, wpm):
    """Packed half-pel prediction: (n, h, wpm) int64 words.  ``row``,
    ``sx``, ``ph``: (n, h) int64 per tile row — the source row of the row's
    a/b taps (c/d ``vs`` rows below), its first pixel column and its
    phase.  Each output word funnel-shifts the two source words it
    straddles, as the kernel does."""
    cols = (sx >> 2)[..., None] + torch.arange(wpm + 1, device=words.device)
    s = ((sx & 3) << 3)[..., None]

    def taps(r):
        win = words[r[..., None], cols]
        lo, hi = win[..., :-1], win[..., 1:]
        return _funnel(lo, hi, s), _funnel(lo, hi, s + 8)

    a, b = taps(row)
    c, d = taps(row + vs)
    hx = ((ph & 1) != 0)[..., None]
    hy = ((ph & 2) != 0)[..., None]
    ab = avg_up(a, b)
    return torch.where(hx & hy, avg_up(ab, avg_up(c, d)),
                       torch.where(hx, ab, torch.where(hy, avg_up(a, c), a)))


def _swar_dir(ref, sy, sx, ph, fld, mode, h, w):
    """One direction's packed prediction of every MB: (n, h, w/4) int64.
    With the field tuple, MBs with mode bit 8 take field prediction: tile
    row j belongs to unit r = j & 1, whose source row is ``C_r + j`` with
    taps two rows apart (the row of the unit's own parity, never row -1)."""
    words = _swar_words(ref)
    i64 = lambda x: x.to(torch.int64)  # noqa: E731
    j = torch.arange(h, device=ref.device)
    per_row = lambda x: i64(x)[:, None].expand(-1, h)  # noqa: E731
    pred = _swar_pred(words, i64(sy)[:, None] + j, per_row(sx), per_row(ph),
                      1, w // 4)
    if fld is not None:
        odd = (j & 1) != 0
        unit = lambda x0, x1: torch.where(  # noqa: E731
            odd, i64(x1)[:, None], i64(x0)[:, None])
        c0, x0, p0, c1, x1, p1 = fld
        fpred = _swar_pred(words, unit(c0, c1) + j, unit(x0, x1),
                           unit(p0, p1), 2, w // 4)
        pred = torch.where(((mode & 8) != 0)[:, None, None], fpred, pred)
    return pred


def _swar_ref(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode, fld_f, fld_b,
              h, w, bidir, H=None):
    """The packed prediction of an (H, Wr) output, by default the reference
    planes' whole (Hr, Wr): a smaller ``H`` is a band of MB rows, whose
    window vectors stay in the reference's coordinates."""
    Hr, Wr = ref0.shape
    H = Hr if H is None else H
    mbh, mbw = H // h, Wr // w
    f = ((mode & 1) != 0)[:, None, None]
    pred = _swar_dir(ref0, syf, sxf, phf, fld_f, mode, h, w)
    if bidir:
        b = ((mode & 2) != 0)[:, None, None]
        pb = _swar_dir(ref1, syb, sxb, phb, fld_b, mode, h, w)
        pred = torch.where(f & b, avg_up(pred, pb),
                           torch.where(f, pred, torch.where(b, pb, 0)))
    else:
        pred = torch.where(f, pred, 0)
    return words_to_int32(pred.reshape(mbh, mbw, h, w // 4).permute(
        0, 2, 1, 3).reshape(H, Wr // 4))


def words_to_int32(words):
    """int64 words holding unsigned 32-bit values -> the int32 of the same
    bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def fused_mc_pred_swar_ref(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode,
                           *, h: int, w: int, bidir: bool = True,
                           H: int | None = None):
    """Plain PyTorch version of K7 on any device: the packed frame
    prediction of one (Hr, Wr) component, (H, Wr // 4) int32 words (``H``
    the output rows, by default Hr).  A word formulation (funnel shifts,
    :func:`avg_up`), beside the unpacked gather of
    :func:`fused_mc_recon_ref`."""
    return _swar_ref(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode, None,
                     None, h, w, bidir, H)


def fused_mc_pred_swar_yuv_ref(ref0, ref1, meta_y, meta_c, mode, *,
                               h: int = 8, w: int = 8, bidir: bool = True,
                               H: int | None = None):
    """Plain PyTorch version of K7's picture form on any device: the three
    word planes of :func:`fused_mc_pred_swar_yuv`, one
    :func:`fused_mc_pred_swar_ref` per component."""
    H = ref0[0].shape[0] if H is None else H
    tiles = ((16, 16, meta_y), (h, w, meta_c), (h, w, meta_c))
    return tuple(
        fused_mc_pred_swar_ref(r0, r1, *meta, mode, h=th, w=tw, bidir=bidir,
                               H=H // 16 * th)
        for r0, r1, (th, tw, meta) in zip(ref0, ref1, tiles))


def fused_mc_pred_swar_field_ref(ref0, ref1, syf, sxf, phf, syb, sxb, phb,
                                 mode, fld_f, fld_b, *, h: int, w: int,
                                 bidir: bool = True, H: int | None = None):
    """Plain PyTorch version of K8 on any device: K7's words, with field
    prediction on the MBs whose mode has bit 8."""
    return _swar_ref(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode, fld_f,
                     fld_b, h, w, bidir, H)


# ----------------------------------------------------------------------
# kernel wrappers

_LUMA = {(16, 16)}
_CHROMA = {(8, 8), (16, 8), (16, 16)}
# C entry point -> the (h, w) tiles it is instantiated for
_TILES = {
    "mp2v_mc_recon_luma": _LUMA,
    "mp2v_mc_field_luma": _LUMA,
    "mp2v_mc_roll_luma": _LUMA,
    "mp2v_mc_recon_uv": _CHROMA,
    "mp2v_mc_field_uv": _CHROMA,
    "mp2v_mc_roll_uv": _CHROMA,
    # one component per call: luma takes 16x16, which is a chroma tile too
    "mp2v_mc_swar": _CHROMA,
    "mp2v_mc_swar_field": _CHROMA,
    # one picture per call: luma 16x16, then U and V at the chroma tile
    "mp2v_mc_swar_yuv": _CHROMA,
}
# entry points that read the reference planes as 32-bit words
_WORD_READS = {"mp2v_mc_recon_luma", "mp2v_mc_recon_uv", "mp2v_mc_field_luma",
               "mp2v_mc_field_uv", "mp2v_mc_roll_luma", "mp2v_mc_roll_uv",
               "mp2v_mc_swar", "mp2v_mc_swar_field", "mp2v_mc_swar_yuv"}
# entry points that load the residual 16 bytes and store the output 8 bytes
# at a time (one 8-pixel row segment per thread); the outputs are allocated
# by _launch, so only the residual is checked
_VECTOR_IO = {"mp2v_mc_recon_luma", "mp2v_mc_recon_uv", "mp2v_mc_field_luma",
              "mp2v_mc_field_uv", "mp2v_mc_roll_luma", "mp2v_mc_roll_uv"}


def _check(entry, refs0, refs1, ress, meta, h, w, H_out=None):
    """Check the planes and per-MB vectors kernel ``entry`` takes for one
    plane (or U and V) of (h x w) tiles; returns (H, W, Hr, Wr): the output
    planes' shape — the residual planes', or without a residual (the SWAR
    kernels) ``H_out`` rows (by default the reference planes' Hr) of the
    reference planes' width — and the reference planes'.  An output with
    fewer rows than the reference is a band of MB rows: its window vectors
    stay in the reference's coordinates."""
    if (h, w) not in _TILES[entry]:
        raise ValueError(f"{entry}: the kernel takes "
                         f"{sorted(_TILES[entry])} tiles, not {h}x{w}")
    dev = refs0[0].device
    Hr, Wr = refs0[0].shape
    H, W = ress[0].shape if ress else (Hr if H_out is None else H_out, Wr)
    if H % h or W % w:
        raise ValueError(f"{entry}: plane {H}x{W} is not a whole number of "
                         f"{h}x{w} tiles")
    n_mb = (H // h) * (W // w)
    for x in (*refs0, *refs1):
        if (x.device != dev or x.dtype != torch.uint8
                or tuple(x.shape) != (Hr, Wr) or not x.is_contiguous()):
            raise ValueError(f"{entry}: reference planes must be contiguous "
                             f"({Hr}, {Wr}) uint8 on {dev}")
        if entry in _WORD_READS and (Wr % 4 or x.data_ptr() % 4):
            raise ValueError(f"{entry}: reference planes must be 4-byte "
                             f"aligned with a width divisible by 4")
    if Hr < H or Wr < W:
        raise ValueError(f"{entry}: reference {Hr}x{Wr} smaller than the "
                         f"output {H}x{W}")
    for x in ress:
        if (x.device != dev or x.dtype != torch.int16
                or tuple(x.shape) != (H, W) or not x.is_contiguous()):
            raise ValueError(f"{entry}: residual planes must be contiguous "
                             f"({H}, {W}) int16 on {dev}")
        if entry in _VECTOR_IO and x.data_ptr() % 16:
            raise ValueError(f"{entry}: residual planes must be 16-byte "
                             f"aligned")
    for x in meta:
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != (n_mb,) or not x.is_contiguous()):
            raise ValueError(f"{entry}: per-MB vectors must be contiguous "
                             f"({n_mb},) int32 on {dev}")
    return H, W, Hr, Wr


def _call(entry, counter, ptrs, h, w, n_mb, mbw, Hr, Wr, bidir, dev):
    """Launch kernel ``entry`` on the current stream of ``dev`` with the
    pointer array ``ptrs`` (padded with nulls to ``MC_PTRS``) and count
    it."""
    ptrs = [*ptrs, *[0] * (_build.MC_PTRS - len(ptrs))]
    lib = _build.kernel_library()
    rc = getattr(lib, entry)((ctypes.c_void_p * _build.MC_PTRS)(*ptrs), h,
                             w, n_mb, mbw, Hr, Wr, int(bidir),
                             _build.stream_handle(dev))
    _build.check(entry, rc)
    _build.LAUNCHES[counter] += 1


def _launch(entry, counter, refs0, refs1, ress, meta, h, w, bidir,
            H_out=None):
    """Check the arguments of kernel ``entry`` and launch it on the
    current stream; returns the output planes: one (H, W) uint8 plane per
    residual plane, or — for the SWAR kernels, given no residual — the
    (H_out, Wr // 4) int32 words (by default the reference planes' whole
    extent)."""
    H, W, Hr, Wr = _check(entry, refs0, refs1, ress, meta, h, w, H_out)
    dev = refs0[0].device
    if ress:
        outs = tuple(torch.empty((H, W), dtype=torch.uint8, device=dev)
                     for _ in ress)
    else:
        outs = (torch.empty((H, W // 4), dtype=torch.int32, device=dev),)
    pair = lambda xs: (  # noqa: E731
        (xs[0].data_ptr(), xs[-1].data_ptr()) if xs else (0, 0))
    ptrs = [*pair(refs0), *pair(refs1), *pair(ress), *pair(outs),
            *(x.data_ptr() for x in meta)]
    _call(entry, counter, ptrs, h, w, (H // h) * (W // w), W // w, Hr, Wr,
          bidir, dev)
    return outs


def _launch_yuv(refs0, refs1, meta_y, meta_c, mode, h, w, bidir, H=None):
    """Check the arguments of K7's picture form — :func:`_check` on luma
    (16x16) and on U and V (h x w), then that the chroma planes are the
    luma plane's at that tile — and launch it on the current stream;
    returns the three int32 word planes of ``H`` luma rows (by default the
    luma reference's Hr; a band of MB rows when fewer) and the chroma rows
    of those MBs."""
    entry = "mp2v_mc_swar_yuv"
    if not len(refs0) == len(refs1) == 3 or not len(meta_y) == len(
            meta_c) == 6:
        raise ValueError(f"{entry}: takes (Y, U, V) reference triples and "
                         f"six per-MB vectors each for luma and chroma")
    if H is not None and H % 16:
        raise ValueError(f"{entry}: {H} luma rows are not whole MB rows")
    band = H
    H, _, Hr, Wr = _check(entry, refs0[:1], refs1[:1], (), (*meta_y, mode),
                          16, 16, band)
    Hc, _, *shape_c = _check(entry, refs0[1:], refs1[1:], (),
                             (*meta_c, mode), h, w,
                             None if band is None else band // 16 * h)
    if tuple(shape_c) != (Hr // 16 * h, Wr // 16 * w):
        raise ValueError(f"{entry}: chroma planes {shape_c[0]}x{shape_c[1]} "
                         f"are not the {Hr}x{Wr} luma plane's at {h}x{w} "
                         f"tiles")
    dev = refs0[0].device
    outs = tuple(torch.empty((rows, x.shape[1] // 4), dtype=torch.int32,
                             device=dev)
                 for rows, x in zip((H, Hc, Hc), refs0))
    ptrs = [x.data_ptr() for x in (*refs0, *refs1, *outs, *meta_y, *meta_c,
                                   mode)]
    _call(entry, "mc_swar_yuv", ptrs, h, w, (H // 16) * (Wr // 16), Wr // 16,
          Hr, Wr, bidir, dev)
    return outs


def _device_type(entry, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{entry}: no kernel for device {x.device}")
    return x.device.type


def _route(fld_f, fld_b):
    """Kernel form and the per-MB vectors beyond the frame seven.  The
    field form takes both directions' tuples."""
    if (fld_f is None) != (fld_b is None):
        raise ValueError("the field form needs both fld_f and fld_b")
    if fld_f is None:
        return "recon", ()
    return "field", (*fld_f, *fld_b)


def fused_mc_recon(ref0, ref1, res_plane, syf, sxf, phf, syb, sxb, phb, mode,
                   fld_f=None, fld_b=None, *, h: int = 16, w: int = 16,
                   bidir: bool = True):
    """Reconstruct one (H, W) luma plane: (H, W) uint8.  CPU tensor: the
    plain version; CUDA tensor: kernel K2, or K4 when the field tuples are
    given."""
    form, fld = _route(fld_f, fld_b)
    if _device_type("fused_mc_recon", res_plane) == "cpu":
        return fused_mc_recon_ref(ref0, ref1, res_plane, syf, sxf, phf, syb,
                                  sxb, phb, mode, fld_f, fld_b, h=h, w=w,
                                  bidir=bidir)
    return _launch(f"mp2v_mc_{form}_luma", f"mc_{form}_luma", (ref0,),
                   (ref1,), (res_plane,),
                   (syf, sxf, phf, syb, sxb, phb, mode, *fld), h, w,
                   bidir)[0]


def fused_mc_recon_uv(ref0, ref1, res, syf, sxf, phf, syb, sxb, phb, mode,
                      fld_f=None, fld_b=None, *, h: int = 8, w: int = 8,
                      bidir: bool = True):
    """Reconstruct both chroma planes: ``ref0``/``ref1``/``res`` are (U, V)
    pairs, returns the (U, V) pair.  CPU tensors: the plain version; CUDA
    tensors: kernel K3, or K4 when the field tuples are given."""
    form, fld = _route(fld_f, fld_b)
    if _device_type("fused_mc_recon_uv", res[0]) == "cpu":
        return fused_mc_recon_uv_ref(ref0, ref1, res, syf, sxf, phf, syb,
                                     sxb, phb, mode, fld_f, fld_b, h=h, w=w,
                                     bidir=bidir)
    return _launch(f"mp2v_mc_{form}_uv", f"mc_{form}_uv", tuple(ref0),
                   tuple(ref1), tuple(res),
                   (syf, sxf, phf, syb, sxb, phb, mode, *fld), h, w, bidir)


def _check_blocks(entry, refs0, refs1, dense, meta, chroma_format, mbw,
                  mb0, h, w):
    """Check the arguments of the blocks form (:func:`fused_mc_recon_blocks`,
    :func:`fused_mc_recon_uv_blocks`) for (h x w) tiles on either device —
    attribute reads only, nothing per MB; returns the output planes' (H, W)
    and the reference planes' (Hr, Wr)."""
    if chroma_format not in CHROMA_INFO:
        raise ValueError(f"{entry}: chroma format {chroma_format} is not "
                         f"one of {sorted(CHROMA_INFO)}")
    dev = refs0[0].device
    if (meta.device != dev or meta.dtype != torch.int16 or meta.dim() != 2
            or meta.shape[1] not in (5, 9) or not meta.is_contiguous()):
        raise ValueError(f"{entry}: metadata rows must be contiguous "
                         f"(n_mb, 5) or (n_mb, 9) int16 on {dev}")
    n = meta.shape[0]
    rows = n * (4 + 2 * CHROMA_INFO[chroma_format][2])
    if (dense.device != dev or dense.dtype != torch.int16
            or tuple(dense.shape) != (rows, 64) or not dense.is_contiguous()):
        raise ValueError(f"{entry}: the residual block grid must be "
                         f"contiguous ({rows}, 64) int16 on {dev}")
    if dense.data_ptr() % 16:
        raise ValueError(f"{entry}: the residual block grid must be 16-byte "
                         f"aligned")
    if mbw <= 0 or n % mbw or mb0 < 0 or mb0 % mbw:
        raise ValueError(f"{entry}: {n} MBs from MB {mb0} are not whole "
                         f"rows of {mbw} MBs")
    Hr, Wr = refs0[0].shape
    for x in (*refs0, *refs1):
        if (x.device != dev or x.dtype != torch.uint8
                or tuple(x.shape) != (Hr, Wr) or not x.is_contiguous()):
            raise ValueError(f"{entry}: reference planes must be contiguous "
                             f"({Hr}, {Wr}) uint8 on {dev}")
        if Wr % 4 or x.data_ptr() % 4:
            raise ValueError(f"{entry}: reference planes must be 4-byte "
                             f"aligned with a width divisible by 4")
    H, W = n // mbw * h, mbw * w
    if mb0 // mbw * h + H > Hr or W > Wr:
        raise ValueError(f"{entry}: {H}x{W} output from MB row "
                         f"{mb0 // mbw} lies past the {Hr}x{Wr} reference")
    return H, W, Hr, Wr


def _blocks(entry, uv, ref0, ref1, dense, meta, chroma_format, mbw, mb0,
            bidir):
    """Check the blocks form's arguments and run it: on the CPU its plain
    version, on ``cuda`` kernel ``mp2v_mc_{recon,field}_blocks_{luma,uv}``
    — the field form for 9-column rows — on the current stream, counted in
    ``_build.LAUNCHES`` under the entry's name less ``mp2v_``.  Returns
    the output planes, one or (U, V)."""
    refs0, refs1 = (tuple(ref0), tuple(ref1)) if uv else ((ref0,), (ref1,))
    xs, ys, _ = CHROMA_INFO.get(chroma_format, (0, 0, 0))
    h, w = (16 >> ys, 16 >> xs) if uv else (16, 16)
    H, W, Hr, Wr = _check_blocks(entry, refs0, refs1, dense, meta,
                                 chroma_format, mbw, mb0, h, w)
    kw = dict(chroma_format=chroma_format, mbw=mbw, mb0=mb0, bidir=bidir)
    if _device_type(entry, dense) == "cpu":
        if uv:
            return fused_mc_recon_uv_blocks_ref(refs0, refs1, dense, meta,
                                                **kw)
        return (fused_mc_recon_blocks_ref(ref0, ref1, dense, meta, **kw),)
    dev = dense.device
    outs = tuple(torch.empty((H, W), dtype=torch.uint8, device=dev)
                 for _ in refs0)
    name = (f"mc_{'field' if meta.shape[1] == 9 else 'recon'}_blocks_"
            f"{'uv' if uv else 'luma'}")
    ptrs = [x.data_ptr() for x in (refs0[0], refs0[-1], refs1[0], refs1[-1],
                                   dense, meta, outs[0], outs[-1])]
    rc = getattr(_build.kernel_library(), f"mp2v_{name}")(
        (ctypes.c_void_p * _build.MC_BLOCKS_PTRS)(*ptrs), meta.shape[1],
        chroma_format, meta.shape[0], mb0, mbw, Hr, Wr, int(bidir),
        _build.stream_handle(dev))
    _build.check(f"mp2v_{name}", rc)
    _build.LAUNCHES[name] += 1
    return outs


def fused_mc_recon_blocks(ref0, ref1, dense, meta, *, chroma_format: int,
                          mbw: int, mb0: int = 0, bidir: bool = True):
    """Reconstruct one luma plane from a picture's residual block grid and
    metadata rows (the blocks form, see the module docstring): the
    (n_mb / mbw * 16, mbw * 16) uint8 plane of the rows' MBs, which are MBs
    ``mb0`` on of a picture ``mbw`` MBs wide (``mb0 > 0``: a band of whole
    MB rows; the window starts stay in the whole reference).  9-column rows
    take the field form.  CPU tensors: the plain version; CUDA tensors:
    the kernel, which needs the block grid 16-byte aligned and the
    references 4-byte aligned with a width divisible by 4; any other
    device raises.  Either device refuses what the kernel would."""
    return _blocks("fused_mc_recon_blocks", False, ref0, ref1, dense, meta,
                   chroma_format, mbw, mb0, bidir)[0]


def fused_mc_recon_uv_blocks(ref0, ref1, dense, meta, *, chroma_format: int,
                             mbw: int, mb0: int = 0, bidir: bool = True):
    """:func:`fused_mc_recon_blocks` for both chroma planes in one launch:
    ``ref0``/``ref1`` are (U, V) pairs at the chroma format's tile (8x8,
    16x8 or 16x16); returns the (U, V) pair."""
    return _blocks("fused_mc_recon_uv_blocks", True, ref0, ref1, dense, meta,
                   chroma_format, mbw, mb0, bidir)


# pictures a launch of the grouped blocks form takes at most
GROUP_MAX = _build.MC_GROUP_MAX


def blocks_planes(meta, *, chroma_format: int, mbw: int, device):
    """New (Y, U, V) uint8 planes of the size the blocks form writes for
    metadata rows of whole MB rows ``mbw`` MBs wide."""
    xs, ys, _ = CHROMA_INFO[chroma_format]
    H, W = meta.shape[0] // mbw * 16, mbw * 16
    return tuple(torch.empty(s, dtype=torch.uint8, device=device)
                 for s in ((H, W), (H >> ys, W >> xs), (H >> ys, W >> xs)))


def fused_mc_recon_blocks_group_ref(pictures, *, chroma_format: int,
                                    mbw: int, mb0: int = 0, out=None):
    """Plain PyTorch version of :func:`fused_mc_recon_blocks_group` on any
    device: :func:`fused_mc_recon_blocks_ref` and
    :func:`fused_mc_recon_uv_blocks_ref`, picture by picture, copied into
    ``out``'s planes where it is given."""
    planes = []
    for refs0, refs1, dense, meta, bidir in pictures:
        kw = dict(chroma_format=chroma_format, mbw=mbw, mb0=mb0,
                  bidir=bidir)
        y = fused_mc_recon_blocks_ref(refs0[0], refs1[0], dense, meta, **kw)
        planes.append((y, *fused_mc_recon_uv_blocks_ref(
            tuple(refs0[1:]), tuple(refs1[1:]), dense, meta, **kw)))
    if out is None:
        return planes
    for got, dst in zip(planes, out):
        for g, d in zip(got, dst):
            d.copy_(g)
    return out


def fused_mc_recon_blocks_group(pictures, *, chroma_format: int, mbw: int,
                                mb0: int = 0, out=None):
    """Reconstruct luma and U+V of a group of pictures in one launch (the
    grouped blocks form).  ``pictures``: 1 to :data:`GROUP_MAX` tuples
    ``(refs0, refs1, dense, meta, bidir)`` — the (Y, U, V) reference
    triples and the arguments of :func:`fused_mc_recon_blocks` — none of
    which reads another's output; each is checked as the one-picture
    wrappers check theirs, and all must share the planes' shapes, the
    rows' count and form (5 or 9 columns) and the device.  Returns a
    ``(y, u, v)`` tuple a picture, each equal to the one-picture forms':
    new planes, or ``out``'s where it is given (a triple a picture, each
    plane contiguous uint8 of the output's shape on the pictures' device).
    CPU tensors: the plain version; CUDA tensors: one launch of
    ``mp2v_mc_{recon,field}_blocks_group``, counted in ``_build.LAUNCHES``
    under that name less ``mp2v_``; any other device raises."""
    entry = "fused_mc_recon_blocks_group"
    pictures = list(pictures)
    if not 0 < len(pictures) <= GROUP_MAX:
        raise ValueError(f"{entry}: {len(pictures)} pictures; a launch "
                         f"takes 1 to {GROUP_MAX}")
    xs, ys, _ = CHROMA_INFO.get(chroma_format, (0, 0, 0))
    shapes = set()
    for refs0, refs1, dense, meta, _ in pictures:
        if len(refs0) != 3 or len(refs1) != 3:
            raise ValueError(f"{entry}: takes (Y, U, V) reference triples")
        shapes.add((
            _check_blocks(entry, refs0[:1], refs1[:1], dense, meta,
                          chroma_format, mbw, mb0, 16, 16),
            _check_blocks(entry, tuple(refs0[1:]), tuple(refs1[1:]), dense,
                          meta, chroma_format, mbw, mb0, 16 >> ys, 16 >> xs),
            tuple(meta.shape), dense.device))
    if len(shapes) > 1:
        raise ValueError(f"{entry}: the pictures of a group share their "
                         f"planes' shapes, their rows' count and form and "
                         f"their device")
    (H, W, Hr, Wr), (Hc, Wc, Hcr, Wcr), (n, cols), dev = shapes.pop()
    sizes = ((H, W), (Hc, Wc), (Hc, Wc))
    if out is not None and (len(out) != len(pictures) or any(
            len(o) != 3 or any(
                x.device != dev or x.dtype != torch.uint8
                or tuple(x.shape) != s or not x.is_contiguous()
                for x, s in zip(o, sizes)) for o in out)):
        raise ValueError(f"{entry}: out must hold a (Y, U, V) triple a "
                         f"picture of contiguous {sizes} uint8 planes on "
                         f"{dev}")
    if _device_type(entry, pictures[0][2]) == "cpu":
        return fused_mc_recon_blocks_group_ref(
            pictures, chroma_format=chroma_format, mbw=mbw, mb0=mb0, out=out)
    outs = out if out is not None else [
        blocks_planes(meta, chroma_format=chroma_format, mbw=mbw, device=dev)
        for _ in pictures]
    ptrs, bidirs = [], 0
    for k, ((refs0, refs1, dense, meta, bidir), planes) in enumerate(
            zip(pictures, outs)):
        ptrs += [x.data_ptr()
                 for x in (*refs0, *refs1, dense, meta, *planes)]
        bidirs |= int(bool(bidir)) << k
    name = f"mc_{'field' if cols == 9 else 'recon'}_blocks_group"
    rc = getattr(_build.kernel_library(), f"mp2v_{name}")(
        (ctypes.c_void_p * len(ptrs))(*ptrs), len(pictures), cols,
        chroma_format, n, mb0, mbw, Hr, Wr, Hcr, Wcr, bidirs,
        _build.stream_handle(dev))
    _build.check(f"mp2v_{name}", rc)
    _build.LAUNCHES[name] += 1
    return outs


def _frame_only(name, fld_f, fld_b):
    if fld_f is not None or fld_b is not None:
        raise ValueError(f"{name}: the roll kernels have no field form "
                         f"(the mxu and swar kernels have one)")


def fused_mc_recon_roll(ref0, ref1, res_plane, syf, sxf, phf, syb, sxb, phb,
                        mode, fld_f=None, fld_b=None, *, h: int = 16,
                        w: int = 16, bidir: bool = True):
    """K2's function, frame prediction, through kernel K5: (H, W) uint8.
    Its plain version is :func:`fused_mc_recon_ref`, which computes the
    same function.  Field tuples raise, as the JAX kernel asserts.  On the
    card the residual must be 16-byte aligned, as K2's."""
    _frame_only("fused_mc_recon_roll", fld_f, fld_b)
    if _device_type("fused_mc_recon_roll", res_plane) == "cpu":
        return fused_mc_recon_ref(ref0, ref1, res_plane, syf, sxf, phf, syb,
                                  sxb, phb, mode, h=h, w=w, bidir=bidir)
    return _launch("mp2v_mc_roll_luma", "mc_roll_luma", (ref0,), (ref1,),
                   (res_plane,), (syf, sxf, phf, syb, sxb, phb, mode), h, w,
                   bidir)[0]


def fused_mc_recon_uv_roll(ref0, ref1, res, syf, sxf, phf, syb, sxb, phb,
                           mode, fld_f=None, fld_b=None, *, h: int = 8,
                           w: int = 8, bidir: bool = True):
    """K3's function, frame prediction, through kernel K6: (U, V) pairs in
    and out, planar.  Its plain version is :func:`fused_mc_recon_uv_ref`.
    Field tuples raise.  On the card the residual planes must be 16-byte
    aligned, as K3's."""
    _frame_only("fused_mc_recon_uv_roll", fld_f, fld_b)
    if _device_type("fused_mc_recon_uv_roll", res[0]) == "cpu":
        return fused_mc_recon_uv_ref(ref0, ref1, res, syf, sxf, phf, syb,
                                     sxb, phb, mode, h=h, w=w, bidir=bidir)
    return _launch("mp2v_mc_roll_uv", "mc_roll_uv", tuple(ref0), tuple(ref1),
                   tuple(res), (syf, sxf, phf, syb, sxb, phb, mode), h, w,
                   bidir)


def fused_mc_pred_swar(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode, *,
                       h: int = 16, w: int = 16, bidir: bool = True,
                       H: int | None = None):
    """Packed frame prediction of one (Hr, Wr) component through kernel
    K7: (H, Wr // 4) int32 words (mode bits 1 and 2 only; the caller
    applies residual and coded mask).  ``H``, the output rows, defaults to
    Hr; fewer is a band of MB rows, whose vectors (one per MB of the band)
    hold window starts in the whole reference.  CPU tensors: the plain
    version."""
    if _device_type("fused_mc_pred_swar", ref0) == "cpu":
        return fused_mc_pred_swar_ref(ref0, ref1, syf, sxf, phf, syb, sxb,
                                      phb, mode, h=h, w=w, bidir=bidir, H=H)
    return _launch("mp2v_mc_swar", "mc_swar", (ref0,), (ref1,), (),
                   (syf, sxf, phf, syb, sxb, phb, mode), h, w, bidir, H)[0]


def fused_mc_pred_swar_yuv(ref0, ref1, meta_y, meta_c, mode, *, h: int = 8,
                           w: int = 8, bidir: bool = True,
                           H: int | None = None):
    """Packed frame prediction of one picture's three components in one
    launch of kernel K7.  ``ref0``/``ref1``: (Y, U, V) triples of reference
    planes, luma (Hr, Wr) in 16x16 tiles, U and V (Hr/16*h, Wr/16*w) in the
    (h x w) chroma tile; ``meta_y``/``meta_c``: the luma and the chroma
    (syf, sxf, phf, syb, sxb, phb), U and V sharing theirs; ``mode`` is
    shared by all three.  ``H``: the luma output rows, by default Hr; fewer
    is a band of MB rows (U and V then give that band's chroma rows).
    Returns the three (rows, columns // 4) int32 word planes.  CPU tensors:
    the plain version."""
    if _device_type("fused_mc_pred_swar_yuv", ref0[0]) == "cpu":
        return fused_mc_pred_swar_yuv_ref(ref0, ref1, meta_y, meta_c, mode,
                                          h=h, w=w, bidir=bidir, H=H)
    return _launch_yuv(tuple(ref0), tuple(ref1), tuple(meta_y),
                       tuple(meta_c), mode, h, w, bidir, H)


def fused_mc_pred_swar_field(ref0, ref1, syf, sxf, phf, syb, sxb, phb, mode,
                             fld_f, fld_b, *, h: int = 16, w: int = 16,
                             bidir: bool = True, H: int | None = None):
    """:func:`fused_mc_pred_swar` with field prediction on the MBs whose
    mode has bit 8, through kernel K8 (``H`` as there)."""
    if _device_type("fused_mc_pred_swar_field", ref0) == "cpu":
        return fused_mc_pred_swar_field_ref(ref0, ref1, syf, sxf, phf, syb,
                                            sxb, phb, mode, fld_f, fld_b,
                                            h=h, w=w, bidir=bidir, H=H)
    return _launch("mp2v_mc_swar_field", "mc_swar_field", (ref0,), (ref1,),
                   (), (syf, sxf, phf, syb, sxb, phb, mode, *fld_f, *fld_b),
                   h, w, bidir, H)[0]
