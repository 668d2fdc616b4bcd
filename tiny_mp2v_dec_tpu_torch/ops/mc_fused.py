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
takes the kernel; any other device raises.
"""
from __future__ import annotations

import ctypes

import torch

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


# ----------------------------------------------------------------------
# kernel wrappers

# C entry point -> the (h, w) tiles it is instantiated for
_TILES = {
    "mp2v_mc_recon_luma": {(16, 16)},
    "mp2v_mc_field_luma": {(16, 16)},
    "mp2v_mc_recon_uv": {(8, 8), (16, 8), (16, 16)},
    "mp2v_mc_field_uv": {(8, 8), (16, 8), (16, 16)},
}


def _launch(entry, counter, refs0, refs1, ress, meta, h, w, bidir):
    """Check the arguments of kernel ``entry`` and launch it on the
    current stream; returns the output planes."""
    if (h, w) not in _TILES[entry]:
        raise ValueError(f"{entry}: the kernel takes "
                         f"{sorted(_TILES[entry])} tiles, not {h}x{w}")
    dev = ress[0].device
    Hr, Wr = refs0[0].shape
    H, W = ress[0].shape
    if H % h or W % w:
        raise ValueError(f"{entry}: plane {H}x{W} is not a whole number of "
                         f"{h}x{w} tiles")
    n_mb = (H // h) * (W // w)
    for x in (*refs0, *refs1):
        if (x.device != dev or x.dtype != torch.uint8
                or tuple(x.shape) != (Hr, Wr) or not x.is_contiguous()):
            raise ValueError(f"{entry}: reference planes must be contiguous "
                             f"({Hr}, {Wr}) uint8 on {dev}")
    if Hr < H or Wr < W:
        raise ValueError(f"{entry}: reference {Hr}x{Wr} smaller than the "
                         f"output {H}x{W}")
    for x in ress:
        if (x.device != dev or x.dtype != torch.int16
                or tuple(x.shape) != (H, W) or not x.is_contiguous()):
            raise ValueError(f"{entry}: residual planes must be contiguous "
                             f"({H}, {W}) int16 on {dev}")
    for x in meta:
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != (n_mb,) or not x.is_contiguous()):
            raise ValueError(f"{entry}: per-MB vectors must be contiguous "
                             f"({n_mb},) int32 on {dev}")
    outs = tuple(torch.empty((H, W), dtype=torch.uint8, device=dev)
                 for _ in ress)
    pair = lambda xs: (xs[0].data_ptr(), xs[-1].data_ptr())  # noqa: E731
    ptrs = [*pair(refs0), *pair(refs1), *pair(ress), *pair(outs),
            *(x.data_ptr() for x in meta)]
    ptrs += [0] * (_build.MC_PTRS - len(ptrs))
    lib = _build.kernel_library()
    rc = getattr(lib, entry)((ctypes.c_void_p * _build.MC_PTRS)(*ptrs), h,
                             w, n_mb, W // w, Hr, Wr, int(bidir),
                             _build.stream_handle(dev))
    _build.check(entry, rc)
    _build.LAUNCHES[counter] += 1
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
