"""Fused motion compensation + residual add + saturation, per plane.

Counterpart of ``tiny_mp2v_dec_tpu/ops/mc_pallas.py`` for frame prediction:

* :func:`fused_mc_recon` — one luma plane; CUDA kernel K2
  (``csrc/mc_recon.cu``, replaces ``fused_mc_recon_mxu``);
* :func:`fused_mc_recon_uv` — both chroma planes in one pass, sharing each
  MB's window start, phase and mode; CUDA kernel K3 (replaces
  ``fused_mc_recon_uv_mxu``).  U and V stay planar: the JAX package's column
  interleave was a Mosaic workaround.

Both take the JAX kernels' per-MB int32 vectors (clamped window starts
``sy``/``sx`` and phase ``ph`` per direction from :func:`mc_meta`, and
``mode`` bits 1 = forward, 2 = backward, 4 = coded) and ``bidir``
(``False`` is the forward-only form, which ignores mode bit 2).  Reference
planes are unpadded ``(Hr, Wr)`` uint8; taps beyond them read 0.  A CPU
tensor takes the plain version (``*_ref``), built from :mod:`.mc`; a CUDA
tensor takes the kernel; any other device raises.
"""
from __future__ import annotations

import torch

from . import _build
from .mc import gather_windows, halfpel_select, mc_bidir_tiles, pad_for_mc


def mc_meta(pos_y, pos_x, mvx, mvy, H: int, W: int, h: int, w: int):
    """Per-MB window start + phase from half-pel MVs (clamp identical to
    :func:`.mc.gather_windows`: [0, H-h] x [0, W-w])."""
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    sy = torch.clamp(pos_y + (mvy >> 1), 0, H - h).to(torch.int32)
    sx = torch.clamp(pos_x + (mvx >> 1), 0, W - w).to(torch.int32)
    ph = ((mvx & 1) + 2 * (mvy & 1)).to(torch.int32)
    return sy, sx, ph


# ----------------------------------------------------------------------
# plain versions


def _pred(ref, sy, sx, ph, h, w):
    win = gather_windows(pad_for_mc(ref), sy, sx, h, w)
    return halfpel_select(win, ph & 1, (ph >> 1) & 1, h, w)


def fused_mc_recon_ref(ref0, ref1, res_plane, syf, sxf, phf, syb, sxb, phb,
                       mode, *, h: int, w: int, bidir: bool = True):
    """Plain PyTorch version of K2 on any device: (H, W) uint8."""
    H, W = res_plane.shape
    mbh, mbw = H // h, W // w
    f = ((mode & 1) != 0)[:, None, None]
    pf = _pred(ref0, syf, sxf, phf, h, w)
    zero = torch.zeros((), dtype=torch.uint8, device=pf.device)
    if bidir:
        b = ((mode & 2) != 0)[:, None, None]
        pb = _pred(ref1, syb, sxb, phb, h, w)
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
                          mode, *, h: int, w: int, bidir: bool = True):
    """Plain PyTorch version of K3 on any device.  ``ref0``/``ref1``/``res``
    are (U, V) pairs; returns the (U, V) pair of (H, W) uint8 planes."""
    return tuple(
        fused_mc_recon_ref(ref0[k], ref1[k], res[k], syf, sxf, phf, syb,
                           sxb, phb, mode, h=h, w=w, bidir=bidir)
        for k in range(2))


# ----------------------------------------------------------------------
# kernel wrappers

_TILE = {"mp2v_mc_recon_luma": 16, "mp2v_mc_recon_uv": 8}


def _launch(entry, counter, refs0, refs1, ress, meta, h, w, bidir):
    """Check the arguments of kernel ``entry`` and launch it on the
    current stream; returns the output planes."""
    t = _TILE[entry]
    if (h, w) != (t, t):
        raise ValueError(f"{entry}: the kernel takes {t}x{t} tiles, "
                         f"not {h}x{w}")
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
    lib = _build.kernel_library()
    rc = getattr(lib, entry)(
        *pair(refs0), *pair(refs1), *pair(ress), *pair(outs),
        *(x.data_ptr() for x in meta), n_mb, W // w, Hr, Wr, int(bidir),
        _build.stream_handle(dev))
    _build.check(entry, rc)
    _build.LAUNCHES[counter] += 1
    return outs


def _device_type(entry, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{entry}: no kernel for device {x.device}")
    return x.device.type


def fused_mc_recon(ref0, ref1, res_plane, syf, sxf, phf, syb, sxb, phb, mode,
                   *, h: int = 16, w: int = 16, bidir: bool = True):
    """Reconstruct one (H, W) luma plane: (H, W) uint8.  CPU tensor: the
    plain version; CUDA tensor: kernel K2."""
    if _device_type("fused_mc_recon", res_plane) == "cpu":
        return fused_mc_recon_ref(ref0, ref1, res_plane, syf, sxf, phf, syb,
                                  sxb, phb, mode, h=h, w=w, bidir=bidir)
    return _launch("mp2v_mc_recon_luma", "mc_recon_luma", (ref0,), (ref1,),
                   (res_plane,), (syf, sxf, phf, syb, sxb, phb, mode),
                   h, w, bidir)[0]


def fused_mc_recon_uv(ref0, ref1, res, syf, sxf, phf, syb, sxb, phb, mode,
                      *, h: int = 8, w: int = 8, bidir: bool = True):
    """Reconstruct both chroma planes: ``ref0``/``ref1``/``res`` are (U, V)
    pairs, returns the (U, V) pair.  CPU tensors: the plain version; CUDA
    tensors: kernel K3."""
    if _device_type("fused_mc_recon_uv", res[0]) == "cpu":
        return fused_mc_recon_uv_ref(ref0, ref1, res, syf, sxf, phf, syb,
                                     sxb, phb, mode, h=h, w=w, bidir=bidir)
    return _launch("mp2v_mc_recon_uv", "mc_recon_uv", tuple(ref0),
                   tuple(ref1), tuple(res),
                   (syf, sxf, phf, syb, sxb, phb, mode), h, w, bidir)
