"""Unidirectional half-pel prediction of a whole luma plane: the two Pallas
formulations of the JAX package's MC profiling script, K9 and K10.

Counterparts of ``tools/profile_mc_variants.py`` there:

* :func:`mc_row_pred` — kernel K9 (``csrc/mc_rows.cu``, replaces
  ``variant_c`` / ``_mc_row_kernel``): the zero-padded ``(Hp, Wp)`` uint8
  plane in, the ``(H, W)`` uint8 prediction out;
* :func:`mc_row_pred_packed` — kernel K10 (replaces ``variant_d`` /
  ``_mc_row_kernel_packed``): the same pixels on 4-pixel words, the
  ``(Hp, Wq)`` int32 word plane in (pixel x at byte x % 4 of word x // 4,
  least significant first: a numpy ``uint32`` view of the padded bytes,
  handed over as ``int32``), the ``(H, W // 4)`` int32 words out.

Per MB ``i`` of the ``(H/16) * (W/16)`` in raster order they take the
start ``(sy[i], sx[i])`` (K10: ``sxq = sx >> 2``, ``rb = sx & 3``), clamped
to ``[0, H-16] x [0, W-16]``, and the phase ``ph[i]`` (bit 0 horizontal,
bit 1 vertical); the +1 taps of a window at the bottom or right edge read
the plane's zero padding, so ``Hp > H``, ``Wp > W`` and ``Wq > W / 4``.
The JAX script fixed H and W at 1080p; here they are arguments.

Both compute MPEG-2's exact half-pel prediction, equal to the script's
``variant_a``.  The JAX K10 does not where ``rb != 0``: it fills the top
``rb`` bytes of a word whose top pixel is >= 128 with ones (an arithmetic
shift, ``profile_mc_variants.py:190``); ``tests/test_torch_mc_rows.py``
pins that divergence.

Both kernels (one template of ``csrc/mc_rows.cu``, a warp per MB) read the
plane as 16-byte quads: its pointer must be 16-byte aligned and its rows a
multiple of 16 bytes (``Wp % 16 == 0``, ``Wq % 4 == 0``), as the script's
padding makes them; other planes are refused on every device.  A CPU
tensor takes the plain version (``*_ref``); a CUDA tensor launches the
kernel; any other device raises.  The plain K9 gathers bytes
(:mod:`.mc`), the plain K10 funnel-shifts int64 words (:mod:`.mc_fused`),
so the two check each other.
"""
from __future__ import annotations

import torch

from . import _build
from .mc import gather_windows, halfpel_select
from .mc_fused import _swar_pred, words_to_int32


def _starts(sy, sx, H: int, W: int):
    """int64 window starts clamped to [0, H-16] x [0, W-16]."""
    return (torch.clamp(sy.to(torch.int64), 0, H - 16),
            torch.clamp(sx.to(torch.int64), 0, W - 16))


def plane_of_tiles(tiles, H: int, W: int):
    """(n, 16, c) tiles in raster MB order -> (H, W/16 * c) plane."""
    c = tiles.shape[-1]
    return tiles.reshape(H // 16, W // 16, 16, c).permute(0, 2, 1, 3).reshape(
        H, W // 16 * c)


def mc_row_pred_ref(plane_pad, sy, sx, ph, *, H: int, W: int):
    """Plain PyTorch version of K9 on any device: (H, W) uint8, by the byte
    gather of :func:`.mc.gather_windows` + :func:`.mc.halfpel_select`."""
    sy, sx = _starts(sy, sx, H, W)
    ph = ph.to(torch.int64)
    win = gather_windows(plane_pad, sy, sx, 16, 16)
    return plane_of_tiles(halfpel_select(win, ph & 1, (ph >> 1) & 1, 16, 16),
                          H, W)


def mc_row_pred_packed_ref(plane32, sy, sxq, rb, ph, *, H: int, W: int):
    """Plain PyTorch version of K10 on any device: (H, W // 4) int32 words,
    funnel shifts and per-byte averages on int64 words holding the
    unsigned values (PyTorch's CPU shifts have no ``torch.uint32``)."""
    words = plane32.to(torch.int64) & 0xFFFFFFFF
    sy, sx = _starts(sy, sxq.to(torch.int64) * 4 + rb.to(torch.int64), H, W)
    j = torch.arange(16, device=plane32.device)
    per_row = lambda x: x[:, None].expand(-1, 16)  # noqa: E731
    pred = _swar_pred(words, sy[:, None] + j, per_row(sx),
                      per_row(ph.to(torch.int64)), 1, 4)
    return words_to_int32(plane_of_tiles(pred, H, W))


def _takes_kernel(name, plane, dtype, width, vectors, H, W) -> bool:
    """Whether the kernel runs (CUDA tensors) rather than the plain version
    (CPU tensors), after refusing what the kernel does not take, on every
    device: a plane that is not a contiguous 2-D ``dtype`` tensor of more
    than ``H`` rows and ``width`` columns, a plane the kernels cannot read
    as 16-byte quads (not 16-byte aligned, or rows that are not a multiple
    of 16 bytes), a geometry that is not whole MBs, per-MB vectors that are
    not contiguous (n_mb,) int32 on the plane's device, or any other
    device."""
    if H < 16 or W < 16 or H % 16 or W % 16:
        raise ValueError(f"{name}: H={H}, W={W} is not a whole number of "
                         f"16x16 MBs")
    if (plane.dtype != dtype or plane.dim() != 2 or not plane.is_contiguous()
            or plane.shape[0] <= H or plane.shape[1] <= width):
        raise ValueError(f"{name}: the plane must be a contiguous 2-D {dtype}"
                         f" tensor of more than {H} x {width}, with the zero "
                         f"padding the +1 taps read; got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    if plane.shape[1] * plane.element_size() % 16 or plane.data_ptr() % 16:
        raise ValueError(f"{name}: the plane must be 16-byte aligned with "
                         f"rows of a multiple of 16 bytes; got "
                         f"{tuple(plane.shape)} {plane.dtype}")
    n_mb = (H // 16) * (W // 16)
    for x in vectors:
        if (x.device != plane.device or x.dtype != torch.int32
                or tuple(x.shape) != (n_mb,) or not x.is_contiguous()):
            raise ValueError(f"{name}: per-MB vectors must be contiguous "
                             f"({n_mb},) int32 on {plane.device}")
    if plane.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {plane.device}")
    return plane.device.type == "cuda"


def mc_row_pred(plane_pad, sy, sx, ph, *, H: int, W: int):
    """Half-pel prediction of every MB of an (H, W) plane: (H, W) uint8.
    CPU tensors: the plain version; CUDA tensors: kernel K9."""
    if not _takes_kernel("mc_row_pred", plane_pad, torch.uint8, W,
                         (sy, sx, ph), H, W):
        return mc_row_pred_ref(plane_pad, sy, sx, ph, H=H, W=W)
    out = torch.empty((H, W), dtype=torch.uint8, device=plane_pad.device)
    rc = _build.kernel_library().mp2v_mc_row(
        plane_pad.data_ptr(), plane_pad.shape[0], plane_pad.shape[1],
        sy.data_ptr(), sx.data_ptr(), ph.data_ptr(), out.data_ptr(), H, W,
        _build.stream_handle(plane_pad.device))
    _build.check("mp2v_mc_row", rc)
    _build.LAUNCHES["mc_row"] += 1
    return out


def mc_row_pred_packed(plane32, sy, sxq, rb, ph, *, H: int, W: int):
    """:func:`mc_row_pred`'s pixels as (H, W // 4) int32 words, from the
    int32 word plane.  CPU tensors: the plain version; CUDA tensors: kernel
    K10."""
    if not _takes_kernel("mc_row_pred_packed", plane32, torch.int32,
                         W // 4, (sy, sxq, rb, ph), H, W):
        return mc_row_pred_packed_ref(plane32, sy, sxq, rb, ph, H=H, W=W)
    out = torch.empty((H, W // 4), dtype=torch.int32, device=plane32.device)
    rc = _build.kernel_library().mp2v_mc_row_packed(
        plane32.data_ptr(), plane32.shape[0], plane32.shape[1],
        sy.data_ptr(), sxq.data_ptr(), rb.data_ptr(), ph.data_ptr(),
        out.data_ptr(), H, W, _build.stream_handle(plane32.device))
    _build.check("mp2v_mc_row_packed", rc)
    _build.LAUNCHES["mc_row_packed"] += 1
    return out
