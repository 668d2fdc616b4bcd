"""Motion compensation as batched window gathers + phase select (plain
PyTorch, frame and field prediction).

Counterpart of ``tiny_mp2v_dec_tpu/ops/mc.py``.  Every MB gathers an
(h+1, w+1) window of the zero-padded reference plane (or of one of its two
zero-padded field views), all four half-pel variants are computed
vectorized, and the 2-bit phase selects.  Arithmetic is MPEG-2 exact:
``(a+b+1)>>1`` per stage, in int32 so that uint8 never overflows.  These
are the building blocks of the plain versions of the fused kernels
(:mod:`.mc_fused`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_for_mc(plane: torch.Tensor) -> torch.Tensor:
    """Zero-pad one row/col at bottom/right (matches golden.mc.pad_for_mc)."""
    return F.pad(plane, (0, 1, 0, 1))


def gather_windows(padded: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """(n,) start rows/cols -> (n, h+1, w+1) windows of ``padded``.

    Starts are clamped into the plane explicitly: a negative index would
    otherwise wrap around from the end, which is not the golden
    clamp-to-origin semantics."""
    sy = torch.clamp(sy.to(torch.int64), 0, padded.shape[0] - (h + 1))
    sx = torch.clamp(sx.to(torch.int64), 0, padded.shape[1] - (w + 1))
    rows = sy[:, None] + torch.arange(h + 1, device=padded.device)
    cols = sx[:, None] + torch.arange(w + 1, device=padded.device)
    return padded[rows[:, :, None], cols[:, None, :]]


def halfpel_select(win: torch.Tensor, hx: torch.Tensor, hy: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """win: (n, h+1, w+1) uint8; hx/hy: (n,) {0,1} phase bits ->
    (n, h, w) uint8."""
    win = win.to(torch.int32)
    a = win[:, :h, :w]
    b = win[:, :h, 1:w + 1]
    c = win[:, 1:h + 1, :w]
    d = win[:, 1:h + 1, 1:w + 1]
    ab = (a + b + 1) >> 1
    ac = (a + c + 1) >> 1
    abcd = (ab + ((c + d + 1) >> 1) + 1) >> 1
    hx = hx.to(torch.bool)[:, None, None]
    hy = hy.to(torch.bool)[:, None, None]
    out = torch.where(hx & hy, abcd,
                      torch.where(hx, ab, torch.where(hy, ac, a)))
    return out.to(torch.uint8)


def mc_unidir_tiles(padded: torch.Tensor, pos_y: torch.Tensor,
                    pos_x: torch.Tensor, mvx: torch.Tensor, mvy: torch.Tensor,
                    h: int, w: int) -> torch.Tensor:
    """Batched unidirectional prediction: (n,) positions + half-pel MVs ->
    (n, h, w) uint8 tiles."""
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    win = gather_windows(padded, pos_y + (mvy >> 1), pos_x + (mvx >> 1), h, w)
    return halfpel_select(win, mvx & 1, mvy & 1, h, w)


def mc_bidir_tiles(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Bidirectional average with MPEG-2 rounding, widened before the add."""
    return ((p0.to(torch.int32) + p1.to(torch.int32) + 1) >> 1).to(
        torch.uint8)


def field_views(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) plane -> (2, H/2+1, W+1): its top and bottom fields, each
    zero-padded like :func:`pad_for_mc` (the JAX package's XLA path stacks
    the same views, ``ops/recon.py`` there)."""
    return torch.stack([pad_for_mc(plane[0::2]), pad_for_mc(plane[1::2])])


def gather_windows_fields(fields: torch.Tensor, sel: torch.Tensor,
                          sy: torch.Tensor, sx: torch.Tensor,
                          h: int, w: int) -> torch.Tensor:
    """fields: (2, Hf+1, Wf+1) stacked padded field views; sel: (n,) {0,1}
    motion_vertical_field_select -> (n, h+1, w+1) windows, starts clamped
    into the field view as :func:`gather_windows` clamps them."""
    sy = torch.clamp(sy.to(torch.int64), 0, fields.shape[1] - (h + 1))
    sx = torch.clamp(sx.to(torch.int64), 0, fields.shape[2] - (w + 1))
    rows = sy[:, None] + torch.arange(h + 1, device=fields.device)
    cols = sx[:, None] + torch.arange(w + 1, device=fields.device)
    return fields[sel.to(torch.int64)[:, None, None], rows[:, :, None],
                  cols[:, None, :]]


def mc_field_tiles(fields: torch.Tensor, sel: torch.Tensor,
                   pos_y: torch.Tensor, pos_x: torch.Tensor,
                   mvx: torch.Tensor, mvy: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """Field-based prediction in a frame picture: positions in field
    coordinates -> (n, h, w) uint8 tiles of one prediction unit."""
    mvx = mvx.to(torch.int32)
    mvy = mvy.to(torch.int32)
    win = gather_windows_fields(fields, sel, pos_y + (mvy >> 1),
                                pos_x + (mvx >> 1), h, w)
    return halfpel_select(win, mvx & 1, mvy & 1, h, w)
