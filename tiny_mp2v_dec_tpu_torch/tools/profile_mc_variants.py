"""Formulations of 1080p luma unidirectional half-pel MC on a CUDA card.

    python -m tiny_mp2v_dec_tpu_torch.tools.profile_mc_variants

Counterpart of the JAX package's ``tools/profile_mc_variants.py``, its
``main`` and ``main_packed`` in one run, on the same inputs
(:func:`make_inputs`: ``default_rng(0)``, a random plane, in-frame random
half-pel MVs for each of the 8160 MBs, the script's padding formulas):

a) ``ops/mc.mc_unidir_tiles`` on ``pad_for_mc``: batched window gather +
   phase select;
b) a per-pixel gather from the four half-pel phase planes (b': building
   the planes alone);
c) kernel K9, ``ops/mc_rows.mc_row_pred``;
d) kernel K10, ``ops/mc_rows.mc_row_pred_packed``.

a and b are plain PyTorch (XLA formulations in the JAX script).  b, c and d
are checked against a, exactly (:func:`parity`); then every variant's
device time per call is printed (``tbench.report``) and, last, one JSON
record.  Exits 2 without a CUDA device, 1 when a variant differs from a.
"""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.mc import mc_unidir_tiles, pad_for_mc
from ..ops.mc_fused import unpack_words
from ..ops.mc_rows import mc_row_pred, mc_row_pred_packed, plane_of_tiles

H, W = 1088, 1920


def make_inputs(H: int = H, W: int = W, seed: int = 0, device="cuda"):
    """Every variant's inputs, drawn as the JAX script draws them.  The
    per-MB vectors are int32 (MVs int16); ``plane_pad`` is the (hp, wp)
    zero-padded uint8 plane of K9 and ``plane32`` the (hp, wq) int32 word
    plane of K10 (a byte view of the plane padded to wq * 4 columns)."""
    rng = np.random.default_rng(seed)
    mbw = W // 16
    n = (H // 16) * mbw
    plane = rng.integers(0, 256, (H, W)).astype(np.uint8)
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos_y, pos_x = mb_y * 16, mb_x * 16
    mvx = rng.integers(-2 * pos_x, 2 * (W - 16 - pos_x) + 1).astype(np.int16)
    mvy = rng.integers(-2 * pos_y, 2 * (H - 16 - pos_y) + 1).astype(np.int16)
    ph = (mvx & 1) + 2 * (mvy & 1)
    sy = np.clip(pos_y + (mvy.astype(np.int32) >> 1), 0, H - 16)
    sx = np.clip(pos_x + (mvx.astype(np.int32) >> 1), 0, W - 16)
    # the script's padding: room for its aligned (32, 256)-element loads
    hp = ((H - 16 + 32 + 31) // 32) * 32
    wp = ((W - 16) // 128) * 128 + 256
    wq = (((W - 16) >> 2) // 128) * 128 + 256
    plane_pad = np.zeros((hp, wp), np.uint8)
    plane_pad[:H, :W] = plane
    p8 = np.zeros((hp, wq * 4), np.uint8)
    p8[:H, :W] = plane
    ys, xs = np.divmod(np.arange(H * W), W)
    t = lambda a, dt=None: torch.as_tensor(  # noqa: E731
        a if dt is None else a.astype(dt), device=device)
    x = SimpleNamespace(
        H=H, W=W, plane=t(plane), pos_y=t(pos_y, np.int32),
        pos_x=t(pos_x, np.int32), mvx=t(mvx), mvy=t(mvy),
        sy=t(sy, np.int32), sx=t(sx, np.int32), ph=t(ph, np.int32),
        sxq=t(sx >> 2, np.int32), rb=t(sx & 3, np.int32),
        plane_pad=t(plane_pad), plane32=t(p8.view(np.int32)),
        mb_of_pixel=t((ys // 16) * mbw + xs // 16, np.int64),
        ny=t(ys, np.int64), nx=t(xs, np.int64))
    x.padded = pad_for_mc(x.plane)
    return x


# the starts row_case draws
ROW_STARTS = ("profiler", "edges", "sx_phases")


def row_case(x, starts: str = "profiler", tight: bool = False):
    """A copy of :func:`make_inputs`' ``x`` with other starts, on which K9
    and K10 are held to their plain versions: the script's (``profiler``);
    every MB's window at the bottom edge, the right edge or both (the +1
    taps in the zero padding) at every phase (``edges``); or every
    ``sx & 3`` at every phase (``sx_phases``: 16 pairs, or one per MB on
    fewer MBs).  The MVs follow the starts, so :func:`variant_a` reads the
    same windows.  With ``tight``, the picture on the least padding the
    kernels take: (H + 1, W + 16) bytes, the same bytes as (H + 1, W/4 + 4)
    words."""
    v = SimpleNamespace(**vars(x))
    i = torch.arange(x.sy.numel(), device=x.sy.device, dtype=torch.int32)
    if starts == "edges":
        v.sy = torch.where(i % 3 != 1, x.H - 16, x.sy)
        v.sx = torch.where(i % 3 != 0, x.W - 16, x.sx)
        v.ph = (i // 3) % 4
    elif starts == "sx_phases":
        v.sx = torch.clamp(x.sx & ~3, max=x.W - 20) + i % 4
        v.ph = (i // 4) % 4
    elif starts != "profiler":
        raise ValueError(f"row_case: no starts {starts!r}")
    v.sxq, v.rb = v.sx >> 2, v.sx & 3
    v.mvx = (2 * (v.sx - x.pos_x) + (v.ph & 1)).to(torch.int16)
    v.mvy = (2 * (v.sy - x.pos_y) + (v.ph >> 1)).to(torch.int16)
    if tight:
        v.plane_pad = torch.zeros((x.H + 1, x.W + 16),
                                  dtype=torch.uint8, device=x.plane.device)
        v.plane_pad[:x.H, :x.W] = x.plane
        v.plane32 = v.plane_pad.view(torch.int32)
    return v


def make_phase_planes(padded):
    """The four half-pel filtered planes of the padded plane: (4, H+1,
    W+1) uint8, phase 0 a, 1 ab, 2 ac, 3 abcd (the taps past the last row
    and column wrap around, as the script's rolls do; in-frame MVs never
    read them)."""
    a = padded.to(torch.int32)
    b = torch.roll(a, -1, 1)
    c = torch.roll(a, -1, 0)
    d = torch.roll(b, -1, 0)
    ab = (a + b + 1) >> 1
    ac = (a + c + 1) >> 1
    abcd = (ab + ((c + d + 1) >> 1) + 1) >> 1
    return torch.stack([a, ab, ac, abcd]).to(torch.uint8)


def variant_a(x):
    return mc_unidir_tiles(x.padded, x.pos_y, x.pos_x, x.mvx, x.mvy, 16, 16)


def variant_b(x, phases):
    """Per-pixel gather: (H * W,) uint8, pixel p of MB m at phase plane
    ph[m], row ny + mvy[m] >> 1, column nx + mvx[m] >> 1."""
    mvx = x.mvx.to(torch.int64)[x.mb_of_pixel]
    mvy = x.mvy.to(torch.int64)[x.mb_of_pixel]
    return phases[(mvx & 1) + 2 * (mvy & 1), x.ny + (mvy >> 1),
                  x.nx + (mvx >> 1)]


def variant_c(x):
    return mc_row_pred(x.plane_pad, x.sy, x.sx, x.ph, H=x.H, W=x.W)


def variant_d(x):
    return mc_row_pred_packed(x.plane32, x.sy, x.sxq, x.rb, x.ph, H=x.H,
                              W=x.W)


def parity(x) -> dict:
    """Run every variant once, untimed: whether b, c and d equal a."""
    ref = plane_of_tiles(variant_a(x), x.H, x.W)
    got = {"b": variant_b(x, make_phase_planes(x.padded)).reshape(x.H, x.W),
           "c": variant_c(x), "d": unpack_words(variant_d(x))}
    return {k: bool(torch.equal(v, ref)) for k, v in got.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_mc_variants: torch finds no CUDA device — skipped",
              file=sys.stderr)
        return 2
    from .tbench import card, report
    rec = {"card": card(), "device": torch.cuda.get_device_name(0)}
    print(rec["card"])
    x = make_inputs(device="cuda")
    rec["parity"] = parity(x)
    print("parity vs variant a:", rec["parity"])
    phases = make_phase_planes(x.padded)
    rec["ms"] = {
        "a": report("a) batched window gather (mc_unidir_tiles)",
                    lambda: variant_a(x)),
        "b": report("b) per-pixel gather (4 phase planes)",
                    lambda: variant_b(x, phases)),
        "b'": report("b') phase-plane build alone",
                     lambda: make_phase_planes(x.padded)),
        "c": report("c) K9 mc_row_pred (CUDA)", lambda: variant_c(x)),
        "d": report("d) K10 mc_row_pred_packed (CUDA)", lambda: variant_d(x)),
    }
    print(json.dumps(rec))
    return 0 if all(rec["parity"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
