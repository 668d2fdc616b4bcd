"""PyTorch port, the byte count behind ``chip_smoke.py``'s MC bounds.

``chip_smoke.mc_read_bytes`` counts the input bytes a bidir call of an MC
kernel needs at the run's inputs: the mode vector, the residual of coded
MBs, and per direction the vectors and reference windows of the MBs whose
mode uses it.  Here it equals a count made pixel by pixel, the way the
kernels walk a tile (every tap of every output pixel, frame or field
unit), on ``chip_smoke.mc_inputs`` at a small size, and a hand count on
one MB.  ``chip_smoke.swar_yuv_read_bytes``, the count of K7's picture form
(three components, one mode vector), equals the three components' pixel
walks with the mode counted once.  ``chip_smoke.window_bytes``, K9's and
K10's count through the same union, equals its pixel walk too."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_meta  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _by_pixel(meta, H, W, th, tw, n_planes, field, recon):
    """The bytes of :func:`chip_smoke.mc_read_bytes`, from the taps each
    output pixel reads."""
    m = [np.asarray(x) if not isinstance(x, tuple)
         else [np.asarray(y) for y in x] for x in meta]
    mode = m[6]
    n = mode.size
    nbytes = 4 * n
    for d in range(2):
        sy, sx, ph = m[3 * d:3 * d + 3]
        taps = set()
        for i in range(n):
            if recon and not mode[i] & 4 or not mode[i] & (1 << d):
                continue
            by_field = field and mode[i] & 8
            nbytes += 4 * (6 if by_field else 3)
            for ty in range(th):
                if by_field:
                    u = ty & 1
                    c, x0, p = (int(v[i]) for v in m[7 + d][3 * u:3 * u + 3])
                    y0, vs = c + ty, 2
                else:
                    y0, x0, p, vs = int(sy[i]) + ty, int(sx[i]), int(ph[i]), 1
                for tx in range(tw):
                    for dy in (0, vs) if p & 2 else (0,):
                        for dx in (0, 1) if p & 1 else (0,):
                            y, x = y0 + dy, x0 + tx + dx
                            if y < H and x < W:
                                taps.add((y, x))
        nbytes += n_planes * len(taps)
    if recon:
        coded = sum(1 for v in mode if v & 4)
        nbytes += n_planes * 2 * th * tw * coded
    return nbytes


@pytest.mark.parametrize("field", [False, True], ids=["frame", "field"])
@pytest.mark.parametrize("recon", [True, False], ids=["recon", "swar"])
@pytest.mark.parametrize("tile,n_planes", [((16, 16), 1), ((8, 8), 2),
                                           ((16, 8), 2)],
                         ids=["16x16", "8x8", "16x8"])
def test_mc_read_bytes_equals_pixel_walk(tile, n_planes, recon, field):
    smoke = _smoke()
    th, tw = tile
    H, W = 3 * th, 4 * tw
    rng = np.random.default_rng(7)
    _, _, meta = smoke.mc_inputs(torch, np, rng, H, W, th, tw, field,
                                 device="cpu")
    got = smoke.mc_read_bytes(torch, meta, H, W, th, tw, n_planes, field,
                              recon)
    assert got == _by_pixel(meta, H, W, th, tw, n_planes, field, recon)


@pytest.mark.parametrize("tile", [(8, 8), (16, 8), (16, 16)],
                         ids=["4:2:0", "4:2:2", "4:4:4"])
def test_swar_yuv_read_bytes_equals_pixel_walk(tile):
    """K7's picture form: luma 16x16 with its vectors, U and V at the
    chroma tile sharing theirs, the mode vector read once for all three."""
    smoke = _smoke()
    th, tw = tile
    mbh, mbw = 3, 4
    rng = np.random.default_rng(9)
    _, _, meta_y = smoke.mc_inputs(torch, np, rng, mbh * 16, mbw * 16, 16,
                                   16, False, device="cpu")
    _, _, meta_c = smoke.mc_inputs(torch, np, rng, mbh * th, mbw * tw, th,
                                   tw, False, device="cpu")
    meta_c = [*meta_c[:6], meta_y[6]]
    got = smoke.swar_yuv_read_bytes(torch, meta_y, meta_c, mbh * th,
                                    mbw * tw, th, tw)
    assert got == (
        _by_pixel(meta_y, mbh * 16, mbw * 16, 16, 16, 1, False, False)
        + _by_pixel(meta_c, mbh * th, mbw * tw, th, tw, 2, False, False)
        - 4 * mbh * mbw)


def test_mc_read_bytes_one_mb():
    """One 16x16 MB, coded and forward (mode 5), window at (0, 0) with both
    half-pel phases: its 17th row and column are the zero pad, so the
    window is 256 bytes; the mode (4), the forward vectors (12) and the
    residual (512) make 784.  The backward direction is unused."""
    smoke = _smoke()
    zero = torch.zeros(1, dtype=torch.int32)
    sy, sx, ph = mc_meta(zero, zero, zero + 1, zero + 1, 16, 16, 16, 16)
    meta = [sy, sx, ph, sy, sx, ph, torch.tensor([5], dtype=torch.int32)]
    assert int(ph) == 3
    assert smoke.mc_read_bytes(torch, meta, 16, 16, 16, 16, 1, False,
                               True) == 784
    # not coded: the recon kernels need the mode alone, the SWAR ones
    # still the window and the vectors
    meta[6] = torch.tensor([1], dtype=torch.int32)
    assert smoke.mc_read_bytes(torch, meta, 16, 16, 16, 16, 1, False,
                               True) == 4
    assert smoke.mc_read_bytes(torch, meta, 16, 16, 16, 16, 1, False,
                               False) == 4 + 12 + 256


@pytest.mark.parametrize("word", [1, 4])
def test_window_bytes_equals_pixel_walk(word):
    """K9's and K10's count (``chip_smoke.window_bytes``): the union of the
    16x16 windows at starts clamped into an (H, W) plane, plus the row and
    column a half-pel phase adds in the padding, in ``word``-byte units."""
    smoke = _smoke()
    H, W = 48, 64
    rng = np.random.default_rng(11)
    sy, sx = rng.integers(-8, H + 8, 20), rng.integers(-8, W + 8, 20)
    ph = rng.integers(0, 4, 20)
    units = set()
    for y0, x0, p in zip(np.clip(sy, 0, H - 16), np.clip(sx, 0, W - 16), ph):
        for y in range(y0, y0 + 16 + (p >> 1)):
            for x in range(x0, x0 + 16 + (p & 1)):
                units.add((y, x // word))
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    assert smoke.window_bytes(torch, t(sy), t(sx), t(ph), H, W,
                              word) == word * len(units)
