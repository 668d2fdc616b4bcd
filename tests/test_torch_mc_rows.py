"""PyTorch port, K9/K10 (``ops/mc_rows.py``): the plain versions against
the JAX MC profiling script (``tools/profile_mc_variants.py``) — its
``variant_a`` at 1080p, and its two Pallas kernel bodies in interpret mode
at 8 x 3 MBs with the script's geometry globals patched — the edge starts
at every phase, the JAX K10's sign-fill fault, the kernels' warp scheme
modelled lane by lane on both layouts and on the tightest plane they take,
and the wrappers and their refusals.  All comparisons are exact."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tiny_mp2v_dec_tpu.ops.mc import pad_for_mc as jax_pad  # noqa: E402
from test_torch_mc_words import _tap_row2  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused, mc_rows  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_mc_variants",
        os.path.join(REPO, "tools", "profile_mc_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _load_jax_script()
SMALL = (48, 128)                      # 3 x 8 MBs


def _np(x):
    return x.numpy()


def _jax_variant_a(x):
    """The script's variant_a on the port's inputs: (H, W) uint8."""
    tiles = jax.jit(JS.variant_a)(
        jax_pad(jnp.asarray(_np(x.plane))), jnp.asarray(_np(x.pos_y)),
        jnp.asarray(_np(x.pos_x)), jnp.asarray(_np(x.mvx)),
        jnp.asarray(_np(x.mvy)), jnp.int32(0))
    return np.asarray(tiles).reshape(x.H // 16, x.W // 16, 16, 16).transpose(
        0, 2, 1, 3).reshape(x.H, x.W)


def _jax_kernel(monkeypatch, x, packed):
    """The script's _mc_row_kernel (_mc_row_kernel_packed with ``packed``)
    through variant_c's (variant_d's) grid spec, interpret mode, at the
    geometry of ``x``: (H, W) uint8 (H x W/4 uint32 words)."""
    mbw, mbh = x.W // 16, x.H // 16
    for k, v in dict(MBW=mbw, MBH=mbh, H=x.H, W=x.W, N=mbw * mbh).items():
        monkeypatch.setattr(JS, k, v)
    if packed:
        body, plane = JS._mc_row_kernel_packed, _np(x.plane32).view(np.uint32)
        scalars, cols, dt = (x.sy, x.sxq, x.rb, x.ph), x.W // 4, jnp.int32
    else:
        body, plane = JS._mc_row_kernel, _np(x.plane_pad)
        scalars, cols, dt = (x.sy, x.sx, x.ph), x.W, jnp.uint8
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=len(scalars), grid=(mbh,),
        in_specs=[pl.BlockSpec(plane.shape, lambda r, *_: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((16, cols), lambda r, *_: (r, 0),
                               memory_space=pltpu.VMEM))
    out = pl.pallas_call(body, grid_spec=grid_spec, interpret=True,
                         out_shape=jax.ShapeDtypeStruct((x.H, cols), dt))(
        *(jnp.asarray(_np(s)) for s in scalars), jnp.asarray(plane))
    out = np.asarray(out)
    return out.view(np.uint32) if packed else out


def _port(x):
    """The port's K9 and K10 (plain versions: CPU tensors) on ``x``: the
    (H, W) plane and the (H, W/4) uint32 words."""
    k9 = mc_rows.mc_row_pred(x.plane_pad, x.sy, x.sx, x.ph, H=x.H, W=x.W)
    k10 = mc_rows.mc_row_pred_packed(x.plane32, x.sy, x.sxq, x.rb, x.ph,
                                     H=x.H, W=x.W)
    return _np(k9), _np(k10).view(np.uint32)


def _set_starts(x, sy, sx, ph):
    """Replace the per-MB starts and phases, and the MVs that give them."""
    x.sy, x.sx, x.ph = sy.to(torch.int32), sx.to(torch.int32), ph.to(
        torch.int32)
    x.sxq, x.rb = x.sx >> 2, x.sx & 3
    x.mvx = (2 * (x.sx - x.pos_x) + (x.ph & 1)).to(torch.int16)
    x.mvy = (2 * (x.sy - x.pos_y) + (x.ph >> 1)).to(torch.int16)
    return x


def _set_plane(x, plane):
    """Replace the picture, keeping the script's padded shapes."""
    x.plane = torch.from_numpy(plane)
    pad = np.zeros(tuple(x.plane_pad.shape), np.uint8)
    pad[:x.H, :x.W] = plane
    x.plane_pad = torch.from_numpy(pad)
    p8 = np.zeros((x.plane32.shape[0], x.plane32.shape[1] * 4), np.uint8)
    p8[:x.H, :x.W] = plane
    x.plane32 = torch.from_numpy(p8.view(np.int32))
    return x


def test_profiler_inputs_are_the_jax_scripts():
    """make_inputs draws and pads as main() / main_packed() do (their code,
    with jnp where they use it), at 1080p."""
    x = pmv.make_inputs(device="cpu")
    H, W, MBW, N = JS.H, JS.W, JS.MBW, JS.N
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 256, (H, W)).astype(np.uint8)
    mb_y, mb_x = np.divmod(np.arange(N), MBW)
    pos_y = jnp.asarray(mb_y * 16, jnp.int32)
    pos_x = jnp.asarray(mb_x * 16, jnp.int32)
    mvx = jnp.asarray(rng.integers(-2 * mb_x * 16, 2 * (W - 16 - mb_x * 16)
                                   + 1), jnp.int16)
    mvy = jnp.asarray(rng.integers(-2 * mb_y * 16, 2 * (H - 16 - mb_y * 16)
                                   + 1), jnp.int16)
    ph_bits = ((mvx & 1) + 2 * (mvy & 1)).astype(jnp.int32)
    sy = jnp.clip(pos_y + (mvy.astype(jnp.int32) >> 1), 0, H - 16)
    sx = jnp.clip(pos_x + (mvx.astype(jnp.int32) >> 1), 0, W - 16)
    hp = ((H - 16 + 32 + 31) // 32) * 32
    wp = ((W - 16) // 128) * 128 + 256
    wq = ((int(W - 16) >> 2) // 128) * 128 + 256
    plane_pad = jnp.zeros((hp, wp), jnp.uint8).at[:H, :W].set(plane)
    p8 = np.zeros((hp, wq * 4), np.uint8)
    p8[:H, :W] = plane
    want = {"plane": plane, "pos_y": pos_y, "pos_x": pos_x, "mvx": mvx,
            "mvy": mvy, "ph": ph_bits, "sy": sy, "sx": sx, "sxq": sx >> 2,
            "rb": sx & 3, "plane_pad": plane_pad}
    assert (x.H, x.W) == (H, W)
    for k, v in want.items():
        got = _np(getattr(x, k))
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(_np(x.plane32).view(np.uint32),
                                  p8.view(np.uint32))


def test_plain_rows_match_variant_a_at_1080p():
    """Port plain K9 and K10 = the script's variant_a at its own shapes."""
    x = pmv.make_inputs(device="cpu")
    want = _jax_variant_a(x)
    k9, k10 = _port(x)
    np.testing.assert_array_equal(k9, want)
    np.testing.assert_array_equal(k10.view(np.uint8), want)


def test_plain_k9_matches_jax_kernel(monkeypatch):
    x = pmv.make_inputs(*SMALL, device="cpu")
    k9, _ = _port(x)
    np.testing.assert_array_equal(k9, _jax_kernel(monkeypatch, x, False))
    np.testing.assert_array_equal(k9, _jax_variant_a(x))


def test_plain_k10_matches_jax_kernel_where_sx_is_word_aligned(monkeypatch):
    """Where sx % 4 == 0 (rb = 0) the JAX K10 is right: the port's words
    equal its words, and both equal variant_a."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    _set_starts(x, x.sy, x.sx & ~3, x.ph)
    assert not x.rb.any() and len(set(_np(x.ph))) == 4
    _, k10 = _port(x)
    np.testing.assert_array_equal(k10, _jax_kernel(monkeypatch, x, True))
    np.testing.assert_array_equal(k10.view(np.uint8), _jax_variant_a(x))


@pytest.mark.parametrize("rb", [1, 2, 3])
def test_jax_k10_fills_top_bytes_with_ones(monkeypatch, rb):
    """The reference fault (profile_mc_variants.py:190): with rb != 0 and
    every pixel >= 128, at phase 0, the JAX K10's words differ from
    variant_a in exactly their top rb bytes, which it sets to 0xFF (the
    arithmetic shift's sign fill); the port's K10 equals variant_a."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    rng = np.random.default_rng(40 + rb)
    _set_plane(x, rng.integers(128, 255, SMALL).astype(np.uint8))
    sx = torch.clamp(x.sx & ~3, max=x.W - 20) + rb
    _set_starts(x, x.sy, sx, torch.zeros_like(x.ph))
    want = _jax_variant_a(x)
    _, k10 = _port(x)
    np.testing.assert_array_equal(k10.view(np.uint8), want)
    jax_bytes = _jax_kernel(monkeypatch, x, True).view(np.uint8).reshape(
        x.H, x.W // 4, 4)
    want = want.reshape(x.H, x.W // 4, 4)
    np.testing.assert_array_equal(jax_bytes[..., :4 - rb], want[..., :4 - rb])
    assert (jax_bytes[..., 4 - rb:] == 0xFF).all()
    assert (want[..., 4 - rb:] != 0xFF).all()


# (row, word column, JAX K10's word, variant_a's word) of the first word
# that differs, in raster order, on the script's inputs at 8 x 3 MBs: MB 1
# (sy 20, sx 66, rb 2, phase 0), its top two bytes sign-filled
FIRST_BAD_WORD = (0, 4, "0xffffa916", "0x9181a916")


def test_jax_k10_differs_exactly_where_rb_is_nonzero(monkeypatch):
    """On the script's own inputs at 8 x 3 MBs the JAX K10 differs from
    variant_a in the MBs whose rb != 0 and nowhere else (19 of 24 MBs);
    the first differing word is pinned.  The port's K10 equals
    variant_a."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    want = _jax_variant_a(x).view(np.uint32)
    _, k10 = _port(x)
    np.testing.assert_array_equal(k10, want)
    got = _jax_kernel(monkeypatch, x, True)
    bad = (got != want).reshape(x.H // 16, 16, x.W // 16, 4).any(
        axis=(1, 3)).reshape(-1)
    np.testing.assert_array_equal(bad, _np(x.rb) != 0)
    assert int(bad.sum()) == 19
    y, w = (int(v[0]) for v in np.nonzero(got != want))
    assert (y, w, hex(got[y, w]), hex(want[y, w])) == FIRST_BAD_WORD


@pytest.mark.parametrize("ph", [0, 1, 2, 3])
def test_edge_starts(monkeypatch, ph):
    """Windows at sy = H-16, sx = W-16 or both, whose +1 taps read the zero
    padding, at every phase: port plain K9 and K10 = variant_a = the JAX
    kernels (rb = 0 everywhere, so the JAX K10 is right too)."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    i = torch.arange(x.sy.numel())
    _set_starts(x, torch.where(i % 3 != 1, x.H - 16, x.sy),
                torch.where(i % 3 != 0, x.W - 16, x.sx & ~3),
                torch.full_like(x.ph, ph))
    want = _jax_variant_a(x)
    k9, k10 = _port(x)
    np.testing.assert_array_equal(k9, want)
    np.testing.assert_array_equal(k10.view(np.uint8), want)
    np.testing.assert_array_equal(_jax_kernel(monkeypatch, x, False), want)
    np.testing.assert_array_equal(_jax_kernel(monkeypatch, x, True), k10)


def test_row_wrappers_take_no_kernel_on_cpu_and_refuse_what_they_cannot():
    x = pmv.make_inputs(*SMALL, device="cpu")
    before = dict(_build.LAUNCHES)
    k9, k10 = _port(x)
    assert k9.shape == SMALL and k10.shape == (SMALL[0], SMALL[1] // 4)
    assert dict(_build.LAUNCHES) == before
    kw = dict(H=x.H, W=x.W)
    with pytest.raises(ValueError, match="no kernel"):
        mc_rows.mc_row_pred(x.plane_pad.to("meta"), *(
            v.to("meta") for v in (x.sy, x.sx, x.ph)), **kw)
    with pytest.raises(ValueError, match="int32"):
        mc_rows.mc_row_pred_packed(x.plane_pad, x.sy, x.sxq, x.rb, x.ph,
                                   **kw)
    with pytest.raises(ValueError, match="zero padding"):
        mc_rows.mc_row_pred(x.plane, x.sy, x.sx, x.ph, **kw)
    with pytest.raises(ValueError, match="per-MB"):
        mc_rows.mc_row_pred(x.plane_pad, x.sy.long(), x.sx, x.ph, **kw)
    with pytest.raises(ValueError, match="whole number"):
        mc_rows.mc_row_pred(x.plane_pad, x.sy, x.sx, x.ph, H=40, W=x.W)


def _quad_direction(words, sy, sx, ph):
    """``quad_pred`` (csrc/mc_rows.cu) for one direction of one 16x16 tile,
    lane 2*ty + seg holding segment ``seg`` of tile row ``ty``: the (32, 2)
    int64 prediction words from one 16-byte load per lane — quad
    ``(sx >> 4) + seg`` of row ``sy + ty`` of ``words`` — the two words the
    pair swaps (``pick3``), the three each lane picks at offset
    ``(sx >> 2) & 3``, and under a vertical phase the row below from
    lane + 2, the lanes of tile row 15 loading row ``sy + 16``.  Each load is logged; the log must hold
    the window's two quads of each of its rows exactly once."""
    lane = torch.arange(32)
    ty, seg = lane >> 1, lane & 1
    q, r = sx >> 4, (sx >> 2) & 3
    s = torch.full((32,), (sx & 3) << 3)
    quads = words.reshape(words.shape[0], -1, 4)
    loads = []

    def load(rows, lanes):
        cols = q + seg
        loads.extend(zip(rows[lanes].tolist(), cols[lanes].tolist()))
        return torch.where(lanes[:, None], quads[torch.where(lanes, rows, 0),
                                                 torch.where(lanes, cols, 0)],
                           0)

    def pick3(v):
        one = (seg == 1)[:, None]
        o = torch.where(one, v[:, :2], v[:, 2:])[lane ^ 1]  # two shuffles
        a = torch.where(one, torch.cat([o, v], 1), torch.cat([v, o], 1))
        return [a[:, r + k] for k in range(3)]

    w = pick3(load(sy + ty, torch.ones(32, dtype=torch.bool)))
    p = _tap_row2(*w, s, ph)
    vert = bool(ph & 2)
    if vert:
        down = torch.where(lane + 2 < 32, lane + 2, lane)  # __shfl_down_sync
        last = ty == 15
        e = pick3(load(sy + ty + 1, last))
        v = [torch.where(last, e[k], w[k][down]) for k in range(3)]
        p = [mc_fused.avg_up(p[k], b) for k, b in enumerate(_tap_row2(*v, s,
                                                                       ph))]
    assert sorted(loads) == [(row, c) for row in range(sy, sy + 16 + vert)
                             for c in (q, q + 1)]
    return torch.stack(p, dim=1)


def _warp_model(x, packed):
    """``mc_row_warp_kernel`` (csrc/mc_rows.cu) lane by lane: per MB the
    clamped start (K10: ``4 * sxq + rb``) and the phase, one warp on K9's
    byte plane read as words or on K10's word plane, through
    :func:`_quad_direction` — then each block's 8 MBs through the shared
    slots ``[c][ty ^ c]`` and out by rows.
    Returns the (H, W/4) int32 words."""
    if packed:
        words, sx = x.plane32, x.sxq.to(torch.int64) * 4 + x.rb
    else:
        words, sx = mc_fused.pack_ref_words(x.plane_pad), x.sx
    words = words.to(torch.int64) & 0xFFFFFFFF
    sy, sx = mc_rows._starts(x.sy, sx, x.H, x.W)
    mbw, n = x.W // 16, sy.numel()
    lane = torch.arange(32)
    out = torch.zeros((x.H, x.W // 4), dtype=torch.int64)
    for i0 in range(0, n, 8):
        slots = torch.zeros((16, 16, 2), dtype=torch.int64)
        for i in range(i0, min(i0 + 8, n)):
            c = 2 * (i - i0) + (lane & 1)
            slots[c, (lane >> 1) ^ c] = _quad_direction(
                words, int(sy[i]), int(sx[i]), int(x.ph[i]))
        for t in range(256):
            ty, c = t >> 4, t & 15
            j = i0 + (c >> 1)
            if j < n:
                col = (j % mbw) * 4 + (c & 1) * 2
                out[(j // mbw) * 16 + ty, col:col + 2] = slots[c, ty ^ c]
    return mc_fused.words_to_int32(out)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("starts", pmv.ROW_STARTS)
@pytest.mark.parametrize("plane", ["script", "tight"])
@pytest.mark.parametrize("geometry", [SMALL, (48, 80)], ids=["8x3", "5x3"])
def test_warp_scheme_equals_plain_and_variant_a(geometry, plane, starts,
                                                packed):
    """The kernels' warp scheme (one warp per MB; 16-byte window loads;
    the block's MBs stored by rows), on K9's bytes viewed as words
    and on K10's words, equals the plain version and the script's
    ``variant_a``: at 8 x 3 MBs and at 5 x 3 (blocks across MB rows, a
    last block of 7 MBs), on the script's padded plane and on the tightest
    one, at the script's starts, at the edges at every phase and at every
    ``sx & 3`` at every phase."""
    x = pmv.row_case(pmv.make_inputs(*geometry, device="cpu"), starts,
                     tight=plane == "tight")
    if starts == "sx_phases":
        assert len(set(zip(_np(x.rb), _np(x.ph)))) == min(16, x.sy.numel())
    got = _warp_model(x, packed)
    if packed:
        want = mc_rows.mc_row_pred_packed_ref(x.plane32, x.sy, x.sxq, x.rb,
                                              x.ph, H=x.H, W=x.W)
        assert torch.equal(got, want)
    else:
        want = mc_rows.mc_row_pred_ref(x.plane_pad, x.sy, x.sx, x.ph, H=x.H,
                                       W=x.W)
        assert torch.equal(mc_fused.unpack_words(got), want)
    np.testing.assert_array_equal(_np(mc_fused.unpack_words(got)),
                                  _jax_variant_a(x))


def _unquadded(x, fault, packed):
    """A plane of the script's rows that the kernels cannot read as 16-byte
    quads: K9's bytes or K10's words, of an odd width (K9), of rows of
    W + 4 bytes, or a contiguous view one element past the allocation."""
    dtype = torch.int32 if packed else torch.uint8
    Hp, Wp = (x.plane32 if packed else x.plane_pad).shape
    if fault == "odd width":
        return torch.zeros((Hp, x.W + 1), dtype=dtype)
    if fault == "W + 4 bytes":
        return torch.zeros((Hp, (x.W + 4) // (4 if packed else 1)),
                           dtype=dtype)
    plane = torch.zeros(Hp * Wp + 1, dtype=dtype)[1:].view(Hp, Wp)
    assert plane.is_contiguous() and plane.data_ptr() % 16
    return plane


@pytest.mark.parametrize("fault", ["odd width", "misaligned", "W + 4 bytes"])
def test_k9_refuses_a_plane_it_cannot_read_as_words(fault):
    """K9 reads its byte plane as 16-byte quads: a plane of odd width or
    of rows of W + 4 bytes, or a contiguous view one byte past a quad, is
    refused on every device before any launch — no plain fallback on the
    card."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mc_rows.mc_row_pred(_unquadded(x, fault, False), x.sy, x.sx, x.ph,
                            H=x.H, W=x.W)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("fault", ["misaligned", "W + 4 bytes"])
def test_k10_refuses_a_plane_it_cannot_read_as_quads(fault):
    """K10 reads its word plane as 16-byte quads: rows of W/4 + 1 words,
    or a contiguous view one word past a quad, are refused on every device
    before any launch."""
    x = pmv.make_inputs(*SMALL, device="cpu")
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mc_rows.mc_row_pred_packed(_unquadded(x, fault, True), x.sy, x.sxq,
                                   x.rb, x.ph, H=x.H, W=x.W)
    assert dict(_build.LAUNCHES) == before
