"""PyTorch port, K2/K3/K4 and their building blocks: fused MC +
reconstruction against the JAX package's MXU Pallas kernels (interpret
mode), on planes of a 192x112 picture (7 MB rows) in every chroma format,
with full random MV and mode coverage; field prediction on about half the
MBs, random field selects, MVs past every edge."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tiny_mp2v_dec_tpu.ops import mc as jmc  # noqa: E402
from tiny_mp2v_dec_tpu.ops.mc_pallas import (  # noqa: E402
    fused_mc_recon_mxu, fused_mc_recon_uv_mxu, interleave_uv,
    mc_field_meta as jmc_field_meta, mc_meta as jmc_meta, pad_ref_plane,
    pad_ref_plane_uv)
from tiny_mp2v_dec_tpu_torch.ops import _build, mc, mc_fused  # noqa: E402

W, H = 192, 112                       # luma; 12 x 7 macroblocks
# chroma tile (rows, columns) -> chroma plane (rows, columns) of the picture
CHROMA = {(8, 8): (H // 2, W // 2), (16, 8): (H, W // 2), (16, 16): (H, W)}


def _case(seed, h, w, Hp, Wp, field=False):
    """Random refs, residual, MVs and modes for an (Hp, Wp) plane of
    (h, w) MBs; MVs reach past every edge (clamps) and cover all phases,
    modes cover every fwd/bwd/coded combination.  ``field=True`` adds the
    second unit's MVs (``fmv``, (n, 2:unit, 2:dir, 2:xy)), random field
    selects (``mvfs``, (n, 2:unit, 2:dir)) and mode bit 8 on about half
    the MBs."""
    rng = np.random.default_rng(seed)
    mbh, mbw = Hp // h, Wp // w
    n = mbh * mbw
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    c = {
        "refs": [rng.integers(0, 256, (Hp, Wp)).astype(np.uint8)
                 for _ in range(4)],
        "res": [rng.integers(-300, 300, (Hp, Wp)).astype(np.int16)
                for _ in range(2)],
        "pos": ((mb_y * h).astype(np.int32), (mb_x * w).astype(np.int32)),
        "mv": rng.integers(-64, 64, (n, 2, 2)).astype(np.int16),
        "mode": rng.permutation(np.arange(n) % 8).astype(np.int32),
    }
    if field:
        c["fmv"] = rng.integers(-64, 64, (n, 2, 2, 2)).astype(np.int16)
        c["mvfs"] = rng.integers(0, 2, (n, 2, 2)).astype(np.uint8)
        c["mode"] += 8 * (rng.random(n) < 0.5).astype(np.int32)
    return c


def _meta_both(c, Hp, Wp, h, w):
    """Per-MB (sy, sx, ph) for both directions from the port and from JAX;
    asserts they agree and returns them as numpy."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = []
    for s in range(2):
        mvx, mvy = c["mv"][:, s, 0], c["mv"][:, s, 1]
        got = mc_fused.mc_meta(t(c["pos"][0]), t(c["pos"][1]), t(mvx),
                               t(mvy), Hp, Wp, h, w)
        want = jmc_meta(jnp.asarray(c["pos"][0]), jnp.asarray(c["pos"][1]),
                        jnp.asarray(mvx), jnp.asarray(mvy), Hp, Wp, h, w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        out += [g.numpy() for g in got]
    return out + [c["mode"]]


def _field_meta_both(c, Hp, Wp, h, w):
    """Per-direction field tuples from the port and from JAX; asserts they
    agree and returns the port's as two tuples of numpy arrays."""
    out = []
    for s in range(2):
        mvc, fs = c["fmv"][:, :, s], c["mvfs"][:, :, s]
        got = mc_fused.mc_field_meta(
            torch.from_numpy(c["pos"][0]), torch.from_numpy(c["pos"][1]),
            torch.from_numpy(np.ascontiguousarray(mvc)),
            torch.from_numpy(np.ascontiguousarray(fs)), Hp, Wp, h, w)
        want = jmc_field_meta(jnp.asarray(c["pos"][0]),
                              jnp.asarray(c["pos"][1]), jnp.asarray(mvc),
                              jnp.asarray(fs), Hp, Wp, h, w)
        assert len(got) == len(want) == 6
        for g, x in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        out.append(tuple(g.numpy() for g in got))
    return out


@pytest.mark.parametrize("bidir", [True, False])
def test_fused_mc_recon_luma_matches_pallas(bidir):
    c = _case(11, 16, 16, H, W)
    meta = _meta_both(c, H, W, 16, 16)
    r0, r1 = c["refs"][:2]
    got = mc_fused.fused_mc_recon(
        torch.from_numpy(r0), torch.from_numpy(r1),
        torch.from_numpy(c["res"][0]), *map(torch.from_numpy, meta),
        h=16, w=16, bidir=bidir)
    bf = lambda p: pad_ref_plane(jnp.asarray(p), 16, 16).astype(  # noqa: E731
        jnp.bfloat16)
    want = fused_mc_recon_mxu(bf(r0), bf(r1), jnp.asarray(c["res"][0]),
                              *map(jnp.asarray, meta), h=16, w=16, H=H, W=W,
                              interpret=True, bidir=bidir)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bidir", [True, False])
def test_fused_mc_recon_uv_matches_pallas(bidir):
    Hc, Wc = H // 2, W // 2
    c = _case(12, 8, 8, Hc, Wc)
    meta = _meta_both(c, Hc, Wc, 8, 8)
    u0, v0, u1, v1 = c["refs"]
    t = torch.from_numpy
    gu, gv = mc_fused.fused_mc_recon_uv(
        (t(u0), t(v0)), (t(u1), t(v1)), (t(c["res"][0]), t(c["res"][1])),
        *map(t, meta), h=8, w=8, bidir=bidir)
    bf = lambda u, v: pad_ref_plane_uv(  # noqa: E731
        jnp.asarray(u), jnp.asarray(v), 8, 8).astype(jnp.bfloat16)
    syf, sxf, phf, syb, sxb, phb, mode = map(jnp.asarray, meta)
    uv = np.asarray(fused_mc_recon_uv_mxu(
        bf(u0, v0), bf(u1, v1),
        interleave_uv(jnp.asarray(c["res"][0]), jnp.asarray(c["res"][1])),
        syf, 2 * sxf, phf, syb, 2 * sxb, phb, mode, h=8, w=8, H=Hc, W=Wc,
        interpret=True, bidir=bidir, pair=bidir))
    np.testing.assert_array_equal(gu.numpy(), uv[:, 0::2])
    np.testing.assert_array_equal(gv.numpy(), uv[:, 1::2])


@pytest.mark.parametrize("h,w", [(16, 16), (8, 8)])
def test_mc_building_blocks_match_jax(h, w):
    """gather_windows (explicit start clamps, incl. negative starts),
    halfpel_select, mc_unidir_tiles and mc_bidir_tiles == ops/mc.py."""
    rng = np.random.default_rng(h)
    plane = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    n = 64
    pos_y = rng.integers(0, 48 - h + 1, n).astype(np.int32)
    pos_x = rng.integers(0, 64 - w + 1, n).astype(np.int32)
    mvx, mvy = (rng.integers(-100, 100, n).astype(np.int16)
                for _ in range(2))
    t = torch.from_numpy
    tiles = []
    for lib, arr in ((mc, t), (jmc, jnp.asarray)):
        padded = lib.pad_for_mc(arr(plane))
        p0 = lib.mc_unidir_tiles(padded, arr(pos_y), arr(pos_x), arr(mvx),
                                 arr(mvy), h, w)
        p1 = lib.mc_unidir_tiles(padded, arr(pos_y), arr(pos_x), arr(mvy),
                                 arr(mvx), h, w)
        tiles.append([np.asarray(x) for x in (p0, p1,
                                              lib.mc_bidir_tiles(p0, p1))])
    for got, want in zip(*tiles):
        np.testing.assert_array_equal(got, want)


def test_fused_mc_cpu_takes_no_kernel_and_rejects_other_devices():
    z8 = torch.zeros((16, 16), dtype=torch.uint8)
    z16 = torch.zeros((16, 16), dtype=torch.int16)
    meta = [torch.zeros(1, dtype=torch.int32) for _ in range(7)]
    before = dict(_build.LAUNCHES)
    out = mc_fused.fused_mc_recon(z8, z8, z16, *meta)
    assert out.dtype == torch.uint8 and dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel"):
        mc_fused.fused_mc_recon(z8, z8, z16.to("meta"), *meta)



@pytest.mark.parametrize("h,w,Hp,Wp", [(16, 16, H, W), (8, 8, H // 2, W // 2),
                                       (16, 8, H, W // 2), (16, 16, 32, 48)])
def test_mc_field_meta_matches_jax(h, w, Hp, Wp):
    """Affine row bases, columns and phases of both units: field-row clamps
    reached at the top and bottom (unit 1's base spans [-1, Hp - h])."""
    c = _case(21 + h + w + Hp, h, w, Hp, Wp, field=True)
    fld_f, fld_b = _field_meta_both(c, Hp, Wp, h, w)
    cs = np.concatenate([fld_f[3], fld_b[3]])
    assert cs.min() == -1 and cs.max() == Hp - h


@pytest.mark.parametrize("h,w", [(8, 16), (4, 8), (8, 8)])
def test_field_building_blocks_match_jax(h, w):
    """field_views, gather_windows_fields (explicit clamps, negative starts
    included) and mc_field_tiles == ops/mc.py on the JAX side."""
    rng = np.random.default_rng(100 + h + w)
    plane = rng.integers(0, 256, (48, 64)).astype(np.uint8)
    n = 64
    pos_y = rng.integers(0, 24 - h + 1, n).astype(np.int32)
    pos_x = rng.integers(0, 64 - w + 1, n).astype(np.int32)
    sel = rng.integers(0, 2, n).astype(np.uint8)
    mvx, mvy = (rng.integers(-100, 100, n).astype(np.int16)
                for _ in range(2))
    t = torch.from_numpy
    fields = mc.field_views(t(plane))
    want_fields = jnp.stack([jmc.pad_for_mc(jnp.asarray(plane[0::2])),
                             jmc.pad_for_mc(jnp.asarray(plane[1::2]))])
    np.testing.assert_array_equal(fields.numpy(), np.asarray(want_fields))
    got = mc.gather_windows_fields(fields, t(sel), t(pos_y - 5),
                                   t(pos_x + 7), h, w)
    want = jmc.gather_windows_fields(want_fields, jnp.asarray(sel),
                                     jnp.asarray(pos_y - 5),
                                     jnp.asarray(pos_x + 7), h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = mc.mc_field_tiles(fields, t(sel), t(pos_y), t(pos_x), t(mvx),
                            t(mvy), h, w)
    want = jmc.mc_field_tiles(want_fields, jnp.asarray(sel),
                              jnp.asarray(pos_y), jnp.asarray(pos_x),
                              jnp.asarray(mvx), jnp.asarray(mvy), h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bidir", [True, False])
def test_fused_mc_field_luma_matches_pallas(bidir):
    """K4, luma 16x16: the field form against fused_mc_recon_mxu with the
    19 scalar-prefetch vectors."""
    c = _case(31, 16, 16, H, W, field=True)
    meta = _meta_both(c, H, W, 16, 16)
    fld = _field_meta_both(c, H, W, 16, 16)
    r0, r1 = c["refs"][:2]
    t = torch.from_numpy
    got = mc_fused.fused_mc_recon(
        t(r0), t(r1), t(c["res"][0]), *map(t, meta),
        *(tuple(map(t, f)) for f in fld), h=16, w=16, bidir=bidir)
    bf = lambda p: pad_ref_plane(jnp.asarray(p), 16, 16,  # noqa: E731
                                 field=True).astype(jnp.bfloat16)
    want = fused_mc_recon_mxu(
        bf(r0), bf(r1), jnp.asarray(c["res"][0]), *map(jnp.asarray, meta),
        *(tuple(map(jnp.asarray, f)) for f in fld), h=16, w=16, H=H, W=W,
        interpret=True, bidir=bidir)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _uv_against_pallas(c, meta, fld, h, w, Hc, Wc, bidir, pair):
    """The port's U+V planes and the JAX kernel's, deinterleaved: sx
    doubled for the column-interleaved plane, in the frame triples and in
    the field tuples alike."""
    u0, v0, u1, v1 = c["refs"]
    t = torch.from_numpy
    tfld = [tuple(map(t, f)) for f in fld] if fld else []
    gu, gv = mc_fused.fused_mc_recon_uv(
        (t(u0), t(v0)), (t(u1), t(v1)), (t(c["res"][0]), t(c["res"][1])),
        *map(t, meta), *tfld, h=h, w=w, bidir=bidir)
    bf = lambda u, v: pad_ref_plane_uv(  # noqa: E731
        jnp.asarray(u), jnp.asarray(v), h, w,
        field=bool(fld)).astype(jnp.bfloat16)
    syf, sxf, phf, syb, sxb, phb, mode = map(jnp.asarray, meta)
    jfld = [tuple(jnp.asarray(2 * x if k % 3 == 1 else x)
                  for k, x in enumerate(f)) for f in fld] if fld else []
    uv = np.asarray(fused_mc_recon_uv_mxu(
        bf(u0, v0), bf(u1, v1),
        interleave_uv(jnp.asarray(c["res"][0]), jnp.asarray(c["res"][1])),
        syf, 2 * sxf, phf, syb, 2 * sxb, phb, mode, *jfld, h=h, w=w, H=Hc,
        W=Wc, interpret=True, bidir=bidir, pair=pair))
    np.testing.assert_array_equal(gu.numpy(), uv[:, 0::2])
    np.testing.assert_array_equal(gv.numpy(), uv[:, 1::2])


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("h,w", [(16, 8), (16, 16)])
def test_fused_mc_recon_uv_tiles_match_pallas(h, w, bidir):
    """K3, frame form, at the 4:2:2 (16x8) and 4:4:4 (16x16) chroma
    tiles."""
    Hc, Wc = CHROMA[(h, w)]
    c = _case(40 + h + w, h, w, Hc, Wc)
    meta = _meta_both(c, Hc, Wc, h, w)
    _uv_against_pallas(c, meta, None, h, w, Hc, Wc, bidir, pair=bidir)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("h,w", [(8, 8), (16, 8), (16, 16)])
def test_fused_mc_field_uv_matches_pallas(h, w, bidir):
    """K4, chroma: the field form at every chroma tile against
    fused_mc_recon_uv_mxu (pair=False, as the JAX package runs it for
    field chunks)."""
    Hc, Wc = CHROMA[(h, w)]
    c = _case(50 + h + w, h, w, Hc, Wc, field=True)
    meta = _meta_both(c, Hc, Wc, h, w)
    fld = _field_meta_both(c, Hc, Wc, h, w)
    _uv_against_pallas(c, meta, fld, h, w, Hc, Wc, bidir, pair=False)


def test_field_wrapper_arguments():
    """The field form needs both directions' tuples, in the forward-only
    form too; the kernel wrappers refuse tiles they have no instantiation
    for."""
    c = _case(60, 16, 16, 32, 32, field=True)
    meta = _meta_both(c, 32, 32, 16, 16)
    fld_f, fld_b = (tuple(map(torch.from_numpy, f))
                    for f in _field_meta_both(c, 32, 32, 16, 16))
    t = torch.from_numpy
    args = (t(c["refs"][0]), t(c["refs"][1]), t(c["res"][0]), *map(t, meta))
    for bidir in (True, False):
        with pytest.raises(ValueError, match="fld_f and fld_b"):
            mc_fused.fused_mc_recon(*args, fld_f, h=16, w=16, bidir=bidir)
        with pytest.raises(ValueError, match="fld_f and fld_b"):
            mc_fused.fused_mc_recon(*args, None, fld_b, h=16, w=16,
                                    bidir=bidir)
    both = mc_fused.fused_mc_recon(*args, fld_f, fld_b, h=16, w=16,
                                   bidir=False)
    assert both.shape == (32, 32)
    with pytest.raises(ValueError, match="tiles"):
        mc_fused._launch("mp2v_mc_field_luma", "mc_field_luma", args[:1],
                         args[1:2], args[2:3], args[3:], 8, 8, True)
