"""PyTorch port, K2/K3 and their building blocks: fused MC + reconstruction
against the JAX package's MXU Pallas kernels (interpret mode), on a
192x112 4:2:0 picture with full random MV and mode coverage."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tiny_mp2v_dec_tpu.ops import mc as jmc  # noqa: E402
from tiny_mp2v_dec_tpu.ops.mc_pallas import (  # noqa: E402
    fused_mc_recon_mxu, fused_mc_recon_uv_mxu, interleave_uv, mc_meta as
    jmc_meta, pad_ref_plane, pad_ref_plane_uv)
from tiny_mp2v_dec_tpu_torch.ops import _build, mc, mc_fused  # noqa: E402

W, H = 192, 112                       # luma; 12 x 7 macroblocks


def _case(seed, h, w, Hp, Wp):
    """Random refs, residual, MVs and modes for an (Hp, Wp) plane of
    (h, w) MBs; MVs reach past every edge (clamps) and cover all phases,
    modes cover every fwd/bwd/coded combination."""
    rng = np.random.default_rng(seed)
    mbh, mbw = Hp // h, Wp // w
    n = mbh * mbw
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    return {
        "refs": [rng.integers(0, 256, (Hp, Wp)).astype(np.uint8)
                 for _ in range(4)],
        "res": [rng.integers(-300, 300, (Hp, Wp)).astype(np.int16)
                for _ in range(2)],
        "pos": ((mb_y * h).astype(np.int32), (mb_x * w).astype(np.int32)),
        "mv": rng.integers(-64, 64, (n, 2, 2)).astype(np.int16),
        "mode": rng.permutation(np.arange(n) % 8).astype(np.int32),
    }


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

