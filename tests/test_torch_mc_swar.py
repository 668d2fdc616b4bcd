"""PyTorch port, K7/K8 (``MP2V_MC_IMPL=swar``): the word helpers, the
packed-word plain versions against the JAX package's SWAR Pallas kernels
(interpret mode) and against the port's unpacked gather, on planes 2-7 MBs
tall with MVs past every edge, luma and each chroma tile; K7's picture form
(three components, one mode vector) against three calls of the JAX kernel,
and the checks its launcher makes before a launch; then ``DeviceRecon`` and
the decoder under swar.  All comparisons are exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_mc import (CHROMA, H, W, _case, _field_meta_both,  # noqa: E402
                           _meta_both)
from torch_parity import (assert_frames_equal, device_recon_parity,  # noqa: E402
                          ipb_stream)
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as HD  # noqa: E402
from tiny_mp2v_dec_tpu.ops import mc_pallas as jp  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import PictureGeometry  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon  # noqa: E402

# one component per call: (tile rows, columns), (plane rows, columns)
TILES = {"luma": ((16, 16), (H, W)),
         **{fmt: (tile, CHROMA[tile]) for fmt, tile in (
             ("4:2:0", (8, 8)), ("4:2:2", (16, 8)), ("4:4:4", (16, 16)))}}


def test_word_helpers_match_jax():
    """Pixel x at byte x % 4, least significant first, as JAX's bitcast;
    unpack_words inverts it."""
    plane = np.random.default_rng(1).integers(0, 256, (6, 24)).astype(
        np.uint8)
    got = mc_fused.pack_ref_words(torch.from_numpy(plane))
    want = np.asarray(jp.pack_ref_words(jnp.asarray(plane)))
    assert got.dtype == torch.int32 and got.shape == (6, 6)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(mc_fused.unpack_words(got).numpy(),
                                  np.asarray(jp.unpack_words(jnp.asarray(
                                      want))))
    np.testing.assert_array_equal(mc_fused.unpack_words(got).numpy(), plane)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_avg_up_all_byte_pairs(dtype):
    """avg_up == JAX's _avg_up == (x + y + 1) >> 1 on every byte pair, on
    int32 words (arithmetic shifts) and int64 words holding the unsigned
    value."""
    v = np.arange(65536)
    x, y = (v >> 8).astype(np.uint8), (v & 255).astype(np.uint8)
    xw, yw = x.view(np.uint32), y.view(np.uint32)
    want = np.asarray(jp._avg_up(jnp.asarray(xw), jnp.asarray(yw)))
    np.testing.assert_array_equal(want.view(np.uint8),
                                  (x.astype(int) + y + 1) >> 1)
    if dtype == torch.int32:
        got = mc_fused.avg_up(torch.from_numpy(xw.view(np.int32)),
                              torch.from_numpy(yw.view(np.int32)))
        got = got.numpy().view(np.uint32)
    else:
        got = mc_fused.avg_up(torch.from_numpy(xw.astype(np.int64)),
                              torch.from_numpy(yw.astype(np.int64)))
        got = got.numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def _swar_case(tile, seed, field):
    (h, w), (Hp, Wp) = TILES[tile]
    c = _case(seed + h + w + Hp, h, w, Hp, Wp, field=field)
    meta = _meta_both(c, Hp, Wp, h, w)
    fld = _field_meta_both(c, Hp, Wp, h, w) if field else []
    return c, meta, fld, (h, w, Hp, Wp)


def _check_words(got, want, r0, r1, meta, fld, h, w, Hp, Wp, bidir):
    """The port's words equal JAX's, and unpacked they equal the port's
    gather formulation: K2's (K4's) plain version with a zero residual
    and the coded bit set on every MB."""
    t = torch.from_numpy
    assert got.dtype == torch.int32 and got.shape == (Hp, Wp // 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    tm = [t(m) for m in meta]
    gather = mc_fused.fused_mc_recon_ref(
        t(r0), t(r1), torch.zeros((Hp, Wp), dtype=torch.int16), *tm[:6],
        tm[6] | 4, *(tuple(map(t, f)) for f in fld), h=h, w=w, bidir=bidir)
    np.testing.assert_array_equal(mc_fused.unpack_words(got).numpy(),
                                  gather.numpy())


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("tile", list(TILES))
def test_swar_pred_matches_pallas_and_gather(tile, bidir):
    """K7's plain version: fused_mc_pred_swar in interpret mode, padded
    word planes on the JAX side, the unpadded plane on the port's."""
    c, meta, _, (h, w, Hp, Wp) = _swar_case(tile, 70, field=False)
    r0, r1 = c["refs"][:2]
    t = torch.from_numpy
    got = mc_fused.fused_mc_pred_swar(t(r0), t(r1), *map(t, meta), h=h, w=w,
                                      bidir=bidir)
    want = jp.fused_mc_pred_swar(
        jp.pad_ref_words(jnp.asarray(r0), h, w),
        jp.pad_ref_words(jnp.asarray(r1), h, w), *map(jnp.asarray, meta),
        h=h, w=w, H=Hp, W=Wp, interpret=True, bidir=bidir)
    _check_words(got, want, r0, r1, meta, [], h, w, Hp, Wp, bidir)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("tile", list(TILES))
def test_swar_field_pred_matches_pallas_and_gather(tile, bidir):
    """K8's plain version: fused_mc_pred_swar_field in interpret mode (the
    19 scalar-prefetch vectors), field bit on about half the MBs."""
    c, meta, fld, (h, w, Hp, Wp) = _swar_case(tile, 90, field=True)
    r0, r1 = c["refs"][:2]
    t = torch.from_numpy
    got = mc_fused.fused_mc_pred_swar_field(
        t(r0), t(r1), *map(t, meta), *(tuple(map(t, f)) for f in fld), h=h,
        w=w, bidir=bidir)
    pad = lambda p: jp.pad_ref_words(jnp.asarray(p), h, w,  # noqa: E731
                                     field=True)
    want = jp.fused_mc_pred_swar_field(
        pad(r0), pad(r1), *map(jnp.asarray, meta),
        *(tuple(map(jnp.asarray, f)) for f in fld), h=h, w=w, H=Hp, W=Wp,
        interpret=True, bidir=bidir)
    _check_words(got, want, r0, r1, meta, fld, h, w, Hp, Wp, bidir)


def test_swar_wrappers_take_no_kernel_on_cpu_and_refuse_other_devices():
    z8 = torch.zeros((16, 16), dtype=torch.uint8)
    meta = [torch.zeros(1, dtype=torch.int32) for _ in range(7)]
    fld = tuple(torch.zeros(1, dtype=torch.int32) for _ in range(6))
    before = dict(_build.LAUNCHES)
    out = mc_fused.fused_mc_pred_swar(z8, z8, *meta)
    assert out.dtype == torch.int32 and out.shape == (16, 4)
    out = mc_fused.fused_mc_pred_swar_field(z8, z8, *meta, fld, fld)
    assert out.dtype == torch.int32 and out.shape == (16, 4)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="no kernel"):
        mc_fused.fused_mc_pred_swar(z8.to("meta"), z8, *meta)
    with pytest.raises(ValueError, match="tiles"):
        mc_fused._launch("mp2v_mc_swar", "mc_swar", (z8,), (z8,), (), meta,
                         8, 16, True)


MBH, MBW = 3, 4                       # the picture form's test picture


def _yuv_case(fmt, seed):
    """One picture of MBH x MBW MBs at chroma format ``fmt``: numpy (Y, U,
    V) reference triples, the luma and the chroma vectors (random MVs past
    every edge, per component) and the mode vector all three share."""
    h, w = TILES[fmt][0]
    cy = _case(seed, 16, 16, MBH * 16, MBW * 16)
    cc = _case(seed + 1, h, w, MBH * h, MBW * w)
    meta_y = _meta_both(cy, MBH * 16, MBW * 16, 16, 16)
    meta_c = _meta_both(cc, MBH * h, MBW * w, h, w)
    return ((cy["refs"][0], cc["refs"][0], cc["refs"][1]),
            (cy["refs"][1], cc["refs"][2], cc["refs"][3]),
            meta_y[:6], meta_c[:6], cy["mode"], (h, w))


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("fmt", ["4:2:0", "4:2:2", "4:4:4"])
def test_swar_yuv_matches_three_pallas_calls(fmt, bidir):
    """K7's picture form on the CPU: each of its three word planes equals
    the JAX kernel's on that component (interpret mode), U and V on the
    chroma vectors, all three on the one mode vector."""
    ref0, ref1, meta_y, meta_c, mode, (h, w) = _yuv_case(fmt, 170)
    t = torch.from_numpy
    tt = lambda xs: tuple(map(t, xs))  # noqa: E731
    before = dict(_build.LAUNCHES)
    got = mc_fused.fused_mc_pred_swar_yuv(tt(ref0), tt(ref1), tt(meta_y),
                                          tt(meta_c), t(mode), h=h, w=w,
                                          bidir=bidir)
    assert dict(_build.LAUNCHES) == before
    assert len(got) == 3
    comps = ((16, 16, meta_y), (h, w, meta_c), (h, w, meta_c))
    for g, r0, r1, (th, tw, meta) in zip(got, ref0, ref1, comps):
        Hp, Wp = r0.shape
        want = jp.fused_mc_pred_swar(
            jp.pad_ref_words(jnp.asarray(r0), th, tw),
            jp.pad_ref_words(jnp.asarray(r1), th, tw),
            *map(jnp.asarray, meta), jnp.asarray(mode), h=th, w=tw, H=Hp,
            W=Wp, interpret=True, bidir=bidir)
        _check_words(g, want, r0, r1, [*meta, mode], [], th, tw, Hp, Wp,
                     bidir)


def _misaligned(x):
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


# fault -> (what it does to the arguments of _launch_yuv, the error's text)
YUV_FAULTS = {
    "chroma-shape": (lambda a: (a[0][:1] + tuple(
        x[:, :x.shape[1] // 2].contiguous() for x in a[0][1:]),
        a[1][:1] + tuple(x[:, :x.shape[1] // 2].contiguous()
                         for x in a[1][1:]), *a[2:]), "per-MB vectors"),
    "luma-larger": (lambda a: (
        (torch.zeros((MBH * 32, MBW * 16), dtype=torch.uint8), *a[0][1:]),
        (torch.zeros((MBH * 32, MBW * 16), dtype=torch.uint8), *a[1][1:]),
        *a[2:]), "per-MB vectors"),
    "another-grid": (lambda a: (
        (a[0][0],) + (torch.zeros((MBW * 8, MBH * 8), dtype=torch.uint8),) * 2,
        (a[1][0],) + (torch.zeros((MBW * 8, MBH * 8), dtype=torch.uint8),) * 2,
        *a[2:]), "are not the"),
    "v-shape": (lambda a: (a[0][:2] + (a[0][2][:-8],), *a[1:]),
                "reference planes must be contiguous"),
    "misaligned-luma": (lambda a: ((_misaligned(a[0][0]), *a[0][1:]),
                                   *a[1:]), "4-byte"),
    "misaligned-v": (lambda a: (a[0], (*a[1][:2], _misaligned(a[1][2])),
                                *a[2:]), "4-byte"),
    "non-contiguous-u": (lambda a: ((a[0][0], a[0][1].t().contiguous().t(),
                                     a[0][2]), *a[1:]),
                         "reference planes must be contiguous"),
    "non-contiguous-vector": (lambda a: (*a[:3], (torch.stack(
        [a[3][0]] * 2, 1)[:, 0], *a[3][1:]), a[4]), "per-MB vectors"),
    "five-vectors": (lambda a: (*a[:2], a[2][:5], *a[3:]), "six per-MB"),
    "two-planes": (lambda a: (a[0][:2], *a[1:]), "triples"),
    "int64-mode": (lambda a: (*a[:4], a[4].to(torch.int64)),
                   "per-MB vectors"),
}


@pytest.mark.parametrize("fault", list(YUV_FAULTS))
def test_swar_yuv_launcher_refuses(fault):
    """The picture form's launcher makes ``_launch``'s checks on all three
    components before it loads the kernel library (so they run here, on CPU
    tensors), and counts no launch."""
    ref0, ref1, meta_y, meta_c, mode, (h, w) = _yuv_case("4:2:0", 180)
    t = torch.from_numpy
    tt = lambda xs: tuple(map(t, xs))  # noqa: E731
    args = (tt(ref0), tt(ref1), tt(meta_y), tt(meta_c), t(mode))
    change, match = YUV_FAULTS[fault]
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        mc_fused._launch_yuv(*change(args), h, w, True)
    assert dict(_build.LAUNCHES) == before


def test_swar_yuv_refuses_tiles_and_other_devices():
    ref0, ref1, meta_y, meta_c, mode, _ = _yuv_case("4:4:4", 190)
    t = torch.from_numpy
    tt = lambda xs: tuple(map(t, xs))  # noqa: E731
    args = (tt(ref0), tt(ref1), tt(meta_y), tt(meta_c), t(mode))
    with pytest.raises(ValueError, match="tiles"):
        mc_fused._launch_yuv(*args, 8, 16, True)
    with pytest.raises(ValueError, match="no kernel"):
        mc_fused.fused_mc_pred_swar_yuv(
            tuple(x.to("meta") for x in args[0]), *args[1:], h=16, w=16)


def test_device_recon_swar_takes_the_picture_form_without_field_support():
    geom = PictureGeometry(width=32, height=32, chroma_format=HD.CHROMA_420)
    frame = DeviceRecon(geom, "cpu", mc_impl="swar")
    assert frame._mc_fns is mc_fused.fused_mc_pred_swar_yuv
    assert DeviceRecon(geom, "cpu", mc_impl="swar", use_kernels=False
                       )._mc_fns is mc_fused.fused_mc_pred_swar_yuv_ref
    field = DeviceRecon(geom, "cpu", field_support=True, mc_impl="swar")
    assert field._mc_fns is mc_fused.fused_mc_pred_swar_field


SIZES = [(HD.CHROMA_420, 192, 112), (HD.CHROMA_422, 320, 128),
         (HD.CHROMA_444, 192, 96)]


@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("cf,width,height", SIZES)
def test_device_recon_swar_matches_pallas(cf, width, height, field):
    """DeviceRecon(mc_impl="swar"): K7 (K8 under field support) per
    component plus the residual epilogue, against the JAX package's
    DeviceRecon on the swar Pallas path, at the sizes of
    test_pallas_kernels.py."""
    device_recon_parity("swar", cf, width, height, field, 300 + cf)


FIELD = {"fpfd": False, "allow_field_motion": True}


@pytest.mark.parametrize("cf,opts", [(HD.CHROMA_420, {}),
                                     (HD.CHROMA_422, FIELD)])
def test_decoder_under_swar_matches_jax(monkeypatch, cf, opts):
    """MP2V_MC_IMPL=swar: an IBBP stream decodes to the JAX package's YUV
    on the CPU, every recon of it swar (the 4:2:2 stream's field chunks
    included)."""
    data = ipb_stream(np.random.default_rng(5160 + cf), 2, 2, cf, **opts)
    want = JaxDecoder(JaxConfig(gop_chunk=4)).decode(data)
    monkeypatch.setenv("MP2V_MC_IMPL", "swar")
    dec = MP2VDecoder(DecoderConfig(gop_chunk=4, device="cpu"))
    got = dec.decode(data)
    assert len(got) == 5
    assert_frames_equal(want, got)
    assert {key[3] for key in dec._recons} == {"swar"}
    assert any(key[1] for key in dec._recons) == bool(opts)
