"""PyTorch port, K7/K8 (``MP2V_MC_IMPL=swar``): the word helpers, the
packed-word plain versions against the JAX package's SWAR Pallas kernels
(interpret mode) and against the port's unpacked gather, on planes 2-7 MBs
tall with MVs past every edge, luma and each chroma tile; then
``DeviceRecon`` and the decoder under swar.  All comparisons are exact."""
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
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402

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
