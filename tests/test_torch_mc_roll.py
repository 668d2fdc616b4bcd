"""PyTorch port, K5/K6 (``MP2V_MC_IMPL=roll``): the roll wrappers' plain
versions against the JAX package's roll Pallas kernels (interpret mode), on
planes 2-7 MBs tall with MVs past every edge, luma and each chroma tile;
the ``mc_impl`` rules; ``DeviceRecon`` and the decoder under roll.  All
comparisons are exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_mc import CHROMA, H, W, _case, _meta_both  # noqa: E402
from torch_parity import (assert_frames_equal, device_recon_parity,  # noqa: E402
                          ipb_stream)
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as HD  # noqa: E402
from tiny_mp2v_dec_tpu.ops import mc_pallas as jp  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import PictureGeometry  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import (DeviceRecon,  # noqa: E402
                                               resolve_mc_impl)


@pytest.mark.parametrize("bidir", [True, False])
def test_roll_luma_matches_pallas(bidir):
    """K5's plain version (fused_mc_recon_ref) against fused_mc_recon."""
    c = _case(81, 16, 16, H, W)
    meta = _meta_both(c, H, W, 16, 16)
    r0, r1 = c["refs"][:2]
    t = torch.from_numpy
    got = mc_fused.fused_mc_recon_roll(t(r0), t(r1), t(c["res"][0]),
                                       *map(t, meta), h=16, w=16,
                                       bidir=bidir)
    pad = lambda p: jp.pad_ref_plane(jnp.asarray(p), 16, 16)  # noqa: E731
    want = jp.fused_mc_recon(pad(r0), pad(r1), jnp.asarray(c["res"][0]),
                             *map(jnp.asarray, meta), h=16, w=16, H=H, W=W,
                             interpret=True, bidir=bidir)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("h,w", [(8, 8), (16, 8), (16, 16)])
def test_roll_uv_matches_pallas(h, w, bidir):
    """K6's plain version against fused_mc_recon_uv at every chroma tile:
    JAX's column-interleaved planes take a doubled sx, on the JAX side
    only."""
    Hc, Wc = CHROMA[(h, w)]
    c = _case(82 + h + w, h, w, Hc, Wc)
    meta = _meta_both(c, Hc, Wc, h, w)
    u0, v0, u1, v1 = c["refs"]
    t = torch.from_numpy
    gu, gv = mc_fused.fused_mc_recon_uv_roll(
        (t(u0), t(v0)), (t(u1), t(v1)), (t(c["res"][0]), t(c["res"][1])),
        *map(t, meta), h=h, w=w, bidir=bidir)
    pad = lambda u, v: jp.pad_ref_plane_uv(  # noqa: E731
        jnp.asarray(u), jnp.asarray(v), h, w)
    syf, sxf, phf, syb, sxb, phb, mode = map(jnp.asarray, meta)
    uv = np.asarray(jp.fused_mc_recon_uv(
        pad(u0, v0), pad(u1, v1),
        jp.interleave_uv(jnp.asarray(c["res"][0]), jnp.asarray(c["res"][1])),
        syf, 2 * sxf, phf, syb, 2 * sxb, phb, mode, h=h, w=w, H=Hc, W=Wc,
        interpret=True, bidir=bidir))
    np.testing.assert_array_equal(gu.numpy(), uv[:, 0::2])
    np.testing.assert_array_equal(gv.numpy(), uv[:, 1::2])


def test_roll_wrappers_refuse_field_tuples_and_take_no_kernel_on_cpu():
    """As the JAX kernels assert, the roll wrappers have no field form; on
    CPU tensors they launch nothing."""
    z8 = torch.zeros((16, 16), dtype=torch.uint8)
    z16 = torch.zeros((16, 16), dtype=torch.int16)
    meta = [torch.zeros(1, dtype=torch.int32) for _ in range(7)]
    fld = tuple(torch.zeros(1, dtype=torch.int32) for _ in range(6))
    before = dict(_build.LAUNCHES)
    assert mc_fused.fused_mc_recon_roll(z8, z8, z16, *meta).shape == (16, 16)
    u, v = mc_fused.fused_mc_recon_uv_roll((z8, z8), (z8, z8), (z16, z16),
                                           *meta, h=16, w=16)
    assert u.shape == v.shape == (16, 16)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="no field form"):
        mc_fused.fused_mc_recon_roll(z8, z8, z16, *meta, fld, fld)
    with pytest.raises(ValueError, match="no field form"):
        mc_fused.fused_mc_recon_uv_roll((z8, z8), (z8, z8), (z16, z16),
                                        *meta, fld, fld, h=16, w=16)
    with pytest.raises(ValueError, match="no kernel"):
        mc_fused.fused_mc_recon_roll(z8, z8, z16.to("meta"), *meta)


def test_mc_impl_rules(monkeypatch):
    """MP2V_MC_IMPL is the default, read when a recon is built; a roll from
    the environment becomes mxu under field support; an unknown name
    raises; an explicit roll with field support takes the plain version on
    the CPU and is refused on any other device."""
    geom = PictureGeometry(width=32, height=32, chroma_format=HD.CHROMA_420)
    monkeypatch.delenv("MP2V_MC_IMPL", raising=False)
    assert resolve_mc_impl(None, False) == "mxu"
    assert DeviceRecon(geom, "cpu").mc_impl == "mxu"
    monkeypatch.setenv("MP2V_MC_IMPL", "roll")
    assert DeviceRecon(geom, "cpu").mc_impl == "roll"
    assert DeviceRecon(geom, "cpu", field_support=True).mc_impl == "mxu"
    assert resolve_mc_impl("swar", False) == "swar"
    monkeypatch.setenv("MP2V_MC_IMPL", "swar")
    assert DeviceRecon(geom, "cpu", field_support=True).mc_impl == "swar"
    monkeypatch.setenv("MP2V_MC_IMPL", "fast")
    with pytest.raises(ValueError, match="fast"):
        DeviceRecon(geom, "cpu")
    with pytest.raises(ValueError, match="pallas"):
        resolve_mc_impl("pallas", False)
    explicit = DeviceRecon(geom, "cpu", field_support=True, mc_impl="roll")
    assert explicit.mc_impl == "roll"
    assert explicit._mc_fns is mc_fused.fused_mc_recon_blocks_group_ref
    with pytest.raises(ValueError, match="roll"):
        DeviceRecon(geom, "meta", field_support=True, mc_impl="roll")


SIZES = [(HD.CHROMA_420, 192, 112), (HD.CHROMA_422, 320, 128),
         (HD.CHROMA_444, 192, 96)]


@pytest.mark.parametrize("cf,width,height", SIZES)
def test_device_recon_roll_matches_pallas(cf, width, height):
    """DeviceRecon(mc_impl="roll"), frame prediction: K5 and K6 against the
    JAX package's DeviceRecon on the roll Pallas path, at the sizes of
    test_pallas_kernels.py."""
    device_recon_parity("roll", cf, width, height, False, 400 + cf)


@pytest.mark.parametrize("cf,width,height", SIZES)
def test_device_recon_explicit_roll_with_field_support(cf, width, height):
    """An explicit roll with field support on the CPU (the plain version)
    equals the JAX package's recon of the same, which takes its XLA
    gather."""
    device_recon_parity("roll", cf, width, height, True, 410 + cf)


FIELD = {"fpfd": False, "allow_field_motion": True}


@pytest.mark.parametrize("cf,opts,impls", [
    (HD.CHROMA_420, {}, {"roll"}),
    (HD.CHROMA_422, FIELD, {"roll", "mxu"}),
])
def test_decoder_under_roll_matches_jax(monkeypatch, cf, opts, impls):
    """MP2V_MC_IMPL=roll: an IBBP stream decodes to the JAX package's YUV
    on the CPU; frame chunks take roll recons and, as in the JAX package,
    chunks with field MBs take mxu recons."""
    data = ipb_stream(np.random.default_rng(5170 + cf), 2, 2, cf, **opts)
    want = JaxDecoder(JaxConfig(gop_chunk=2)).decode(data)
    monkeypatch.setenv("MP2V_MC_IMPL", "roll")
    dec = MP2VDecoder(DecoderConfig(gop_chunk=2, device="cpu"))
    got = dec.decode(data)
    assert len(got) == 5
    assert_frames_equal(want, got)
    assert {key[3] for key in dec._recons} == impls
    assert all((impl == "mxu") == fs for _, fs, _, impl in dec._recons)
