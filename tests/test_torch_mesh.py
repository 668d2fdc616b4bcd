"""PyTorch port, the multi-device paths on the CPU: row sharding
(``DecoderConfig(mesh="rows")``, ``RowShardedRecon``, the band forms of
the MC wrappers) and serving (``StreamBatchRecon``,
``MP2VDecoder.decode_batch``), against the JAX package on conftest's 8
virtual CPU devices and against the golden model.

The port runs with ``device="cpu"``: its meshes repeat the one CPU device
(``make_mesh``), so 8 bands or 2 stream shards run in turn on it, and every
kernel wrapper takes its plain version.  All comparisons are exact: every
path is integer arithmetic."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_mesh_recon import _stream  # noqa: E402
from torch_parity import assert_frames_equal, ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import GoldenDecoder  # noqa: E402
from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon as JaxRecon  # noqa: E402
from tiny_mp2v_dec_tpu.parallel import mesh as jmesh  # noqa: E402
from tiny_mp2v_dec_tpu.tokenizer.types import \
    PictureGeometry as JaxGeom  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import PictureGeometry  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from tiny_mp2v_dec_tpu_torch.runtime.decoder import PlanesFrame  # noqa
from tiny_mp2v_dec_tpu_torch.tokenizer.types import \
    PictureTokens  # noqa: E402

N_DEV = 8
FIELD = {"fpfd": False, "allow_field_motion": True}
# (stream, MP2V_MC_IMPL) pairs of the row-sharded decodes: every
# implementation with a kernel for the stream (roll has no field form)
ROW_CASES = [("420", "mxu"), ("420", "roll"), ("420", "swar"),
             ("422_field", "mxu"), ("422_field", "swar")]
# (MC implementation, field support) of the band tests
BAND_CASES = [("mxu", False), ("mxu", True), ("roll", False),
              ("swar", False), ("swar", True)]
# the heterogeneous GOPs of test_mesh_recon's stream-batch test
PATTERNS = [
    (H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_P, H.PCT_B),
    (H.PCT_I, H.PCT_B, H.PCT_B, H.PCT_P),
    (H.PCT_I, H.PCT_I, H.PCT_P),
    (H.PCT_I, H.PCT_P, H.PCT_P, H.PCT_P, H.PCT_B, H.PCT_B),
]


def _port(impl, monkeypatch, **cfg):
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    return MP2VDecoder(DecoderConfig(device="cpu", **cfg))


def _port_tokens(t: "jmesh.PictureTokens") -> PictureTokens:
    """The port's PictureTokens holding the same arrays as the JAX
    package's ``t``."""
    g = t.geom
    return PictureTokens(
        geom=PictureGeometry(width=g.width, height=g.height,
                             chroma_format=g.chroma_format),
        **{k: getattr(t, k) for k in (
            "cblk", "cblk_idx", "intra", "fwd", "bwd", "field_pred",
            "dct_type", "mv", "mvfs", "coded", "row_nnz")},
        n_coded_blocks=t.n_coded_blocks)


def _planes(rng, geom, lead=()):
    return [rng.integers(0, 256, lead + s).astype(np.uint8)
            for s in (geom.luma_padded, geom.chroma_padded,
                      geom.chroma_padded)]


def _assert_planes(got, want):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"plane {c}")


# ----------------------------------------------------------------------
# devices


def test_make_mesh_repeats_the_devices():
    cpu = torch.device("cpu")
    assert pmesh.make_mesh(device="cpu") == [cpu]
    assert pmesh.make_mesh(3, device="cpu") == [cpu] * 3
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, device="cpu")


def test_make_mesh_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(4)


def test_padding_helpers_match_jax():
    """The row padding of geometry and tokens is the JAX package's."""
    geom = JaxGeom(64, 80, H.CHROMA_420)
    t = jmesh.random_tokens(np.random.default_rng(3), geom)
    gp = jmesh.pad_geometry_rows(geom, 4)
    pg = pmesh.pad_geometry_rows(PictureGeometry(64, 80, 1), 4)
    assert (pg.width, pg.height, pg.mb_height) == (gp.width, gp.height, 8)
    want = jmesh.pad_tokens_rows(t, gp)
    got = pmesh.pad_tokens_rows(_port_tokens(t), pg)
    assert got.geom == pg and got.n_coded_blocks == want.n_coded_blocks
    for k in ("intra", "fwd", "bwd", "field_pred", "dct_type", "mv", "mvfs",
              "coded", "cblk", "cblk_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


# ----------------------------------------------------------------------
# row sharding


@pytest.fixture(scope="module")
def row_streams():
    """test_mesh_recon's 4x8-MB stream (one MB row a band at 8 bands, so
    every vertical MV crosses bands) and a field-predicted 4:2:2 stream of
    the same size; each with the JAX package's row-sharded decode on 8
    devices and the golden model's."""
    out = {"420": _stream(1),
           "422_field": ipb_stream(np.random.default_rng(1729), 4, 8,
                                   H.CHROMA_422, **FIELD)}
    ref = {}
    for name, data in out.items():
        jax_frames = JaxDecoder(JaxConfig(
            mesh="rows", mesh_devices=N_DEV)).decode(data)
        golden = GoldenDecoder().decode(data)
        assert_frames_equal(jax_frames, golden)
        ref[name] = (data, jax_frames)
    return ref


@pytest.mark.parametrize("name,impl", ROW_CASES)
def test_row_sharded_decoder_equals_jax_and_golden(row_streams, monkeypatch,
                                                   name, impl):
    data, want = row_streams[name]
    dec = _port(impl, monkeypatch, mesh="rows", mesh_devices=N_DEV)
    got = dec.decode(data)
    assert all(isinstance(f, PlanesFrame) for f in got)
    assert_frames_equal(got, want)
    recons = dec._mesh_recons.values()
    assert all(r.n_shards == N_DEV and r.mbh_local == 1 for r in recons)
    assert {r.inner.mc_impl for r in recons} == {impl}
    # the field stream's inter pictures take the field recon
    assert any(r.inner.field_support for r in recons) == (name != "420")
    assert not dec._recons        # the chunk path never ran


def test_rows_take_precedence_over_gop_chunk(row_streams, monkeypatch):
    data, want = row_streams["420"]
    dec = _port("mxu", monkeypatch, mesh="rows", mesh_devices=4,
                gop_chunk=4, output_host=False)
    got = dec.decode(data)
    assert_frames_equal(got, want)
    assert not dec._recons and dec._fill_pool is None


@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_padded_rows_decode_equals_jax(monkeypatch, impl):
    """mb_height 5 on 4 bands: geometry and tokens padded to 8 MB rows, as
    the JAX package pads them."""
    data = ipb_stream(np.random.default_rng(55), 4, 5, H.CHROMA_420)
    want = JaxDecoder(JaxConfig(mesh="rows", mesh_devices=4)).decode(data)
    assert_frames_equal(want, GoldenDecoder().decode(data))
    dec = _port(impl, monkeypatch, mesh="rows", mesh_devices=4)
    assert_frames_equal(dec.decode(data), want)
    (recon,) = dec._mesh_recons.values()
    assert recon.geom.mb_height == 8 and recon.mbh_local == 2


@pytest.fixture(scope="module")
def padded_case():
    """Random tokens (MVs up to 32 pixels, so windows reach below the
    picture) at 4x5 MBs and random references at the 8-row padded
    geometry with zero rows below the picture, through the JAX package's
    RowShardedRecon on 4 devices and its whole-picture DeviceRecon."""
    rng = np.random.default_rng(7)
    geom = JaxGeom(64, 80, H.CHROMA_420)
    t = jmesh.random_tokens(rng, geom)
    refs = _planes(rng, jmesh.pad_geometry_rows(geom, 4))
    for r, rows in zip(refs, (80, 40, 40)):
        r[rows:] = 0
    rows = jmesh.RowShardedRecon(geom, jmesh.make_mesh(4, axes=("row",)))
    mesh_out = rows(t, tuple(map(jnp.asarray, refs)), None)
    whole = JaxRecon(geom)(t, tuple(jnp.asarray(r[:n]) for r, n in zip(
        refs, (80, 40, 40))), None)
    return t, refs, mesh_out, whole


@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_padded_rows_recon_equals_jax(padded_case, impl):
    t, refs, want, _ = padded_case
    recon = pmesh.RowShardedRecon(PictureGeometry(64, 80, 1),
                                  pmesh.make_mesh(4, device="cpu"),
                                  mc_impl=impl)
    got = recon(_port_tokens(t), tuple(map(torch.from_numpy, refs)), None)
    _assert_planes([g.numpy() for g in got], want)


def test_padded_rows_move_the_clamp_in_jax(padded_case):
    """The JAX package's padded mesh clamps windows to the padded height:
    where a vector reaches below the picture (never in a conforming
    stream, whose vectors stay inside it), a band reads the zero rows
    below it and the picture differs from the whole-picture
    reconstruction — in Y first (ROADMAP Queue 3).  The port reproduces
    the JAX mesh (the test above)."""
    _, _, mesh_out, whole = padded_case
    assert not np.array_equal(np.asarray(mesh_out[0])[:80],
                              np.asarray(whole[0]))


def _moved_mbs(geom, tokens, padded):
    """Per MB, whether the row-padded geometry ``padded`` moves any of its
    window starts or phases in any component: the MBs whose vectors reach
    below the picture, where the padded clamp height applies."""
    def vecs(t):
        return [torch.from_numpy(np.ascontiguousarray(getattr(t, k)))
                for k in ("dct_type", "fwd", "bwd", "field_pred", "coded",
                          "mv", "mvfs")]
    n = geom.n_mb
    moved = torch.zeros(n, dtype=torch.bool)
    for comp in range(3):
        whole = _swar_meta(geom, vecs(tokens), comp, False)[0]
        pad = _swar_meta(padded, vecs(pmesh.pad_tokens_rows(tokens, padded)),
                         comp, False)[0]
        for a, b in zip(whole, pad):
            moved |= a != b[:n]
    return moved


def _differing_mbs(got, want, h, w):
    mbh, mbw = want.shape[0] // h, want.shape[1] // w
    return (got[:mbh * h] != want).reshape(mbh, h, mbw, w).any(3).any(
        1).reshape(-1)


@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_row_bands_against_the_ports_whole_picture(padded_case, impl):
    """The port's row mesh against its own whole-picture recon
    (``DeviceRecon.__call__``) on ``padded_case``'s tokens and references:
    5 bands, which divide the 5 MB rows, equal it; 4 bands (padded to 8
    rows, so the clamp height is the padded one, the JAX mesh's fault in
    ROADMAP Queue 3) differ from it in Y, and only in MBs whose window
    starts the padded clamp moves."""
    t, refs, _, _ = padded_case
    geom = PictureGeometry(64, 80, 1)
    tokens = _port_tokens(t)
    rows = (80, 40, 40)
    crop = tuple(torch.from_numpy(np.ascontiguousarray(r[:n]))
                 for r, n in zip(refs, rows))
    whole = DeviceRecon(geom, "cpu", mc_impl=impl)(tokens, crop, None)
    five = pmesh.RowShardedRecon(geom, pmesh.make_mesh(5, device="cpu"),
                                 mc_impl=impl)
    assert five.geom.mb_height == 5
    _assert_planes(five(tokens, crop, None), whole)
    four = pmesh.RowShardedRecon(geom, pmesh.make_mesh(4, device="cpu"),
                                 mc_impl=impl)
    got = four(tokens, tuple(map(torch.from_numpy, refs)), None)
    moved = _moved_mbs(geom, tokens, four.geom)
    for c, (g, w) in enumerate(zip(got, whole)):
        h = 16 if c == 0 else 8
        diff = _differing_mbs(g, w, h, h)
        assert not (diff & ~moved).any(), f"plane {c}"
        if c == 0:
            assert diff.any()


# ----------------------------------------------------------------------
# bands against the whole picture


def _band_inputs(seed, cf, field, mbw=4, mbh=6):
    rng = np.random.default_rng(seed)
    geom = PictureGeometry(width=16 * mbw, height=16 * mbh, chroma_format=cf)
    jg = JaxGeom(16 * mbw, 16 * mbh, cf)
    t = jmesh.random_tokens(rng, jg)
    n = geom.n_mb
    t.dct_type[:] = rng.random(n) < 0.3
    if field:
        t.field_pred[:] = ~t.intra & (rng.random(n) < 0.5)
        t.mvfs[:] = rng.integers(0, 2, t.mvfs.shape)
    residual = rng.integers(-300, 300, (n, geom.blocks_per_mb, 8, 8)).astype(
        np.int16)
    vecs = [t.dct_type, t.fwd, t.bwd, t.field_pred, t.coded, t.mv, t.mvfs]
    refs = _planes(rng, geom) * 2
    return geom, torch.from_numpy(residual), [
        torch.from_numpy(np.ascontiguousarray(v)) for v in vecs], [
        torch.from_numpy(r) for r in refs]


def _meta_rows(vecs, field):
    """The vectors of :func:`_band_inputs` packed as the chunk blob's
    metadata rows (the port's ``pack_meta2``)."""
    from types import SimpleNamespace

    from tiny_mp2v_dec_tpu_torch.ops.recon import pack_meta2
    names = ("dct_type", "fwd", "bwd", "field_pred", "coded", "mv", "mvfs")
    t = SimpleNamespace(**{k: v.numpy() for k, v in zip(names, vecs)})
    t.geom = SimpleNamespace(n_mb=len(t.fwd))
    return torch.from_numpy(pack_meta2(t, field))


@pytest.mark.parametrize("cf", [H.CHROMA_420, H.CHROMA_422])
@pytest.mark.parametrize("impl,field", BAND_CASES)
def test_band_equals_rows_of_the_whole_picture(impl, field, cf):
    """Each band of 2 MB rows of a 6-row picture reconstructs to the same
    rows of the whole-picture reconstruction, for every MC implementation
    and both metadata forms (the field form with field-predicted MBs)."""
    geom, residual, vecs, refs = _band_inputs(100 + cf, cf, field)
    dense, meta = residual.reshape(-1, 64), _meta_rows(vecs, field)
    recon = DeviceRecon(geom, "cpu", field_support=field, mc_impl=impl)
    whole = recon._recon_from_residual(dense, meta, *refs)
    mbw, per, bpm = geom.mb_width, 2, geom.blocks_per_mb
    for row0 in range(0, geom.mb_height, per):
        sl = slice(row0 * mbw, (row0 + per) * mbw)
        band = recon._recon_from_residual(
            dense[sl.start * bpm:sl.stop * bpm], meta[sl], *refs,
            band=(row0, per))
        for c, (b, w) in enumerate(zip(band, whole)):
            h = b.shape[0]
            assert h == w.shape[0] * per // geom.mb_height
            assert torch.equal(b, w[row0 // per * h:(row0 // per + 1) * h]), \
                f"band {row0} plane {c}"


def _swar_meta(geom, vecs, comp, field):
    """Whole-picture vectors of component ``comp`` as the recon's swar
    path derives them (``mc_fused.blocks_to_vectors`` on the metadata rows):
    ((syf, sxf, phf, syb, sxb, phb), mode, field tuples, tile)."""
    meta = _meta_rows(vecs, field)
    dense = torch.zeros((meta.shape[0] * geom.blocks_per_mb, 64),
                        dtype=torch.int16)
    shape = geom.luma_padded if comp == 0 else geom.chroma_padded
    _, v, h, w = mc_fused.blocks_to_vectors(
        torch.zeros(shape, dtype=torch.uint8), dense, meta,
        geom.chroma_format, geom.mb_width, uv=comp != 0)
    return tuple(v[:6]), v[6], v[7:] if field else None, (h, w)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("form", ["component", "field", "picture"])
def test_swar_band_output_equals_rows_of_the_whole(form, bidir):
    """K7's and K8's wrappers and plain versions given ``H`` below the
    reference's height: a band's words equal the same rows of the whole
    picture's, on the CPU (the plain versions)."""
    field = form == "field"
    geom, _, vecs, refs = _band_inputs(7, H.CHROMA_422, field)
    mbw, row0, per = geom.mb_width, 2, 3
    sl = slice(row0 * mbw, (row0 + per) * mbw)
    fns = {"component": (mc_fused.fused_mc_pred_swar,
                         mc_fused.fused_mc_pred_swar_ref),
           "field": (mc_fused.fused_mc_pred_swar_field,
                     mc_fused.fused_mc_pred_swar_field_ref)}
    if form == "picture":
        (fy, mode, _, _), (fc, _, _, (h, w)) = (
            _swar_meta(geom, vecs, 0, False), _swar_meta(geom, vecs, 1,
                                                         False))
        args = (refs[:3], refs[3:])
        whole = mc_fused.fused_mc_pred_swar_yuv_ref(
            *args, fy, fc, mode, h=h, w=w, bidir=bidir)
        bands = [fn(*args, [v[sl] for v in fy], [v[sl] for v in fc],
                    mode[sl], h=h, w=w, bidir=bidir, H=per * 16)
                 for fn in (mc_fused.fused_mc_pred_swar_yuv,
                            mc_fused.fused_mc_pred_swar_yuv_ref)]
        for band in bands:
            for c, (b, wh) in enumerate(zip(band, whole)):
                th = 16 if c == 0 else h
                assert b.shape == (per * th, wh.shape[1])
                assert torch.equal(b, wh[row0 * th:(row0 + per) * th])
        return
    for comp in (0, 1):
        frame, mode, flds, (h, w) = _swar_meta(geom, vecs, comp, field)
        r0, r1 = refs[comp], refs[3 + comp]
        extra = (*flds,) if field else ()
        wrapper, plain = fns[form]
        whole = plain(r0, r1, *frame, mode, *extra, h=h, w=w, bidir=bidir)
        assert whole.shape == (r0.shape[0], r0.shape[1] // 4)
        cut = lambda x: x[sl]  # noqa: E731
        for fn in (wrapper, plain):
            band = fn(r0, r1, *map(cut, frame), mode[sl],
                      *(tuple(map(cut, f)) for f in extra), h=h, w=w,
                      bidir=bidir, H=per * h)
            assert torch.equal(band, whole[row0 * h:(row0 + per) * h])


def test_swar_launches_size_the_band(monkeypatch):
    """The card path of the SWAR wrappers, up to the launch (``_call``
    recorded instead of run): a band's outputs and MB count come from
    ``H``, the clamp height from the reference, and per-MB vectors of the
    whole picture are refused for a band."""
    calls = []
    monkeypatch.setattr(mc_fused, "_call", lambda *a: calls.append(a))
    geom, _, vecs, refs = _band_inputs(9, H.CHROMA_420, False)
    mbw, row0, per = geom.mb_width, 1, 2
    sl = slice(row0 * mbw, (row0 + per) * mbw)
    fy, mode, _, _ = _swar_meta(geom, vecs, 0, False)
    fc, _, _, (h, w) = _swar_meta(geom, vecs, 1, False)
    outs = mc_fused._launch_yuv(tuple(refs[:3]), tuple(refs[3:]),
                                tuple(v[sl] for v in fy),
                                tuple(v[sl] for v in fc), mode[sl], h, w,
                                True, per * 16)
    assert [tuple(o.shape) for o in outs] == [(32, 16), (16, 8), (16, 8)]
    (entry, counter, _, th, tw, n_mb, mb_w, Hr, Wr, _, _), = calls
    assert (entry, th, tw, n_mb, mb_w, Hr, Wr) == (
        "mp2v_mc_swar_yuv", h, w, per * mbw, mbw, 96, 64)
    out = mc_fused._launch("mp2v_mc_swar_field", "mc_swar_field",
                           (refs[0],), (refs[3],), (),
                           (*(v[sl] for v in fy), mode[sl],
                            *(v[sl] for v in fy + fy)), 16, 16, True,
                           per * 16)[0]
    assert out.shape == (32, 16) and calls[-1][5:9] == (per * mbw, mbw, 96,
                                                       64)
    with pytest.raises(ValueError, match="per-MB vectors"):
        mc_fused._launch_yuv(tuple(refs[:3]), tuple(refs[3:]), fy, fc, mode,
                             h, w, True, per * 16)
    with pytest.raises(ValueError, match="whole MB rows"):
        mc_fused._launch_yuv(tuple(refs[:3]), tuple(refs[3:]), fy, fc, mode,
                             h, w, True, 24)


# ----------------------------------------------------------------------
# one picture, and the stream batch


@pytest.mark.parametrize("impl", ["mxu", "swar"])
def test_device_recon_call_equals_jax(impl):
    """``DeviceRecon.__call__`` (through a chunk-1 GopRecon) equals the JAX
    package's on a tokenized B picture with given references."""
    data = _stream(17)
    seq = JaxDecoder(JaxConfig(num_threads=1)).tokenize_stream(data)
    tokens, geom = seq[2][0], seq[2][1]
    assert seq[2][2].picture_coding_type == H.PCT_B
    rng = np.random.default_rng(17)
    r0, r1 = _planes(rng, geom), _planes(rng, geom)
    want = JaxRecon(geom, field_support=False)(
        tokens, tuple(map(jnp.asarray, r0)), tuple(map(jnp.asarray, r1)))
    recon = DeviceRecon(_port_tokens(tokens).geom, "cpu", mc_impl=impl)
    got = recon(_port_tokens(tokens), tuple(map(torch.from_numpy, r0)),
                tuple(map(torch.from_numpy, r1)))
    _assert_planes([g.numpy() for g in got], want)


@pytest.fixture(scope="module")
def i_streams():
    """test_mesh_recon's 8 one-I-picture streams, tokenized."""
    dec = JaxDecoder(JaxConfig(num_threads=1))
    toks = []
    for i in range(N_DEV):
        dec.reset()
        toks.append(dec.tokenize_stream(_stream(200 + i,
                                                pcts=(H.PCT_I,)))[0][0])
    return toks


@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_stream_batch_rows_equal_device_recon(i_streams, impl):
    """StreamBatchRecon over 8 shards: each stream's row equals
    ``DeviceRecon.__call__`` of its picture."""
    toks = [_port_tokens(t) for t in i_streams]
    geom = toks[0].geom
    sb = pmesh.StreamBatchRecon(geom, pmesh.make_mesh(N_DEV, "cpu"),
                                mc_impl=impl)
    assert sb.n_streams == N_DEV and sb.s_local == 1
    y, u, v = sb(toks)
    single = DeviceRecon(geom, "cpu", mc_impl=impl)
    for i, t in enumerate(toks):
        _assert_planes([y[i], u[i], v[i]], single(t))


def test_stream_batch_step_equals_jax():
    """One step of 4 streams on 2 shards with mixed picture types (B, I/P)
    and random stacked references: the reference update and the planes
    equal the JAX package's StreamBatchRecon.step."""
    rng = np.random.default_rng(23)
    geom = JaxGeom(64, 48, H.CHROMA_420)
    toks = [jmesh.random_tokens(rng, geom) for _ in range(4)]
    for t in toks[2:]:            # I/P pictures carry no backward bit
        t.bwd[:] = False
    refs0, refs1 = _planes(rng, geom, (4,)), _planes(rng, geom, (4,))
    is_b = [True, True, False, False]
    is_ip = [not b for b in is_b]
    jsb = jmesh.StreamBatchRecon(geom, jmesh.make_mesh(2, axes=("stream",)),
                                 n_streams=4)
    want = jsb.step(toks, is_b, is_ip, tuple(map(jnp.asarray, refs0)),
                    tuple(map(jnp.asarray, refs1)))
    psb = pmesh.StreamBatchRecon(PictureGeometry(64, 48, 1),
                                 pmesh.make_mesh(2, device="cpu"),
                                 n_streams=4)
    got = psb.step([_port_tokens(t) for t in toks], is_b, is_ip,
                   tuple(map(torch.from_numpy, refs0)),
                   tuple(map(torch.from_numpy, refs1)))
    for g, w in zip(got, want):
        _assert_planes([x.numpy() for x in g], w)
    with pytest.raises(ValueError, match="complement"):
        psb.step([_port_tokens(t) for t in toks], is_b, is_b)
    with pytest.raises(ValueError, match="divide"):
        pmesh.StreamBatchRecon(PictureGeometry(64, 48, 1),
                               pmesh.make_mesh(3, device="cpu"),
                               n_streams=4)


# ----------------------------------------------------------------------
# decode_batch


def _hetero_streams(n=8):
    return [_stream(300 + i, pcts=PATTERNS[i % 4], n_pics=len(PATTERNS[i % 4]))
            for i in range(n)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"stream {i}"
        assert_frames_equal(g, w)


@pytest.mark.parametrize("reordering", [True, False])
def test_decode_batch_heterogeneous_gops_equals_jax(monkeypatch, reordering):
    """8 streams with four GOP structures and lengths (the shorter padded
    with no-op pictures) on 8 shards, one stream each."""
    streams = _hetero_streams()
    want = JaxDecoder(JaxConfig(reordering=reordering)).decode_batch(streams)
    before = {t.name for t in threading.enumerate()}
    dec = _port("mxu", monkeypatch, mesh_devices=N_DEV,
                reordering=reordering)
    got = dec.decode_batch(streams)
    _assert_batches_equal(got, want)
    assert dec.stats["pictures"] == sum(len(p) for p in PATTERNS) * 2
    # the tokenizer shells started no fill or dispatch thread
    new = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith(("mp2v-fill", "mp2v-dispatch")) for n in new)


@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_decode_batch_mixed_geometry_groups_equal_jax(monkeypatch, impl):
    """Streams of three geometries, one of them field-predicted 4:2:2,
    grouped per geometry and mapped back to their order."""
    streams = [_stream(400, mbw=4, mbh=8), _stream(401, mbw=6, mbh=4),
               _stream(402, mbw=4, mbh=8),
               ipb_stream(np.random.default_rng(403), 3, 2, H.CHROMA_422,
                          **FIELD)]
    want = JaxDecoder(JaxConfig()).decode_batch(streams)
    dec = _port(impl, monkeypatch)
    _assert_batches_equal(dec.decode_batch(streams), want)
    # ("streams", geometry, field support, streams, shards, MC impl)
    keys = {(k[1].width, k[1].height): k[2:5] for k in dec._mesh_recons}
    assert keys == {(64, 128): (False, 2, 1), (96, 64): (False, 1, 1),
                    (48, 32): (True, 1, 1)}


@pytest.mark.parametrize("output_host", [True, False])
def test_decode_batch_pads_the_stream_axis(monkeypatch, output_host):
    """5 streams on 2 shards: the port pads the batch to 6 streams with a
    no-op stream (the JAX package takes 1 shard, the largest divisor of 5
    up to 2) and decodes the same frames."""
    streams = _hetero_streams(5)
    want = JaxDecoder(JaxConfig(mesh_devices=2)).decode_batch(streams)
    dec = _port("mxu", monkeypatch, mesh_devices=2, output_host=output_host)
    got = dec.decode_batch(streams)
    _assert_batches_equal(got, want)
    (key,) = dec._mesh_recons
    assert key[3:5] == (6, 2)
    recon = dec._mesh_recons[key]
    assert recon.s_local == 3 and len(recon.devices) == 2
    assert all(isinstance(f, PlanesFrame) for fl in got for f in fl)


def test_decode_batch_refuses_empty_input():
    dec = MP2VDecoder(DecoderConfig(device="cpu"))
    with pytest.raises(ValueError, match="no streams"):
        dec.decode_batch([])
    with pytest.raises(ValueError, match="no pictures"):
        dec.decode_batch([_stream(1), b"\x00\x00\x01\xb7"])
