"""PyTorch port, the streams of the JAX suite that the other port tests do
not decode, on the CPU at ``gop_chunk`` 0 (one picture at a time, on the
caller's thread) and 4 (the three-thread chunk pipeline): corrupt slices
under ``on_error="drop_slice"`` and ``"raise"``
(``tests/test_error_containment.py``), natural content
(``tests/test_reference_bitexact.py``), the conformance-policy streams
(``tests/test_conformance_policy.py``), ``reordering=False``, the renderer
and user data (``tests/test_runtime_decoder.py``) and the generated motion
vector patterns (``tests/test_stream_conformance.py``).

Where a JAX test builds its streams inside the test and checks what the
spec expects, that test itself runs on the port: its decoder is swapped
for the port's, which is held frame for frame against the golden model on
the way.  Every decode of the port runs under
:func:`torch_parity.watchdog`."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_conformance_policy as conformance  # noqa: E402
import test_runtime_decoder as runtime  # noqa: E402
from m2v_encoder import encode_stream, random_picture  # noqa: E402
from natural_m2v import natural_stream  # noqa: E402
from test_error_containment import _corrupt_slice, _stream  # noqa: E402
from test_stream_conformance import _check_windows  # noqa: E402
from torch_parity import assert_frames_equal, watchdog  # noqa: E402
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402
from tiny_mp2v_dec_tpu_torch import (  # noqa: E402
    DecoderConfig, MP2VDecoder, fixtures)
from torch_parity import ipb_stream  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHUNKS = [0, 4]
# (seed, decode-order picture types, picture, slice) of each corruption of
# test_error_containment: a B picture's slice 3, another's slice 1 (the
# rows test), the second B of the first sub-GOP (the gop_chunk test)
DROPS = [(5, "IPBBP", 2, 3), (9, "IPBBP", 2, 1), (11, "IPBBPBB", 3, 2)]


def _port(**kw):
    return MP2VDecoder(DecoderConfig(device="cpu", **kw))


@pytest.mark.parametrize("gop_chunk", CHUNKS)
@pytest.mark.parametrize("num_threads", [1, 2])
@pytest.mark.parametrize("seed,pattern,pic,bad", DROPS)
def test_drop_slice_matches_jax(seed, pattern, pic, bad, num_threads,
                                gop_chunk):
    data, _ = _stream(seed=seed, pattern=pattern)
    corrupt = _corrupt_slice(data, pic, bad)
    opts = dict(num_threads=num_threads, gop_chunk=gop_chunk,
                on_error="drop_slice")
    jax_dec = JaxDecoder(JaxConfig(**opts))
    want = jax_dec.decode(corrupt)
    dec = _port(**opts)
    got = watchdog(lambda: dec.decode(corrupt))
    assert_frames_equal(want, got)
    assert ([f.temporal_reference for f in got]
            == [f.temporal_reference for f in want])
    assert dec.stats["bad_slices"] == jax_dec.stats["bad_slices"] >= 1


@pytest.mark.parametrize("gop_chunk", CHUNKS)
@pytest.mark.parametrize("seed,pattern,pic,bad", DROPS)
def test_raise_matches_jax(seed, pattern, pic, bad, gop_chunk):
    """``on_error="raise"`` on the same streams: the JAX decoder's
    ``ValueError``, message and all."""
    data, _ = _stream(seed=seed, pattern=pattern)
    corrupt = _corrupt_slice(data, pic, bad)
    with pytest.raises(ValueError) as want:
        JaxDecoder(JaxConfig(gop_chunk=gop_chunk)).decode(corrupt)
    with pytest.raises(ValueError) as got:
        watchdog(lambda: _port(gop_chunk=gop_chunk).decode(corrupt))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def natural():
    """test_reference_bitexact's natural content and its golden decode."""
    data = natural_stream(seed=7, mbw=20, mbh=12, n_pics=8)
    return data, decode_stream(data)


@pytest.mark.parametrize("gop_chunk", CHUNKS)
def test_natural_content_matches_golden(natural, gop_chunk):
    data, want = natural
    got = watchdog(lambda: _port(gop_chunk=gop_chunk).decode(data))
    assert len(got) == 8
    assert_frames_equal(want, got)


CONFORMANCE = ["test_cmv_single_vector_cursor_integrity",
               "test_cmv_updates_predictors_and_skips_reset",
               "test_intra_first_ac_normal_table_vs_spec_idct",
               "test_intra_dc_only_block_immediate_eob"]


@pytest.mark.parametrize("gop_chunk", CHUNKS)
@pytest.mark.parametrize("name", CONFORMANCE)
def test_conformance_policy_on_port(monkeypatch, name, gop_chunk):
    """The JAX test ``name`` with the port as its decoder: concealment
    vectors keep the parse in sync and move the predictors, and intra
    blocks take the normal first-coefficient table, as the spec says."""
    def decode(data):
        got = watchdog(lambda: _port(gop_chunk=gop_chunk).decode(data))
        assert_frames_equal(decode_stream(data), got)
        return got

    monkeypatch.setattr(conformance, "_decode", decode)
    getattr(conformance, name)()


RUNTIME = ["test_runtime_no_reordering_and_renderer_callback",
           "test_runtime_decoder_reuse", "test_user_data_captured"]


@pytest.mark.parametrize("gop_chunk", CHUNKS)
@pytest.mark.parametrize("name", RUNTIME)
def test_runtime_decoder_options_on_port(monkeypatch, name, gop_chunk):
    """The JAX test ``name`` with the port's decoder and config in its
    place: decode order with ``reordering=False`` and one renderer call a
    frame, a decoder reused after ``reset``, user data captured verbatim
    and the spliced stream decoded as the golden model decodes it."""
    def config(**kw):
        return DecoderConfig(device="cpu", gop_chunk=gop_chunk, **kw)

    class Decoder(MP2VDecoder):
        def decode(self, data):
            return watchdog(lambda: MP2VDecoder.decode(self, data))

    monkeypatch.setattr(runtime, "DecoderConfig", config)
    monkeypatch.setattr(runtime, "MP2VDecoder", Decoder)
    getattr(runtime, name)()


@pytest.mark.parametrize("gop_chunk", CHUNKS)
def test_no_reordering_renderer_matches_jax(gop_chunk):
    """``reordering=False`` with a renderer: the port renders the frames
    it returns, in the JAX decoder's order, equal to JAX's."""
    data = runtime._random_ipb_stream(np.random.default_rng(31), 2, 2,
                                      H.CHROMA_420)
    jax_seen, seen = [], []
    want = JaxDecoder(JaxConfig(reordering=False, gop_chunk=gop_chunk),
                      renderer=jax_seen.append).decode(data)
    got = watchdog(lambda: MP2VDecoder(
        DecoderConfig(reordering=False, gop_chunk=gop_chunk, device="cpu"),
        renderer=seen.append).decode(data))
    assert_frames_equal(want, got)
    assert seen == got
    assert ([f.temporal_reference for f in seen]
            == [f.temporal_reference for f in jax_seen] == [0, 2, 1, 4, 3])


@pytest.mark.parametrize("gop_chunk", CHUNKS)
@pytest.mark.parametrize("pct_pattern,cf,fpfd,field", [
    ([H.PCT_I, H.PCT_P, H.PCT_B, H.PCT_B, H.PCT_P], H.CHROMA_420, True,
     False),
    ([H.PCT_I, H.PCT_P, H.PCT_B], H.CHROMA_422, False, True),
])
def test_generated_mvs_in_frame_on_port(pct_pattern, cf, fpfd, field,
                                        gop_chunk):
    """test_stream_conformance's generated streams: the port's tokenizer
    keeps every prediction window in the frame, and the port decodes them
    as the golden model does."""
    rng = np.random.default_rng(42)
    mbw, mbh = 10, 6
    pics = []
    for i, pct in enumerate(pct_pattern):
        p = random_picture(rng, mbw, mbh, cf, pct, fpfd=fpfd,
                           allow_field_motion=field)
        p.temporal_reference = i
        pics.append(p)
    data = encode_stream(mbw * 16, mbh * 16, cf, pics)
    toks = _port().tokenize_stream(data)
    assert len(toks) == len(pct_pattern)
    assert any(t.field_pred.any() for t, _, _ in toks) == field
    for tokens, geom, _ in toks:
        _check_windows(tokens, geom)
    got = watchdog(lambda: _port(gop_chunk=gop_chunk).decode(data))
    assert_frames_equal(decode_stream(data), got)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qmext_stream(seed, n_pictures, mbw=3, mbh=2):
    """An I P B B P B B ... stream whose every picture loads its own four
    quant matrices, as both 1080-line fixtures' do (the recipe of
    ``tools/bench_stream.make_bench_stream``, at a small size)."""
    rng = np.random.default_rng(seed)
    pct = [H.PCT_I] + [H.PCT_P, H.PCT_B, H.PCT_B] * n_pictures
    pics = []
    for i in range(n_pictures):
        p = random_picture(rng, mbw, mbh, H.CHROMA_420, pct[i])
        p.temporal_reference = i
        m = [rng.integers(1, 256, 64).astype(np.uint8) for _ in range(4)]
        p.qmext = H.QuantMatrixExtension(
            load_intra_quantiser_matrix=1, intra_quantiser_matrix=m[0],
            load_non_intra_quantiser_matrix=1,
            non_intra_quantiser_matrix=m[1],
            load_chroma_intra_quantiser_matrix=1,
            chroma_intra_quantiser_matrix=m[2],
            load_chroma_non_intra_quantiser_matrix=1,
            chroma_non_intra_quantiser_matrix=m[3])
        pics.append(p)
    return encode_stream(mbw * 16, mbh * 16, H.CHROMA_420, pics)


@pytest.mark.parametrize("gop_chunk", CHUNKS + [7])
def test_repeated_stream_decodes_to_repeated_frames(gop_chunk):
    """``fixtures.repeat_stream``, the main path's multi-chunk input: a
    stream of 7 pictures, each with its own quant matrices, four times
    over as one sequence decodes, on the port and on the golden model, to
    the stream's frames four times over (at ``gop_chunk=7`` one chunk a
    copy, as the fixtures at 16); the decoder keeps at most two chunks of
    token arrays after it (``chip_smoke.host_kept_bytes`` counts them
    with the staging slots)."""
    smoke = _smoke()
    data = _qmext_stream(61, 7)
    four = fixtures.repeat_stream(data, 4)
    assert four.count(fixtures.SEQUENCE_END) == 1
    assert four.count(b"\x00\x00\x01\xb3") == 1
    assert four.count(fixtures.GROUP_START) == 4
    assert fixtures.repeat_stream(data, 1) == data
    once = decode_stream(data)
    assert_frames_equal(once * 4, decode_stream(four))
    dec = _port(gop_chunk=gop_chunk)
    got = watchdog(lambda: dec.decode(four))
    assert_frames_equal(once * 4, got)
    kept = 0
    for tokens in dec._spare_tokens:
        kept += sum(a.nbytes for a in vars(tokens).values()
                    if isinstance(a, np.ndarray))
    for recon in dec._recons.values():
        for slots in recon._stage.values():
            kept += sum(s.blob.nbytes for s in slots if s is not None)
    assert kept > 0 and smoke.host_kept_bytes(dec) == kept
    assert len(dec._spare_tokens) <= 2 * max(gop_chunk, 1)
    with pytest.raises(ValueError, match="sequence end"):
        fixtures.repeat_stream(data[:-4], 2)


@pytest.mark.parametrize("gop_chunk", CHUNKS)
def test_picture_before_a_sequence_header_loses_its_matrices(gop_chunk):
    """A fault of the reference that the port shares (ROADMAP Queue 3):
    the decoders parse on to the next picture start code before they
    decode a picture, so a sequence header right after a picture resets
    that picture's downloaded quant matrices before it is decoded.  The
    stream twice over, the second copy with its sequence header: the
    port, the JAX decoder and the golden model agree frame for frame,
    and only the first copy's last picture (decode order) differs from the
    stream's own decode."""
    data = _qmext_stream(67, 7)
    twice = data[:-4] + data
    want = decode_stream(twice)
    assert_frames_equal(JaxDecoder(JaxConfig(gop_chunk=gop_chunk)).decode(
        twice), want)
    got = watchdog(lambda: _port(gop_chunk=gop_chunk).decode(twice))
    assert_frames_equal(want, got)
    once = decode_stream(data) * 2
    differ = [i for i, (a, b) in enumerate(zip(once, want))
              if not (np.array_equal(a.y, b.y) and np.array_equal(a.u, b.u)
                      and np.array_equal(a.v, b.v))]
    assert len(want) == len(once) == 14
    assert [(i < 7, want[i].temporal_reference) for i in differ] == [
        (True, 6)]
