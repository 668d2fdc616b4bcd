"""PyTorch port, the decoder as a whole: small IPBPB streams against the
JAX decoder (Pallas interpret mode) and the golden model, a mid-stream
handoff of the reference pictures from JAX to the port, and what the
slice refuses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import assert_frames_equal, ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402
from tiny_mp2v_dec_tpu.ops.recon import GopRecon as JaxGopRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch.state import refs_from_numpy  # noqa: E402


@pytest.mark.parametrize("gop_chunk", [0, 4])
@pytest.mark.parametrize("mb_w,mb_h,seed", [(2, 2, 5150), (3, 2, 5151)])
def test_decode_matches_jax_and_golden(mb_w, mb_h, seed, gop_chunk):
    data = ipb_stream(np.random.default_rng(seed), mb_w, mb_h,
                      H.CHROMA_420)
    gold = decode_stream(data)
    jax_frames = JaxDecoder(JaxConfig(
        gop_chunk=gop_chunk, use_pallas=True,
        pallas_interpret=True)).decode(data)
    got = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk,
                                    device="cpu")).decode(data)
    assert_frames_equal(jax_frames, got)
    assert_frames_equal(gold, got)
    assert [f.temporal_reference for f in got] == [0, 1, 2, 3, 4]


def test_decode_feature_stream_small_pool_matches_golden():
    """q_scale_type / intra_vlc_format / alternate_scan / field DCT with
    frame motion, a tail chunk, device-resident frames, and a picture pool
    smaller than the chunk (back-pressure never waits on its own chunk)."""
    data = ipb_stream(np.random.default_rng(5153), 3, 2, H.CHROMA_420,
                      q_scale_type=1, intra_vlc_format=1, alternate_scan=1,
                      fpfd=False)
    gold = decode_stream(data)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=3, pictures_pool_size=1,
                                    output_host=False, device="cpu"))
    got = dec.decode(data)
    assert_frames_equal(gold, got)
    assert dec.stats["pictures"] == 5
    assert [f.device_buffer().shape for f in got] == [(48 * 32 * 3 // 2,)] * 5


def test_tokenizers_agree():
    """The port's build of the native tokenizer == the JAX package's (one
    thread each: with several, slices claim rows in scheduling order)."""
    data = ipb_stream(np.random.default_rng(5154), 3, 2, H.CHROMA_420,
                      q_scale_type=1, alternate_scan=1, fpfd=False,
                      allow_field_motion=True)
    jt = JaxDecoder(JaxConfig(num_threads=1)).tokenize_stream(data)
    tt = MP2VDecoder(DecoderConfig(num_threads=1,
                                   device="cpu")).tokenize_stream(data)
    assert len(jt) == len(tt) == 5
    for (a, ga, pa), (b, gb, pb) in zip(jt, tt):
        assert (ga.width, ga.height, ga.chroma_format) == (
            gb.width, gb.height, gb.chroma_format)
        assert pa.picture_coding_type == pb.picture_coding_type
        assert a.n_coded_blocks == b.n_coded_blocks
        k = a.n_coded_blocks
        for name in ("cblk", "cblk_idx", "row_nnz"):
            np.testing.assert_array_equal(getattr(a, name)[:k],
                                          getattr(b, name)[:k], err_msg=name)
        for name in ("intra", "fwd", "bwd", "field_pred", "dct_type", "mv",
                     "mvfs", "coded"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


def test_handoff_mid_stream_from_jax():
    """JAX decodes chunk 1; its (r0, r1) go to the port through
    refs_from_numpy; the port's chunk 2 equals JAX's own chunk 2 from the
    same references."""
    pics = ((H.PCT_I, 0), (H.PCT_P, 2), (H.PCT_B, 1), (H.PCT_P, 4),
            (H.PCT_B, 3), (H.PCT_P, 6), (H.PCT_B, 5), (H.PCT_P, 7))
    data = ipb_stream(np.random.default_rng(5155), 3, 2, H.CHROMA_420, pics)
    jt = JaxDecoder(JaxConfig(num_threads=1)).tokenize_stream(data)
    tt = MP2VDecoder(DecoderConfig(num_threads=1,
                                   device="cpu")).tokenize_stream(data)
    pcts = [p for p, _ in pics]
    jr = JaxGopRecon(jt[0][1], 4, use_pallas_idct=True, use_pallas_mc=True,
                     pallas_interpret=True)
    r0, r1, _ = jr.dispatch(jr.prepare([x[0] for x in jt[:4]], pcts[:4]))
    want = jr.dispatch(jr.prepare([x[0] for x in jt[4:]], pcts[4:]), r0, r1)
    refs = refs_from_numpy([tuple(np.asarray(p) for p in r)
                            for r in (r0, r1)], "cpu")
    tr = GopRecon(tt[0][1], 4, "cpu")
    got = tr.dispatch(tr.prepare([x[0] for x in tt[4:]], pcts[4:]), *refs)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("gop_chunk", [0, 4])
def test_field_motion_is_refused(gop_chunk):
    data = ipb_stream(np.random.default_rng(5152), 3, 2, H.CHROMA_420,
                      fpfd=False, allow_field_motion=True)
    assert any(t.field_pred.any()
               for t, _, _ in JaxDecoder().tokenize_stream(data))
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk, device="cpu"))
    with pytest.raises(NotImplementedError, match="field"):
        dec.decode(data)


def test_422_is_refused():
    data = ipb_stream(np.random.default_rng(5156), 2, 2, H.CHROMA_422)
    with pytest.raises(NotImplementedError, match="4:2:0"):
        MP2VDecoder(DecoderConfig(gop_chunk=4, device="cpu")).decode(data)


@pytest.mark.parametrize("opts", [{"mesh": "rows"}, {"use_pallas": True},
                                  {"pallas_interpret": True}])
def test_jax_only_options_are_refused(opts):
    with pytest.raises(NotImplementedError):
        DecoderConfig(device="cpu", **opts)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MP2VDecoder(DecoderConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        MP2VDecoder()
