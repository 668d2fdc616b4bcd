"""The committed 1080p stream fixture that ``chip_smoke.py`` decodes on the
GPU: it is what ``tools/make_torch_fixture.py`` generates, and its recorded
YUV hash is what the JAX package decodes from it — and what the port
decodes from it on the CPU."""
import hashlib
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_fixture as fx  # noqa: E402


def test_fixture_regenerates_and_decodes_to_recorded_hashes():
    with open(os.path.join(fx.DATA_DIR, fx.META_NAME)) as f:
        want = json.load(f)
    with open(os.path.join(fx.DATA_DIR, fx.STREAM_NAME), "rb") as f:
        committed = f.read()
    data = fx.make_stream()
    assert data == committed
    assert fx.describe(data) == want
    assert (want["frames"], want["yuv_bytes"]) == (16, 16 * 1920 * 1088 * 3 // 2)

    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    frames = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                       pictures_pool_size=0,
                                       device="cpu")).decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]


# fixture -> (frames, YUV bytes a frame)
NEW_FIXTURES = {
    "bench_1080p_420_64": (64, 1920 * 1088 * 3 // 2),
    "bench_1080p_420_8": (8, 1920 * 1088 * 3 // 2),
    "natural_576_420_16": (16, 720 * 576 * 3 // 2),
}


@pytest.mark.parametrize("name", sorted(NEW_FIXTURES))
def test_entry_point_fixture_regenerates_and_decodes_to_recorded_hashes(
        name):
    """The streams of the port's bench (``make_bench_stream`` at 64
    pictures, the headline, and at 8, the latency line) and the SD natural
    stream: each regenerates from its seed byte for byte, the JAX package
    decodes it to the recorded hash, and so does the port on the CPU."""
    from tiny_mp2v_dec_tpu_torch import fixtures
    data, want = fixtures.load(name)
    make, counts = fx.FIXTURES[name]
    assert make() == data
    assert fx.describe(data, counts) == want
    frames, frame_bytes = NEW_FIXTURES[name]
    assert (want["frames"], want["yuv_bytes"]) == (frames,
                                                   frames * frame_bytes)

    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    got = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0,
                                    device="cpu")).decode(data)
    assert fixtures.check_frames(got, want) == want["yuv_sha256"]


@pytest.mark.parametrize("gop_chunk", [0, 4, 16])
@pytest.mark.parametrize("impl", ["mxu", "roll", "swar"])
def test_natural_fixture_decodes_under_every_mc_impl(monkeypatch, impl,
                                                     gop_chunk):
    """The SD natural stream through each MC implementation's plain
    versions at each chunk size the card decodes it at
    (``chip_smoke.NATURAL_CHUNKS``), to the recorded JAX hash."""
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder, fixtures
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    data, want = fixtures.load("natural_576_420_16")
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk, output_host=False,
                                    pictures_pool_size=0, device="cpu"))
    assert fixtures.check_frames(dec.decode(data), want) == want["yuv_sha256"]
    assert {key[3] for key in dec._recons} == {impl}
