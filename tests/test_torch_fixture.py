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
