"""The committed interlaced 1080-line 4:2:2 stream fixture that
``chip_smoke.py`` decodes on the GPU: it is what
``tools/make_torch_fixture.py`` generates, it exercises field-based motion
and field DCT, and its recorded YUV hash is what the JAX package decodes
from it — and what the port decodes from it on the CPU."""
import hashlib
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_torch_fixture as fx  # noqa: E402


def test_interlaced_fixture_regenerates_and_decodes_to_recorded_hashes():
    with open(os.path.join(fx.DATA_DIR, fx.INTERLACED_META_NAME)) as f:
        want = json.load(f)
    with open(os.path.join(fx.DATA_DIR, fx.INTERLACED_STREAM_NAME),
              "rb") as f:
        committed = f.read()
    data = fx.make_interlaced_stream()
    assert data == committed
    assert fx.describe(data, field_counts=True) == want
    assert (want["frames"], want["yuv_bytes"]) == (16, 16 * 1920 * 1088 * 2)
    assert want["field_pred_mbs"] > 0 and want["field_dct_mbs"] > 0

    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cpu"))
    frames = dec.decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]
    assert [key[1] for key in dec._recons] == [True]
