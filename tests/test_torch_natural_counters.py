"""PyTorch port, the counters of the tokenizer's load on natural content
(the benchmark's configuration ``mp_ml_576_420`` and its generator
``streams/natural.py`` at 720x64): ``stats["coded_blocks"]``, the sum of
the tokens' ``n_coded_blocks``, and ``stats["coded_bytes"]``, the bytes of
every slice from its start code to the next start code, kept alike on the
chunk path, the live path, the row mesh and ``decode_batch``; ``reset()``
zeroes both.  Imports neither ``jax`` nor ``tiny_mp2v_dec_tpu``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mp2v_bench import spec  # noqa: E402
from mp2v_bench.streams import generate, natural  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import headers as H  # noqa: E402

CONFIG = "mp_ml_576_420"
# 45 x 4 macroblocks: the odd 45-MB row of 720x576
SMALL = {"width": 720, "height": 64, "distinct_pictures": 7}
SEEDS = (2**34 + 25, 2**31 + 7)
PATHS = {"chunk": dict(gop_chunk=16), "live": dict(gop_chunk=0),
         "rows": dict(mesh="rows", mesh_devices=2)}


def natural_config() -> dict:
    entry = next(c for c in spec.benchmark()["configs"]
                 if c["name"] == CONFIG)
    return {**spec.load_json(f"{spec.ROOT}/{entry['file']}"), **SMALL}


@pytest.fixture(scope="module")
def streams():
    return [natural.make_stream(natural_config(), s) for s in SEEDS]


def slice_bytes(data: bytes) -> int:
    """The bytes of every slice of ``data``, each from its start code to
    the next start code (or the end of the data)."""
    b = np.frombuffer(data, np.uint8)
    at = np.nonzero((b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1))[0]
    ends = np.append(at[1:], len(data))
    codes = b[at + 3]
    slices = (codes >= H.SLICE_START_CODE_MIN) & (
        codes <= H.SLICE_START_CODE_MAX)
    return int((ends - at)[slices].sum())


def coded_blocks(data: bytes) -> int:
    tokens = MP2VDecoder(DecoderConfig(device="cpu")).tokenize_stream(data)
    return sum(t.n_coded_blocks for t, _, _ in tokens)


def _decoder(**kw):
    return MP2VDecoder(DecoderConfig(device="cpu", num_threads=1, **kw))


def test_natural_content_codes_half_the_blocks(streams):
    data = streams[0]
    n_blocks = SMALL["distinct_pictures"] * 45 * 4 * 6
    assert 0.35 <= coded_blocks(data) / n_blocks <= 0.65
    # the slices are nearly the whole stream: headers are a few bytes
    assert 0.95 * len(data) < slice_bytes(data) < len(data)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counted_on_each_path(path, streams):
    data = streams[0]
    dec = _decoder(**PATHS[path])
    if path == "live":
        frames = [f for unit in generate.picture_units(data)
                  for f in dec.decode(unit)]
    else:
        frames = dec.decode(data)
    assert len(frames) == SMALL["distinct_pictures"]
    assert dec.stats["coded_blocks"] == coded_blocks(data) > 0
    assert dec.stats["coded_bytes"] == slice_bytes(data) > 0
    dec.reset()
    assert dec.stats["coded_blocks"] == dec.stats["coded_bytes"] == 0


def test_counted_over_the_batch(streams):
    dec = _decoder()
    out = dec.decode_batch(streams)
    assert [len(f) for f in out] == [SMALL["distinct_pictures"]] * 2
    assert dec.stats["coded_blocks"] == sum(map(coded_blocks, streams))
    assert dec.stats["coded_bytes"] == sum(map(slice_bytes, streams))
    dec.reset()
    assert dec.stats["coded_blocks"] == dec.stats["coded_bytes"] == 0


def test_repeated_stream_counts_each_copy(streams):
    data = streams[1]
    dec = _decoder(gop_chunk=16)
    dec.decode(generate.repeat_stream(data, 3))
    assert dec.stats["coded_blocks"] == 3 * coded_blocks(data)
    assert dec.stats["coded_bytes"] == 3 * slice_bytes(data)
