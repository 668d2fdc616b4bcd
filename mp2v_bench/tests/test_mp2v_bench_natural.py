"""The natural-content generator (``streams/natural.py``) of
``mp_ml_576_420``: the same seed gives the same bytes on a pool or in one
process; the stream carries the configuration's headers and picture types;
at full size its statistics are a real encoder's (half the blocks coded,
few intra macroblocks in predicted pictures, 30-60 KB a picture); at
720x64 the plain reference and the port's plain CPU decode agree byte for
byte, a run of the cell ``sd576_natural_offline`` there is correct and
each planted fault of ``test_mp2v_bench_faults.py`` makes it not correct,
and so does the control.  Then the readers of the counters this
configuration brought."""
import time

import numpy as np
import pytest
from test_mp2v_bench_faults import FAULTS

from mp2v_bench import check, control, reference, spec
from mp2v_bench.drive import Window
from mp2v_bench.ref import headers as H
from mp2v_bench.ref.utils.bits import BitReader
from mp2v_bench.run import run_cell
from mp2v_bench.streams import generate, natural

NAME = "mp_ml_576_420"
CELL = "sd576_natural_offline"
SEED = 2**33 + 25
# 45 x 4 macroblocks: the odd 45-MB row and the 360-wide chroma of 720x576
SMALL = {"width": 720, "height": 64, "distinct_pictures": 7}


def config_of(**over):
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == NAME)
    return {**spec.load_json(f"{spec.ROOT}/{entry['file']}"), **over}


def start_codes(data: bytes, code: int) -> list:
    """Bit positions just past each start code ``code`` in ``data``."""
    b = np.frombuffer(data, np.uint8)
    hits = np.nonzero((b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1)
                      & (b[3:] == code))[0]
    return [(int(h) + 4) * 8 for h in hits]


@pytest.fixture(scope="module")
def pool():
    with generate.worker_pool(2) as p:
        yield p


@pytest.fixture(scope="module")
def full(pool):
    """The full-size stream of one seed and its plain reference decode."""
    config = config_of()
    data = natural.make_stream(config, SEED, pool)
    return config, data, reference.decode(data, 2)


def test_the_configuration_names_this_generator():
    config = config_of()
    assert spec.generator(config) is natural
    assert (config["width"], config["height"], config["chroma_format"]) == (
        720, 576, 1)


def test_same_seed_same_bytes(pool):
    config = config_of(**SMALL)
    a = natural.make_stream(config, SEED, pool)
    assert a == natural.make_stream(config, SEED)
    assert a != natural.make_stream(config, SEED + 1, pool)


def test_other_chroma_formats_refused():
    with pytest.raises(ValueError, match="chroma_format 2"):
        natural.make_stream(config_of(**SMALL, chroma_format=2), SEED)


def test_display_positions():
    B, P, I = H.PCT_B, H.PCT_P, H.PCT_I
    assert natural.display_positions([I, P, B, B, P, B, B]) == [
        0, 3, 1, 2, 6, 4, 5]
    assert natural.display_positions([I, P, P]) == [0, 1, 2]


def test_headers(full):
    config, data, _ = full
    seq_at, = start_codes(data, H.SEQUENCE_HEADER_CODE)
    seq = H.SequenceHeader.parse(BitReader(data, seq_at))
    assert (seq.horizontal_size_value, seq.vertical_size_value) == (720, 576)
    assert seq.frame_rate_code == 3
    assert seq.bit_rate_value == config["bit_rate_value"] == 24500
    r = BitReader(data, start_codes(data, H.EXTENSION_START_CODE)[0])
    assert r.read(4) == H.SEQUENCE_EXTENSION_ID
    ext = H.SequenceExtension.parse(r)
    assert ext.profile_and_level_indication == 72
    assert ext.chroma_format == H.CHROMA_420


def test_picture_types_are_the_streams(full):
    config, data, ref = full
    types = [H.PictureHeader.parse(BitReader(data, at)).picture_coding_type
             for at in start_codes(data, H.PICTURE_START_CODE)]
    assert types == natural.picture_types(config) == ref.pcts
    assert len(types) == config["distinct_pictures"]


def test_full_size_statistics(full):
    config, data, ref = full
    n = config["distinct_pictures"]
    geom = ref.tokens[0].geom
    coded = sum(t.n_coded_blocks for t in ref.tokens)
    assert 0.35 <= coded / (n * geom.n_mb * geom.blocks_per_mb) <= 0.65
    predicted = [t for t, p in zip(ref.tokens, ref.pcts) if p != H.PCT_I]
    intra = sum(int(t.intra.sum()) for t in predicted)
    assert intra < 0.15 * len(predicted) * geom.n_mb
    assert 30_000 <= len(data) / n <= 60_000


@pytest.mark.parametrize("seed", [SEED, 2**31 + 5])
def test_reference_and_port_agree(seed, pool):
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)
    data = natural.make_stream(config_of(**SMALL), seed, pool)
    ref = reference.decode(data, 2)
    assert len(ref.frames) == SMALL["distinct_pictures"]
    for gop_chunk in (0, 16):
        dec = MP2VDecoder(DecoderConfig(device="cpu", gop_chunk=gop_chunk,
                                        output_host=False,
                                        pictures_pool_size=0))
        got = np.stack([np.frombuffer(f.tobytes(), np.uint8)
                        for f in dec.decode(data)])
        assert np.array_equal(got, ref.display()), gop_chunk


def run_small_cell(pictures):
    cell = spec.cell(CELL)
    cell.config.update(SMALL, distinct_pictures=pictures)
    return run_cell(cell, SEED, 1.0, False, device="cpu",
                    t_start=time.perf_counter())


def test_sound_run_is_correct():
    r = run_small_cell(4)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"] == {k: {"value": 0, "limit": 0}
                           for k in check.LIMITS}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run_small_cell(4)
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_control_is_not_correct(seed):
    r = control.reading(config_of(**SMALL), seed, 2)
    assert r["mismatched_bytes"] > 0


def test_coded_blocks_per_frame():
    read = spec.reader("coded_blocks_per_frame.natural")
    # the parent's decoder has no such counter
    assert read(Window(frames=16, stats={"pictures": 16})) is None
    assert read(Window(frames=16, stats={"coded_blocks": 80_000})) == 5_000
    assert read(Window(stats={"coded_blocks": 1})) is None


def test_tokenize_ns_per_byte():
    read = spec.reader("tokenize_ns_per_byte.natural")
    assert read(Window(frames=16, stats={"tokenize_s": 0.02})) is None
    w = Window(frames=16, stats={"tokenize_s": 0.02,
                                 "coded_bytes": 4_000_000})
    assert read(w) == pytest.approx(5.0)
