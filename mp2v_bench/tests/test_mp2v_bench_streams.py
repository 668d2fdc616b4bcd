"""The seeded streams and the plain reference, at a small geometry: each
configuration's stream decodes to the same YUV through the frozen
reference (on worker processes or in one) and through the port's plain CPU
path, as the closed loop and as the open loop feed it; the same seed gives
the same bytes."""
import hashlib

import numpy as np
import pytest

from mp2v_bench import reference, spec
from mp2v_bench.ref.golden.decoder import decode_stream
from mp2v_bench.streams import generate

CONFIGS = ("mp_hl_1080_420", "422p_hl_1080_422")
# 4 x 3 macroblocks, and the same with the last 8 lines cropped
SIZES = ((64, 48), (64, 40))
SEED = 2**33 + 17


def small(name, width, height):
    config = spec.load_json(f"{spec.ROOT}/mp2v_bench/configs/{name}.json")
    config.update(width=width, height=height)
    return config


def frames_of(port_frames):
    return np.stack([np.frombuffer(f.tobytes(), np.uint8)
                     for f in port_frames])


@pytest.fixture(scope="module")
def pool():
    with generate.worker_pool(2) as p:
        yield p


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes(name, pool):
    config = small(name, *SIZES[0])
    a = generate.make_stream(config, SEED, pool)
    b = generate.make_stream(config, SEED)
    c = generate.make_stream(config, SEED + 1, pool)
    assert a == b
    assert a != c
    assert generate.make_stream(config, -SEED) != a


def test_seed_words():
    assert generate.seed_words(5) == [0, 5]
    assert generate.seed_words(-5) == [1, 5]
    assert generate.seed_words(2**40 + 3) == [0, 3, 2**8]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reference_and_port_agree(name, size, pool):
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)
    config = small(name, *size)
    data = generate.make_stream(config, SEED, pool)
    ref = reference.decode(data, 2)
    gold = decode_stream(data, reordering=False)
    assert np.array_equal(ref.frames, frames_of(gold))
    assert len(ref.frames) == config["distinct_pictures"]

    # the closed loop: the stream four times over, in display order
    dec = MP2VDecoder(DecoderConfig(device="cpu", gop_chunk=16,
                                    output_host=False, pictures_pool_size=0))
    got = frames_of(dec.decode(generate.repeat_stream(data, 4)))
    assert np.array_equal(got, np.concatenate([ref.display()] * 4))

    # the open loop: one picture a call, in decode order, cycling
    dec = MP2VDecoder(DecoderConfig(device="cpu", gop_chunk=0,
                                    output_host=False, reordering=False))
    units = generate.picture_units(data)
    cycle = generate.cycle_units(units)
    got = [f for u in units + cycle for f in dec.decode(u)]
    assert np.array_equal(frames_of(got),
                          np.concatenate([ref.frames] * 2))


def test_units_rebuild_the_stream(pool):
    config = small(CONFIGS[0], *SIZES[0])
    data = generate.make_stream(config, SEED, pool)
    units = generate.picture_units(data)
    assert len(units) == config["distinct_pictures"]
    assert b"".join(units) + generate.SEQUENCE_END == data
    cycle = generate.cycle_units(units)
    assert cycle[0].startswith(generate.GROUP_START)
    assert cycle[1:] == units[1:]


def test_repeat_matches_the_ports(pool):
    from tiny_mp2v_dec_tpu_torch import fixtures
    data = generate.make_stream(small(CONFIGS[1], *SIZES[0]), SEED, pool)
    for times in (1, 2, 4):
        assert (generate.repeat_stream(data, times)
                == fixtures.repeat_stream(data, times))


def test_display_order():
    I, P, B = 1, 2, 3
    assert reference.display_order([I, P, B, B, P, B, B]) == [
        0, 2, 3, 1, 5, 6, 4]


def test_picture_types():
    config = small(CONFIGS[0], *SIZES[0])
    assert generate.picture_types(config) == [1] + [2, 3, 3] * 5


def test_full_size_headers():
    """The sequence start of each configuration at its own size parses
    back to its geometry, frame rate and profile."""
    from mp2v_bench.ref import headers as H
    for name in CONFIGS:
        config = spec.load_json(f"{spec.ROOT}/mp2v_bench/configs/{name}.json")
        start = generate.sequence_start(config)
        seq = H.SequenceHeader.parse(H.BitReader(start, 32))
        assert (seq.horizontal_size_value, seq.vertical_size_value) == (
            config["width"], config["height"])
        assert seq.frame_rate_code == config["frame_rate_code"]
        digest = hashlib.sha256(start).hexdigest()
        assert digest == hashlib.sha256(
            generate.sequence_start(config)).hexdigest()
