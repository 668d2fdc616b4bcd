"""PyTorch port, the serving path against the port's own golden model, with
no JAX: ``MP2VDecoder.decode_batch`` of 8 seeded channels of mixed GOP
structure (the benchmark's configuration ``mp_hl_1080_420_8ch`` and its
generator at a small size: M=3 on four channels, M=2 on two, M=1 on two)
on the CPU.  Each channel's frames are byte for byte those of its own
``GoldenDecoder`` decode, with reordering on and off, over a stream
repeated as the benchmark repeats it, and with channels of unequal length,
whose padding ``noop_pictures`` counts.  Imports neither ``jax`` nor
``tiny_mp2v_dec_tpu``."""
import pytest

torch = pytest.importorskip("torch")

from mp2v_bench import spec  # noqa: E402
from mp2v_bench.streams import generate  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.golden.decoder import GoldenDecoder  # noqa: E402

CONFIG = "mp_hl_1080_420_8ch"
# 4 x 3 macroblocks, the last 8 lines cropped
SMALL = {"width": 64, "height": 40}
SEED = 2**35 + 21
# pictures of each channel where they differ
UNEQUAL = (16, 9, 12, 5, 14, 7, 11, 3)


def batch_config(lengths=None) -> dict:
    """The benchmark's 8-channel configuration at the small size, each
    channel ``lengths[c]`` pictures long where given."""
    config = spec.load_json(f"{spec.ROOT}/mp2v_bench/configs/{CONFIG}.json")
    config.update(SMALL)
    if lengths is not None:
        config["channels"] = [{**over, "distinct_pictures": n} for over, n
                              in zip(config["channels"], lengths)]
    return config


def batch_streams(lengths=None, repeat=1) -> list:
    return [generate.repeat_stream(data, repeat) for data in
            spec.channel_streams(batch_config(lengths), SEED)]


def test_the_channels_mix_gop_structures():
    configs = spec.channels(batch_config())
    assert [c["cycle"] for c in configs] == ["PBB"] * 4 + ["PB"] * 2 + ["P"] * 2
    assert len(set(batch_streams())) == 8


def assert_channels_equal_golden(got, streams, reordering):
    assert len(got) == len(streams)
    for c, (frames, data) in enumerate(zip(got, streams)):
        want = GoldenDecoder(reordering=reordering).decode(data)
        assert len(frames) == len(want), f"channel {c}"
        for k, (g, w) in enumerate(zip(frames, want)):
            assert g.tobytes() == w.tobytes(), f"channel {c} frame {k}"
            assert (g.temporal_reference, g.picture_coding_type) == (
                w.temporal_reference, w.picture_coding_type)


@pytest.mark.parametrize("reordering", [True, False])
def test_eight_mixed_channels_equal_their_golden_decodes(reordering):
    streams = batch_streams(repeat=2)
    dec = MP2VDecoder(DecoderConfig(device="cpu", reordering=reordering,
                                    num_threads=1))
    got = dec.decode_batch(streams)
    assert_channels_equal_golden(got, streams, reordering)
    assert dec.stats["batch_steps"] == 32
    assert dec.stats["noop_pictures"] == 0


@pytest.mark.parametrize("reordering", [True, False])
def test_unequal_channels_are_padded_and_equal_golden(reordering):
    streams = batch_streams(UNEQUAL)
    dec = MP2VDecoder(DecoderConfig(device="cpu", reordering=reordering,
                                    num_threads=1))
    got = dec.decode_batch(streams)
    assert_channels_equal_golden(got, streams, reordering)
    assert [len(f) for f in got] == list(UNEQUAL)
    assert dec.stats["batch_steps"] == max(UNEQUAL)
    assert dec.stats["noop_pictures"] == 8 * max(UNEQUAL) - sum(UNEQUAL)
