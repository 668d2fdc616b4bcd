"""The cell ``hd420_multistream8``: eight channels of mixed GOP structure
through the port's serving path (``loops/batch.py``, ``decode_batch``), at
a small geometry on the port's plain CPU versions.  A sound run is
correct; a byte altered in one channel's frames is counted under that
channel (and one altered in the planes' padding, which the comparison
crops away, is not); faults planted in the port make the run incorrect;
the roofline counts each channel's pictures from its own stream; and the
two readers of the batch path's counters read them, or nothing where the
decoder has no such counter."""
import re
import time

import pytest

from mp2v_bench import reference, roofline, spec
from mp2v_bench.drive import Window
from mp2v_bench.run import run_cell
from test_mp2v_bench_faults import _state_unchanged, _token_altered

CELL = "hd420_multistream8"
SMALL = {"width": 64, "height": 40}
SEED = 2**36 + 5
SECONDS = 1.0
CHANNELS = 8


def small_cell():
    cell = spec.cell(CELL)
    cell.config.update(SMALL)
    return cell


def run(capsys):
    """A run of the cell and the mismatched bytes its log gives by
    channel."""
    r = run_cell(small_cell(), SEED, SECONDS, False, device="cpu",
                 t_start=time.perf_counter())
    line = re.search(r"mismatched bytes by channel: (.*)",
                     capsys.readouterr().err)
    assert line is not None
    by_channel = dict(map(int, pair.split(": "))
                      for pair in line.group(1).split(", "))
    assert sorted(by_channel) == list(range(CHANNELS))
    return r, by_channel


def test_the_cell_names_the_batch_path():
    cell = spec.cell(CELL)
    assert cell.loop.__module__ == "mp2v_bench.loops.batch"
    assert len(spec.channels(cell.config)) == CHANNELS
    assert [m["name"] for m in cell.end_to_end] == ["kernel_us_per_frame",
                                                    "setup_s"]
    assert all(m["name"].endswith(".batch") for m in cell.per_layer)
    assert {m["name"] for m in cell.per_layer} >= {
        "batch_tokenize_ms_per_frame.batch", "batch_copy_mb_per_frame.batch"}


def test_sound_run_is_correct(capsys):
    r, by_channel = run(capsys)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["mismatched_bytes"]["value"] == 0
    assert set(by_channel.values()) == {0}
    # the CPU has no device trace: kernel_us_per_frame finds nothing
    assert set(r["metrics"]) == {"setup_s"}


class Altered:
    """A frame whose luma plane has one byte altered at ``at``."""

    def __init__(self, frame, at):
        self.frame = frame
        self.at = at

    def device_buffer(self):
        y, u, v = self.frame.device_buffer()
        y = y.clone()
        y[self.at] ^= 1
        return y, u, v


@pytest.mark.parametrize("where", ["picture", "padding"])
@pytest.mark.parametrize("channel", [1, 6])
def test_a_byte_altered_in_one_channel(channel, where, capsys,
                                       monkeypatch):
    """(0, 7) lies in the picture; the last row of the 48-row luma plane
    lies in the padding below the picture's 40 rows."""
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import MP2VDecoder
    orig = MP2VDecoder.decode_batch
    at = (0, 7) if where == "picture" else (-1, 7)

    def decode_batch(self, streams):
        out = orig(self, streams)
        out[channel] = [Altered(f, at) for f in out[channel]]
        return out
    monkeypatch.setattr(MP2VDecoder, "decode_batch", decode_batch)
    r, by_channel = run(capsys)
    if where == "padding":
        assert r["correct"] and set(by_channel.values()) == {0}
        return
    assert not r["correct"] and r["failed"] > 0
    bad = r["checks"]["mismatched_bytes"]["value"]
    # one byte in each compared frame of the channel
    assert by_channel[channel] == bad == r["failed"] > 0
    assert all(n == 0 for c, n in by_channel.items() if c != channel)


def _frame_dropped(monkeypatch):
    """A frame that never comes: the last of each channel's frames."""
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import MP2VDecoder
    orig = MP2VDecoder.decode_batch

    def decode_batch(self, streams):
        return [frames[:-1] for frames in orig(self, streams)]
    monkeypatch.setattr(MP2VDecoder, "decode_batch", decode_batch)


FAULTS = {"state_unchanged": _state_unchanged,
          "token_altered": _token_altered,
          "frame_dropped": _frame_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, capsys, monkeypatch):
    FAULTS[fault](monkeypatch)
    r, by_channel = run(capsys)
    assert not r["correct"] and r["failed"] > 0
    assert all(n > 0 for n in by_channel.values())


def test_roofline_counts_each_channels_own_pictures():
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)
    cell = small_cell()
    streams = spec.channel_streams(cell.config, SEED)
    runner = cell.loop(spec.channels(cell.config), cell.traffic, streams,
                       SEED, "cpu", MP2VDecoder, DecoderConfig, lambda: None)
    w = runner.run(0.3)
    calls = len(w.decode_s)
    repeat = cell.traffic["repeat"]
    assert calls > 0 and w.frames == calls * repeat * 16 * CHANNELS
    assert w.decoded == {(c, i): calls * repeat
                         for c in range(CHANNELS) for i in range(16)}
    refs = reference.decode_all(streams, 2)
    per_channel = [sum(roofline.picture_bytes(t, p)
                       for t, p in zip(r.tokens, r.pcts)) for r in refs]
    assert len(set(per_channel)) == CHANNELS
    assert roofline.window_bytes(w.decoded, refs) == (
        calls * repeat * sum(per_channel))
    # the batch path's counters over the window
    s = w.stats
    assert s["batch_steps"] == calls * repeat * 16
    assert s["noop_pictures"] == 0 and s["batch_copy_bytes"] > 0


@pytest.mark.parametrize("name, counter, per", [
    ("batch_tokenize_ms_per_frame.batch", "batch_tokenize_s", 1e3),
    ("batch_copy_mb_per_frame.batch", "batch_copy_bytes", 1e-6)])
def test_readers_of_the_batch_counters(name, counter, per):
    read = spec.reader(name)
    w = Window(frames=512, stats={"pictures": 512, counter: 2.56})
    assert read(w) == pytest.approx(2.56 / 512 * per)
    # the parent's decoder has no such counter, and a window no frame
    assert read(Window(frames=512, stats={"pictures": 512})) is None
    assert read(Window(frames=0, stats={counter: 2.56})) is None
