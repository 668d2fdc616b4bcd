"""The metric arithmetic: the rate over the whole window and the stall it
must show, the 95th percentile, the trace's union and gaps, the sample of
decodes, and the roofline's byte count against a count by hand."""
import time

import numpy as np
import pytest

from mp2v_bench import reference, roofline, spec, trace
from mp2v_bench.drive import Reservoir, Window
from mp2v_bench.ref.tokenizer.types import PictureGeometry, PictureTokens
from mp2v_bench.streams import generate

FRAMES = 4


class FakeDecoder:
    """A decoder whose decodes take a fixed time, one of them longer."""

    def __init__(self, config, stall_at=None):
        self.config = config
        self.stall_at = stall_at
        self.n = 0
        self.renderer = None
        self.reset()

    def reset(self):
        self.stats = {"pictures": 0, "tokenize_s": 0.0, "fill_s": 0.0,
                      "device_s": 0.0, "output_s": 0.0}

    def decode(self, data):
        time.sleep(0.25 if self.n == self.stall_at else 0.01)
        self.n += 1
        self.stats["pictures"] += FRAMES
        return [object()] * FRAMES


def closed_window(stall_at):
    config = {"distinct_pictures": FRAMES}
    traffic = {"loop": "closed", "mc_impl": "mxu", "decoder": {},
               "repeat": 1, "sample_decodes": 2}
    d = spec.loop("closed")([config], traffic, [b""], 0, "cpu",
                            lambda cfg: FakeDecoder(cfg, stall_at),
                            lambda **kw: kw, lambda: None)
    return d.run(0.5)


def test_rate_over_the_window_shows_a_stall():
    read = spec.reader("frames_per_s")
    steady, stalled = closed_window(None), closed_window(3)
    assert read(stalled) < 0.8 * read(steady)
    # the window ends at the decode that crosses its length
    assert stalled.seconds >= 0.5 and steady.seconds >= 0.5
    assert steady.frames == FRAMES * len(steady.phases) // 2


def test_p95_nearest_rank():
    read = spec.reader("latency_p95_ms")
    w = Window(latencies_s=[i / 1e3 for i in range(100, 0, -1)])
    assert read(w) == pytest.approx(95.0)
    assert read(Window(latencies_s=[0.004])) == pytest.approx(4.0)
    assert read(Window()) is None


def test_counters_per_frame():
    w = Window(frames=10, seconds=2.0,
               stats={"pictures": 10, "tokenize_s": 0.03, "fill_s": 0.02,
                      "device_s": 0.05, "output_s": 0.0})
    assert spec.reader("tokenize_ms_per_frame.tput")(w) == pytest.approx(3)
    assert spec.reader("prepare_ms_per_frame.live")(w) == pytest.approx(2)
    assert spec.reader("dispatch_ms_per_frame.tput")(w) == pytest.approx(5)
    assert spec.reader("pipeline_overlap.tput")(w) == pytest.approx(0.05)
    # no trace: the device readers find nothing to read
    for name in ("device_kernels_per_frame", "device_roofline_pct",
                 "device_idle_pct"):
        assert spec.reader(name)(w) is None


def test_trace_union_and_gaps():
    events = [(0, 10, "k1", True), (5, 20, "Memcpy HtoD", False),
              (30, 40, "k2", True), (60, 70, "k3", True)]
    phases = [(20, 30, "host: decode() call")]
    t = trace.reduce(events, 0, 50, 50e-9, phases)
    assert t.kernels == 2 and t.kernel_s == pytest.approx(20e-9)
    assert t.busy_s == pytest.approx(30e-9)
    assert [g for g, _ in t.gaps] == pytest.approx([10e-9, 10e-9])
    names = sorted(n for _, n in t.gaps)
    assert names[0].startswith("host: decode() call; device idle until k2")
    assert "the window's end" in names[1]
    w = Window(trace_frames=2, trace=t)
    assert spec.reader("device_idle_pct")(w) == pytest.approx(40.0)
    assert spec.reader("device_kernels_per_frame")(w) == 1.0


def test_reservoir_is_a_bounded_seeded_sample():
    def sample(seed):
        r = Reservoir(3, seed)
        for i in range(50):
            r.offer(i)
        return sorted(r.kept), r.offered
    assert sample(7) == sample(7)
    kept, offered = sample(7)
    assert len(kept) == 3 and offered == 50
    assert {tuple(sample(s)[0]) for s in range(20)} != {tuple(kept)}


def tokens_2x2():
    """A 32x32 4:2:0 picture of 2 x 2 macroblocks: MB 0 frame-predicted
    at (0, 0), MB 1 frame-predicted a half pel to the right, MB 2
    field-predicted from both fields at (0, 0), MB 3 intra; 3 coded
    blocks."""
    g = PictureGeometry(32, 32, 1)
    t = PictureTokens.empty(g)
    t.coded[:] = True
    t.fwd[:3] = True
    t.intra[3] = True
    t.mv[1, 0, 0] = (1, 0)
    t.field_pred[2] = True
    t.mvfs[2, 1, 0] = 1
    for slot in range(3):
        t.alloc_block(3, slot)
    return t


def test_roofline_bytes_by_hand():
    t = tokens_2x2()
    # luma: MB 0 rows 0-15 cols 0-15; MB 1 cols 16-32, the last in the
    # zero pad: with MB 0, rows 0-15 by all 32 columns (512); MB 2 both
    # fields of rows 16-31, cols 0-15 (256).  Chroma: MB 0 and MB 1 (its
    # vector halves to 0) rows 0-7, 16 columns (128); MB 2 rows 8-15 of
    # cols 0-7 (64).  Twice for U and V.
    assert roofline.reference_bytes(t, 0) == 512 + 256 + 2 * (128 + 64)
    assert roofline.reference_bytes(t, 1) == 0
    out = 32 * 32 + 2 * 16 * 16
    assert roofline.picture_bytes(t, 2) == 3 * 128 + 1152 + out


def test_roofline_window_sums_pictures():
    t = tokens_2x2()
    one = roofline.picture_bytes(t, 2)
    ref = reference.Reference(frames=None, pcts=[2, 2], tokens=[t, t])
    assert roofline.window_bytes({(0, 0): 3, (0, 1): 2}, [ref]) == 5 * one
    # a second channel's pictures are held against its own tokens
    other = reference.Reference(frames=None, pcts=[1], tokens=[t])
    assert roofline.window_bytes({(0, 0): 3, (1, 0): 2}, [ref, other]) == (
        3 * one + 2 * roofline.picture_bytes(t, 1))


def test_roofline_reader():
    t = trace.Trace(kernel_s=1e-3)
    w = Window(trace=t, bytes_needed=3.35e9 * 0.5e-3, peak_bytes_per_s=3.35e12)
    assert spec.reader("device_roofline_pct.tput")(w) == pytest.approx(
        0.05)
    w.peak_bytes_per_s = 0     # a card with no rate in the table
    assert spec.reader("device_roofline_pct.live")(w) is None


@pytest.mark.parametrize("name", ("kernel_us_per_frame",
                                  "frames_per_s.tput"))
def test_reader_finds_nothing_to_read(name):
    """Without a trace, a kernel or a frame the reader returns nothing,
    and the run leaves the metric out."""
    assert spec.reader(name)(Window()) is None


def test_kernel_time_per_traced_frame():
    """The kernels' summed time over the traced part's frames, not over
    the whole window's."""
    w = Window(frames=400, trace_frames=128,
               trace=trace.Trace(kernel_s=2.56e-3, busy_s=5e-3))
    assert spec.reader("kernel_us_per_frame")(w) == pytest.approx(20.0)
    w.trace.kernel_s = 0.0
    assert spec.reader("kernel_us_per_frame")(w) is None


def test_union_counts_each_cell_once():
    rows = np.array([0, 2, 0])
    cols = np.array([0, 2, 5])
    n = np.array([4, 4, 1])
    # 4x4 at (0, 0); 4x4 at (2, 2), cut to 4x3 by a 5-wide plane and
    # overlapping the first by 2x2; 1x1 at (0, 5), cut to nothing
    assert roofline._union_rows(rows, n, cols, n, 8, 5) == 16 + 12 - 4


class FakeProfiler:
    """A profiler whose stop takes a while, as reading a trace does."""

    def __init__(self):
        self.started = self.stopped = 0

    def start(self):
        self.started += 1

    def stop(self):
        self.stopped += 1
        time.sleep(0.3)
        return [(0, 1, "k", True)]


@pytest.mark.parametrize("loop", ("closed", "open"))
def test_traced_part_and_pause(loop):
    """The profiler stops once after the traced part; the stop is left out
    of the window's time, and the traced part's frames are noted."""
    config = {"distinct_pictures": FRAMES, "frame_rate": [100, 1]}
    traffic = {"loop": loop, "mc_impl": "mxu", "decoder": {}, "repeat": 1,
               "sample_decodes": 2, "sample_pictures": 2}
    # a stream of FRAMES empty pictures, for the open loop to cut
    data = (generate.GROUP_START + b"\x00\x00\x01\x00\x11" * FRAMES
            + generate.SEQUENCE_END)
    d = spec.loop(loop)([config], traffic, [data], 0, "cpu", FakeDecoder,
                        lambda **kw: kw, lambda: None)
    prof = FakeProfiler()
    t = time.perf_counter()
    w = d.run(0.6, prof, trace_s=0.2)
    wall = time.perf_counter() - t
    assert prof.started == prof.stopped == 1
    assert w.trace_events == [(0, 1, "k", True)]
    assert w.trace_read_s >= 0.3
    assert 0.6 <= w.seconds < wall - 0.25
    assert 0.2 <= w.trace_seconds < w.seconds
    assert 0 < w.trace_frames < w.frames
    # the fake decoder hands back FRAMES frames a call, also a picture's
    per_picture = FRAMES if loop == "open" else 1
    assert sum(w.trace_decoded.values()) * per_picture == w.trace_frames
