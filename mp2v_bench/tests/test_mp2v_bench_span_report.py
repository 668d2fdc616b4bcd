"""The arithmetic of ``span_report.py`` on synthetic spans and device
events: the spans that name an idle gap, the split of a decode's ramp and
of the gap that holds it, the clock check, and the per-frame and
per-picture quantities."""
import pytest

from mp2v_bench import span_report as sr
from mp2v_bench import trace
from mp2v_bench.drive import Window

MS = 1_000_000


def rec(name, thread, unit, a_ms, b_ms, cpu_ms=None):
    cpu = (b_ms - a_ms) if cpu_ms is None else cpu_ms
    return (name, thread, unit, int(a_ms * MS), int(b_ms * MS),
            int(cpu * MS))


def one_decode():
    """A decode at 10 ms of two pictures (a chunk): tokenized at 11-13 and
    14-16 ms, prepared on the fill thread at 17-21 (a 1-ms slot wait),
    dispatched at 22-30 with its upload at 23-24 and its kernels queued
    at 24-29, the frames routed at 30-31; the decode returns at 32."""
    return [
        rec("decode", "MainThread", 0, 10, 32),
        rec("tokenize", "MainThread", 0, 11, 13, 1.5),
        rec("tokenize", "MainThread", 1, 14, 16),
        rec("chunk_wait", "MainThread", 0, 17, 31),
        rec("prepare", "mp2v-fill_0", 0, 17, 21, 2.5),
        rec("slot_wait", "mp2v-fill_0", 0, 17.5, 18.5, 0),
        rec("fill_wait", "mp2v-dispatch_0", 0, 16.5, 21.5, 0),
        rec("dispatch", "mp2v-dispatch_0", 0, 22, 30, 6),
        rec("upload", "mp2v-dispatch_0", 0, 23, 24),
        rec("recon", "mp2v-dispatch_0", 0, 24, 29),
        rec("route", "mp2v-dispatch_0", 0, 30, 31),
    ]


def test_innermost_names_each_thread():
    recs = one_decode()
    assert sr.innermost(recs, int(18 * MS)) == (
        "disp:fill_wait fill:slot_wait main:chunk_wait")
    assert sr.innermost(recs, int(12 * MS)) == "main:tokenize"
    assert sr.innermost(recs, int(40 * MS)) == ""


def test_gap_names_with_and_without_spans():
    events = [(0, 5 * MS, "k0", True), (33 * MS, 34 * MS, sr.PINNED_HTOD,
                                        False),
              (34 * MS, 40 * MS, "k1", True)]
    phases = [(int(9.5 * MS), 33 * MS, "host: decode() call")]
    got = sr.gaps(events, 0, 40 * MS, phases, one_decode())
    assert [(a, b) for a, b, _ in got] == [(5 * MS, 33 * MS)]
    name = got[0][2]
    assert name.startswith("disp:fill_wait fill:prepare main:chunk_wait | "
                           "host: decode() call; device idle until Memcpy")
    # without spans, trace.reduce's names
    plain = sr.gaps(events, 0, 40 * MS, phases, [])
    reduced = trace.reduce(events, 0, 40 * MS, 40e-3, phases)
    assert [n for _, _, n in plain] == [n for _, n in reduced.gaps]


def test_ramp_and_gap_split_add_up():
    by = sr.index(one_decode())
    r = sr.ramp(by, by["decode"][0])
    assert r["ramp"] == pytest.approx(13.0)
    parts = ("walk", "tokenize", "between_tokenize", "to_fill",
             "prepare_less_slot_wait", "slot_wait", "to_dispatch",
             "dispatch_to_upload")
    assert sum(r[k] for k in parts) == pytest.approx(r["ramp"])
    assert (r["walk"], r["tokenize"], r["between_tokenize"], r["to_fill"],
            r["slot_wait"], r["to_dispatch"]) == pytest.approx(
                (1, 4, 1, 1, 1, 1))
    assert r["pictures"] == 2
    g = sr.split_gap(by, 5 * MS, 33 * MS)
    assert g["before_decode"] == pytest.approx(5)
    assert g["upload_to_copy"] == pytest.approx(10)
    assert g["before_decode"] + g["ramp"] + g["upload_to_copy"] == (
        pytest.approx(g["gap"]))
    # a gap that holds no decode's start is not split
    assert sr.split_gap(by, 33 * MS, 40 * MS) == {}


def test_clock_check():
    recs = [rec("upload", "d", u, a, a + 0.1) for u, a in
            enumerate((10, 20, 30))]
    events = [(int(a * MS), int(a * MS) + 1, sr.PINNED_HTOD, False)
              for a in (10.05, 20.2, 30.1)] + [(0, 1, "k", True)]
    ups, copies = sr.upload_pairs(events, recs, 0, 40 * MS)
    assert len(ups) == len(copies) == 3
    c = sr.clock_check(zip(ups, copies))
    assert c["pairs"] == 3
    assert (c["median_ms"], c["min_ms"], c["max_ms"]) == pytest.approx(
        (0.1, 0.05, 0.2))
    assert c["copies_before_their_upload"] == 0
    # a trace clock 5 ms behind puts every copy before its span
    c = sr.clock_check((u, c - 5 * MS) for u, c in zip(ups, copies))
    assert c["copies_before_their_upload"] == 3


def drifting(lost=0):
    """Sixteen uploads 30 to 98 ms apart and their copies on a trace
    clock 5 ms ahead that runs 1000 ppm fast and jumps back 8 ms before
    the fourteenth copy; each copy 0.1 ms after its upload (one 3 ms
    late, behind other work); the first ``lost`` copies missing from the
    trace."""
    base = 1_792_000_000_000_000_000
    starts = [0]
    for i in range(15):
        starts.append(starts[-1] + 30 + 17 * (i * i % 5))
    ups = [base + t * MS for t in starts]
    lag = [0.1] * 16
    lag[4] = 3.0
    copies = [u + int((5 + lag[i] - 8 * (i >= 13)) * MS + 1e-3 * (u - base))
              for i, u in enumerate(ups)]
    return ups, copies[lost:]


@pytest.mark.parametrize("lost", [0, 1, 2])
def test_clock_pairs_and_alignment(lost):
    ups, copies = drifting(lost)
    shift, pairs = sr.clock_pairs(ups, copies)
    assert shift == lost and pairs == list(zip(ups[lost:], copies))
    c = sr.clock_check(pairs)
    assert c["copies_before_their_upload"] == 3
    kernel = (copies[2] + 1000, copies[3] - 1000, "k", True)
    events = [(c, c + 1000, sr.PINNED_HTOD, False) for c in copies]
    moved = sr.aligned(events + [kernel, (0, 1, "early", True)], pairs)
    # each copy lands on its upload span's start, and what lies between
    # two copies moves by their differences, interpolated
    assert [e[0] for e in moved[:len(copies)]] == ups[lost:]
    d2, d3 = copies[2] - ups[lost + 2], copies[3] - ups[lost + 3]
    a, b = moved[len(copies)][:2]
    span = copies[3] - copies[2]
    assert a == pytest.approx(kernel[0] - d2 - (d3 - d2) * 1000 / span,
                              abs=1)
    assert b == pytest.approx(kernel[1] - d3 + (d3 - d2) * 1000 / span,
                              abs=1)
    # held past the first pair
    assert moved[-1][:2] == (-pairs[0][1] + pairs[0][0],
                             1 - pairs[0][1] + pairs[0][0])
    assert sr.clock_pairs(ups[:1], copies[:1]) == (None, [])


def test_quantities_chunked():
    q = sr.quantities(one_decode(), frames=2)
    assert q["chunk_wait_ms_per_frame"] == pytest.approx(7)
    assert q["slot_wait_ms_per_frame"] == pytest.approx(0.5)
    assert q["fill_wait_ms_per_frame"] == pytest.approx(2.5)
    assert q["ramp_ms_per_decode"] == pytest.approx(13)
    assert q["dispatch_offcpu_ms_per_frame"] == pytest.approx(1)
    # the per-picture tail is the latency path's
    assert q["picture_host_ms_p95"] is None
    assert q["deliver_wait_ms_p95"] is None
    assert sr.quantities([], frames=0)["ramp_ms_per_decode"] is (
        None)


def live_records(n):
    """n pictures of the latency path, picture i taking i ms to deliver."""
    out = []
    for i in range(n):
        t = 100 * i
        out += [rec("decode", "MainThread", i, t, t + 10 + i),
                rec("tokenize", "MainThread", i, t + 1, t + 2),
                rec("prepare", "MainThread", i, t + 2, t + 4),
                rec("dispatch", "MainThread", i, t + 4, t + 7),
                rec("route", "MainThread", i, t + 8, t + 9 + i),
                rec("deliver", "MainThread", i, t + 8, t + 8 + i)]
    return out


def test_quantities_latency_path_and_tail():
    recs = live_records(40)
    q = sr.quantities(recs, frames=40)
    assert q["picture_host_ms_p95"] == pytest.approx(6)
    assert q["deliver_wait_ms_p95"] == pytest.approx(37)
    assert q["ramp_ms_per_decode"] is None
    w = Window(latencies_s=[(11 + i) / 1e3 for i in range(40)],
               feed_late_s=[0.001] * 40)
    tail = sr.live_tail(recs, w)
    assert tail["pictures"] == 3 and tail["latency_p95_ms"] == (
        pytest.approx(48))
    assert tail["mean"]["deliver"] == pytest.approx(38)
    assert tail["mean"]["feed_late"] == pytest.approx(1)
    # pictures 37, 38, 39 of a cycle of four distinct pictures I P B B
    typed = sr.live_tail(recs, w, [1, 2, 3, 3])
    assert typed["types"] == {"P": 1, "B": 2}
    # spans that do not pair with the latencies are not split
    assert sr.live_tail(recs[:6], w) == {}
