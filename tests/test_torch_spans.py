"""PyTorch port, the decoder's spans (``runtime/spans.py``) on the CPU: each
span on its thread and inside its parent, at ``gop_chunk=4`` (three
threads) and ``gop_chunk=0`` (the caller's alone); the spans summing to
the counters they share their clock readings with; one chunk's spans
joined by its number across the threads; nothing recorded while off;
``stop()`` clearing the log; and a fill that raises leaving the log
whole.  Every decode runs under :func:`torch_parity.watchdog`."""
import threading
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_pipeline_stress import _long_stream  # noqa: E402
from torch_parity import assert_frames_equal, ipb_stream, watchdog  # noqa: E402,E501
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch.runtime.spans import Spans  # noqa: E402

N_PICTURES = 12
# the span that encloses each span on its thread: "decode" on the
# caller's thread, none on a worker thread
PARENT = {"decode": None, "tokenize": "decode", "chunk_wait": "decode",
          "prepare": "decode", "slot_wait": "prepare",
          "fill_wait": "decode", "dispatch": "decode", "upload": "dispatch",
          "recon": "dispatch", "route": "decode", "pool_wait": "route",
          "deliver": "route"}
# the spans each thread records: caller, fill, dispatch
THREE_THREADS = (
    {"decode", "tokenize", "chunk_wait", "route", "pool_wait", "deliver"},
    {"prepare", "slot_wait"},
    {"fill_wait", "dispatch", "upload", "recon", "route", "pool_wait",
     "deliver"})
ONE_THREAD = ({"decode", "tokenize", "prepare", "slot_wait", "dispatch",
               "upload", "recon", "route", "pool_wait", "deliver"},)
# the counters and the spans that time the same intervals
COUNTERS = {"tokenize_s": "tokenize", "fill_s": "prepare",
            "device_s": "dispatch", "slot_wait_s": "slot_wait",
            "fill_wait_s": "fill_wait", "chunk_wait_s": "chunk_wait"}


class _Event:
    """A stand-in for a chunk's CUDA event on the CPU, so that a small
    picture pool waits (span ``pool_wait``)."""

    def synchronize(self):
        pass


def _decoder(gop_chunk, **kw):
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk, device="cpu",
                                    pictures_pool_size=1, **kw))
    route = dec._route_frame

    def route_with_event(pending, pct):
        pending.event = _Event()
        route(pending, pct)

    dec._route_frame = route_with_event
    return dec


@pytest.fixture(scope="module")
def data():
    return _long_stream(N_PICTURES, seed=41)


def _traced(dec, data):
    dec.spans.start()
    frames = watchdog(lambda: dec.decode(data))
    return frames, dec.spans.stop()


def _by_thread(records):
    out = defaultdict(list)
    for r in records:
        out[r[1]].append(r)
    return out


def _parents(records):
    """Each record of one thread with the innermost record that encloses
    it (or None); asserts that the thread's spans nest."""
    recs = sorted(records, key=lambda r: (r[3], -r[4]))
    stack, out = [], []
    for r in recs:
        assert r[3] <= r[4] and r[5] >= 0, r
        while stack and stack[-1][4] <= r[3]:
            stack.pop()
        if stack:
            assert r[4] <= stack[-1][4], f"{r} overlaps {stack[-1]}"
        out.append((r, stack[-1] if stack else None))
        stack.append(r)
    return out


@pytest.mark.parametrize("gop_chunk,threads", [(4, THREE_THREADS),
                                               (0, ONE_THREAD)])
def test_every_span_on_its_thread_and_nested(data, gop_chunk, threads):
    dec = _decoder(gop_chunk)
    caller = []

    def run():
        caller.append(threading.current_thread().name)
        return dec.decode(data)

    dec.spans.start()
    frames = watchdog(run)
    records = dec.spans.stop()
    assert_frames_equal(decode_stream(data), frames)
    by = _by_thread(records)
    names = [caller[0], "mp2v-fill_0", "mp2v-dispatch_0"][:len(threads)]
    assert sorted(by) == sorted(names)
    for name, want in zip(names, threads):
        assert {r[0] for r in by[name]} == want, name
        for r, parent in _parents(by[name]):
            want_parent = PARENT[r[0]]
            if name != caller[0] and want_parent == "decode":
                want_parent = None
            assert (parent[0] if parent else None) == want_parent, r
    assert sum(r[0] == "decode" for r in records) == 1


@pytest.mark.parametrize("gop_chunk", [4, 0])
def test_spans_sum_to_their_counters(data, gop_chunk):
    dec = _decoder(gop_chunk)
    _, records = _traced(dec, data)
    for key, name in COUNTERS.items():
        got = sum(r[4] - r[3] for r in records if r[0] == name) / 1e9
        assert got == pytest.approx(dec.stats[key], rel=1e-9, abs=1e-9), key
    assert 0 < dec.stats["slot_wait_s"] <= dec.stats["fill_s"]
    if gop_chunk:
        assert dec.stats["chunk_wait_s"] > 0 and dec.stats["fill_wait_s"] > 0
    else:
        assert dec.stats["chunk_wait_s"] == dec.stats["fill_wait_s"] == 0


def test_one_chunks_spans_share_its_unit(data):
    dec = _decoder(4)
    _, records = _traced(dec, data)
    units = defaultdict(set)
    for name, thread, unit, *_ in records:
        units[name, thread.split("_")[0]].add(unit)
    chunks = set(range(N_PICTURES // 4))
    for name in ("prepare", "slot_wait"):
        assert units[name, "mp2v-fill"] == chunks, name
    for name in ("fill_wait", "dispatch", "upload", "recon", "route"):
        assert units[name, "mp2v-dispatch"] == chunks, name
    # past two chunks in flight the caller waits for chunk 0, then joins
    # chunks 1 and 2 at the flush
    assert sorted(r[2] for r in records if r[0] == "chunk_wait") == [0, 1, 2]
    pictures = set(range(N_PICTURES))
    assert {r[2] for r in records if r[0] == "tokenize"} == pictures
    delivered = [r[2] for r in records if r[0] == "deliver"]
    assert sorted(delivered) == sorted(pictures)
    # a chunk's pictures are tokenized before its prepare starts
    start = {r[2]: r[3] for r in records if r[0] == "prepare"}
    for r in records:
        if r[0] == "tokenize":
            assert r[4] <= start[r[2] // 4]


@pytest.mark.parametrize("gop_chunk", [4, 0])
def test_off_records_nothing_and_counters_count(data, gop_chunk):
    dec = _decoder(gop_chunk)
    frames = watchdog(lambda: dec.decode(data))
    assert_frames_equal(decode_stream(data), frames)
    assert dec.spans.log is None and dec.spans.stop() == []
    assert all(r.spans is dec.spans for r in dec._recons.values())
    st = dec.stats
    assert st["pictures"] == N_PICTURES and st["bad_slices"] == 0
    for key in ("tokenize_s", "fill_s", "device_s", "output_s"):
        assert st[key] > 0, key
    assert st["slot_wait_s"] <= st["fill_s"]
    # the same decode with spans on counts the same
    dec.reset()
    _traced(dec, data)
    assert (dec.stats["pictures"], dec.stats["bad_slices"]) == (
        N_PICTURES, 0)


def test_stop_clears():
    spans = Spans()
    assert spans.begin() is None
    spans.end(None, "decode", 0)
    spans.start()
    span = spans.begin()
    spans.end(span, "decode", 0)
    records = spans.stop()
    assert [r[0] for r in records] == ["decode"]
    assert records[0][1] == threading.current_thread().name
    assert spans.stop() == [] and spans.log is None
    # a span open across stop() and start() belongs to neither log
    spans.start()
    span = spans.begin()
    spans.stop()
    spans.start()
    spans.end(span, "decode", 1)
    assert spans.stop() == []


def test_fill_that_raises_leaves_no_span_open(data, monkeypatch):
    """Chunk 1's fill raises on the fill thread: ``decode`` raises it, the
    spans recorded are closed and nest, none is chunk 1's ``prepare`` or
    ``dispatch``, and after ``reset`` the next decode records whole."""
    dec = _decoder(4)
    fill = GopRecon._fill
    calls = []

    def failing_fill(self, *args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("fill failed")
        return fill(self, *args)

    monkeypatch.setattr(GopRecon, "_fill", failing_fill)
    dec.spans.start()
    with pytest.raises(RuntimeError, match="fill failed"):
        watchdog(lambda: dec.decode(data))
    dec.reset()
    records = dec.spans.stop()
    for thread in _by_thread(records).values():
        _parents(thread)
    assert not [r for r in records
                if r[0] in ("prepare", "dispatch") and r[2] == 1]
    assert "decode" not in {r[0] for r in records}
    monkeypatch.undo()
    dec.reset()
    frames, records = _traced(dec, data)
    assert_frames_equal(decode_stream(data), frames)
    assert sorted(r[2] for r in records if r[0] == "prepare") == [0, 1, 2]
    for thread in _by_thread(records).values():
        _parents(thread)


@pytest.mark.parametrize("path", ["batch", "rows"])
def test_batch_and_rows_record_tokenize_and_dispatch(path):
    """``decode_batch`` and ``mesh="rows"`` time their tokenize and
    dispatch intervals into the counters and the spans alike."""
    data = ipb_stream(np.random.default_rng(43), 2, 2, H.CHROMA_420)
    if path == "batch":
        dec = MP2VDecoder(DecoderConfig(device="cpu", mesh_devices=2))
        dec.spans.start()
        watchdog(lambda: dec.decode_batch([data, data]))
    else:
        dec = MP2VDecoder(DecoderConfig(device="cpu", mesh="rows",
                                        mesh_devices=2))
        dec.spans.start()
        watchdog(lambda: dec.decode(data))
    records = dec.spans.stop()
    for key in ("tokenize_s", "device_s"):
        name = COUNTERS[key]
        got = sum(r[4] - r[3] for r in records if r[0] == name) / 1e9
        assert got == pytest.approx(dec.stats[key], rel=1e-9, abs=1e-9)
    # two streams of five pictures, a step for each picture of a stream
    tokenized = 10 if path == "batch" else 5
    assert sum(r[0] == "tokenize" for r in records) == tokenized
    assert sum(r[0] == "dispatch" for r in records) == 5
