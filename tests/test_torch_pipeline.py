"""PyTorch port, the chunk pipeline of ``MP2VDecoder`` on the CPU: the
caller's thread tokenizes, a fill thread prepares (``GopRecon.prepare``)
and a dispatch thread uploads, reconstructs and routes, at most two chunks
in flight, three staging slots per blob shape.

The stress tests of ``tests/test_pipeline_stress.py`` (long streams,
decode/reset cycles, a pool of one) held against the golden model and the
JAX decoder; an overlap test that no synchronous decoder can pass; the
staging slots' reuse; and worker exceptions, raised from ``decode`` and
followed by a clean decode after ``reset``; and the reuse of prepared
chunks' token arrays.  Every decode of the port runs under
:func:`torch_parity.watchdog`, so a deadlock fails the test instead of
hanging the suite."""
import gc
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_error_containment import _corrupt_slice, _stream  # noqa: E402
from test_pipeline_stress import _long_stream  # noqa: E402
from torch_parity import WATCHDOG_S, assert_frames_equal, watchdog  # noqa: E402,E501
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402

# seconds a held stage waits for the event that releases it
HOLD_S = 30.0
TESTS = os.path.dirname(os.path.abspath(__file__))
# a decode wedged for good, in a process of its own: a dispatcher that
# never releases its staging slot, so that the third prepare waits forever
# on the fill thread and the dispatch thread waits for it
WEDGED = """
import sys
sys.path[:0] = sys.argv[1:3]
import numpy as np
from torch_parity import ipb_stream, watchdog
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon
GopRecon.mark_dispatched = lambda self, staged, guard: None
data = ipb_stream(np.random.default_rng(3), 2, 2, 1)
dec = MP2VDecoder(DecoderConfig(gop_chunk=1, device="cpu"))
watchdog(lambda: dec.decode(data), timeout=float(sys.argv[3]))
"""


def _decoder(**kw):
    return MP2VDecoder(DecoderConfig(device="cpu", **kw))


def _held_against_both(data, got, **jax_kw):
    assert_frames_equal(decode_stream(data), got)
    assert_frames_equal(JaxDecoder(JaxConfig(**jax_kw)).decode(data), got)


def test_many_chunks_through_worker_bitexact():
    """96 pictures in 24 chunks of 4: no deadlock, every frame equal, and
    never more than 2 chunk jobs in flight when a picture is tokenized."""
    data = _long_stream(96)
    dec = _decoder(gop_chunk=4)
    tokenize, in_flight = dec.tokenize_picture, []

    def tokenize_picture(*args, **kw):
        in_flight.append(len(dec._chunk_jobs))
        return tokenize(*args, **kw)

    dec.tokenize_picture = tokenize_picture
    got = watchdog(lambda: dec.decode(data))
    assert len(got) == 96
    _held_against_both(data, got, gop_chunk=4)
    assert max(in_flight) == 2


def test_repeated_flush_reset_cycles():
    """100 decode/reset cycles of 8 pictures on one decoder: the threads,
    the staging slots and the reorder state recycle every time."""
    data = _long_stream(8, seed=21)
    dec = _decoder(gop_chunk=4)

    def run():
        for i in range(100):
            got = dec.decode(data)
            assert len(got) == 8, f"cycle {i}"
            dec.reset()
        return got

    _held_against_both(data, watchdog(run), gop_chunk=4)
    recon, = dec._recons.values()
    assert recon._seq_prep == recon._seq_disp == 200


def test_small_pool_backpressure():
    """``pictures_pool_size=1``: routing waits on the oldest frame of an
    earlier chunk, on the dispatch thread, and the decode completes."""
    data = _long_stream(24, seed=33)
    got = watchdog(lambda: _decoder(gop_chunk=4,
                                    pictures_pool_size=1).decode(data))
    _held_against_both(data, got, gop_chunk=4, pictures_pool_size=1)


def test_stages_overlap_on_three_threads(monkeypatch):
    """Chunk 0's dispatch waits until the caller's thread tokenizes chunk
    2's first picture.  A decoder that dispatches on the caller's thread
    never gets there: its wait times out and the decode raises.  Tokenize
    runs on the caller's thread, prepare on the fill thread and dispatch on
    the dispatch thread."""
    data = _long_stream(16, seed=5)
    dec = _decoder(gop_chunk=4)
    chunk2 = threading.Event()
    threads = {"prepare": set(), "dispatch": set()}
    tokenized, waited = [], []
    tokenize = dec.tokenize_picture
    prepare, dispatch = GopRecon.prepare, GopRecon.dispatch

    def tokenize_picture(*args, **kw):
        tokenized.append(threading.current_thread().name)
        if len(tokenized) == 9:             # chunk 2's first picture
            chunk2.set()
        return tokenize(*args, **kw)

    def recording_prepare(self, *args):
        threads["prepare"].add(threading.current_thread().name)
        return prepare(self, *args)

    def held_dispatch(self, *args, **kw):
        threads["dispatch"].add(threading.current_thread().name)
        if not waited:
            waited.append(chunk2.wait(HOLD_S))
            assert waited[0], ("chunk 0 was dispatched before chunk 2 was "
                               "tokenized: the stages do not overlap")
        return dispatch(self, *args, **kw)

    dec.tokenize_picture = tokenize_picture
    monkeypatch.setattr(GopRecon, "prepare", recording_prepare)
    monkeypatch.setattr(GopRecon, "dispatch", held_dispatch)
    caller = []

    def run():
        caller.append(threading.current_thread().name)
        return dec.decode(data)

    got = watchdog(run)
    assert waited == [True]
    assert_frames_equal(decode_stream(data), got)
    assert set(tokenized) == set(caller)
    assert [n.split("_")[0] for n in threads["prepare"]] == ["mp2v-fill"]
    assert [n.split("_")[0] for n in threads["dispatch"]] == [
        "mp2v-dispatch"]


def test_every_dispatch_uploads_what_its_prepare_wrote(monkeypatch):
    """Each chunk's blob is copied when ``prepare`` returns it; each
    dispatch waits until the next chunk is prepared too, so that the
    fill thread runs as far ahead as the bound lets it.  Every upload
    carries the bytes its prepare wrote, the three slots of the one blob
    shape are all used, and no more than ``N_SLOTS - 1`` chunks are ever
    prepared and not dispatched."""
    data = _long_stream(40, seed=7)
    n_chunks = 10
    dec = _decoder(gop_chunk=4)
    written, uploaded, blobs, pending = [], [], set(), []
    cv = threading.Condition()
    prepare, dispatch = GopRecon.prepare, GopRecon.dispatch
    gop = GopRecon._gop

    def copying_prepare(self, *args):
        staged = prepare(self, *args)
        with cv:
            written.append(staged[1].tobytes())
            blobs.add(id(staged[1]))
            cv.notify_all()
        return staged

    def held_dispatch(self, *args, **kw):
        i = len(uploaded)
        with cv:
            if not cv.wait_for(lambda: len(written) >= min(i + 2, n_chunks),
                               HOLD_S):
                raise AssertionError(f"chunk {i + 1} was never prepared")
        pending.append(self._seq_prep - self._seq_disp)
        return dispatch(self, *args, **kw)

    def recording_gop(self, blob, *args, **kw):
        uploaded.append(blob.numpy().tobytes())
        return gop(self, blob, *args, **kw)

    monkeypatch.setattr(GopRecon, "prepare", copying_prepare)
    monkeypatch.setattr(GopRecon, "dispatch", held_dispatch)
    monkeypatch.setattr(GopRecon, "_gop", recording_gop)
    got = watchdog(lambda: dec.decode(data))
    assert_frames_equal(decode_stream(data), got)
    assert len(uploaded) == len(written) == n_chunks
    for i, (u, w) in enumerate(zip(uploaded, written)):
        assert u == w, f"chunk {i}: the upload differs from its blob"
    recon, = dec._recons.values()
    slots, = recon._stage.values()
    assert blobs == {id(s.blob) for s in slots} and len(blobs) == 3
    assert max(pending) == GopRecon.N_SLOTS - 1


def test_fill_error_raises_from_decode_then_reset_decodes(monkeypatch):
    """A ``prepare`` that raises on the fill thread (chunk 2 of 6) makes
    ``decode`` raise it; after ``reset`` the same decoder decodes the
    stream as the golden model does, and its threads end with it."""
    data = _long_stream(24, seed=13)
    dec = _decoder(gop_chunk=4)
    prepare = GopRecon.prepare
    calls = []

    def failing_prepare(self, *args):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("prepare failed on the fill thread")
        return prepare(self, *args)

    monkeypatch.setattr(GopRecon, "prepare", failing_prepare)
    with pytest.raises(RuntimeError, match="fill thread"):
        watchdog(lambda: dec.decode(data))
    assert calls[2].startswith("mp2v-fill")
    monkeypatch.undo()
    dec.reset()
    assert_frames_equal(decode_stream(data), watchdog(
        lambda: dec.decode(data)))
    recon, = dec._recons.values()
    assert recon._seq_prep == recon._seq_disp
    workers = list(dec._fill_pool._threads | dec._disp_pool._threads)
    assert len(workers) == 2
    del dec
    gc.collect()
    for th in workers:
        th.join(HOLD_S)
        assert not th.is_alive(), th.name


def test_failed_upload_releases_its_slot(monkeypatch):
    """Every upload raises on the dispatch thread: ``decode`` raises, and
    each failed dispatch still gives its chunk's place back, so that the
    same recon prepares again after ``reset`` instead of waiting
    forever."""
    data = _long_stream(24, seed=17)
    dec = _decoder(gop_chunk=4)

    def failing_upload(self, staged):
        raise RuntimeError("upload failed")

    monkeypatch.setattr(GopRecon, "upload", failing_upload)
    with pytest.raises(RuntimeError, match="upload failed"):
        watchdog(lambda: dec.decode(data))
    monkeypatch.undo()
    dec.reset()
    recon, = dec._recons.values()
    assert recon._seq_prep == recon._seq_disp > 0
    assert_frames_equal(decode_stream(data), watchdog(
        lambda: dec.decode(data)))


def test_raise_mode_with_chunks_in_flight_then_reset():
    """``on_error="raise"`` at ``gop_chunk=4``: picture 9's bad slice makes
    the caller's tokenize raise the JAX decoder's ``ValueError`` while
    chunks 0 and 1 are in flight; after ``reset`` the same decoder decodes
    a clean stream as the golden model does."""
    data, _ = _stream(seed=19, pattern="IPBBPBBPBBPB", mbw=4, mbh=4)
    corrupt = _corrupt_slice(data, 9, 3)
    with pytest.raises(ValueError) as want:
        JaxDecoder(JaxConfig(gop_chunk=4)).decode(corrupt)
    dec = _decoder(gop_chunk=4)
    with pytest.raises(ValueError) as got:
        watchdog(lambda: dec.decode(corrupt))
    assert str(got.value) == str(want.value)
    assert len(dec._chunk_jobs) == 2
    dec.reset()
    assert not dec._chunk_jobs
    clean = watchdog(lambda: dec.decode(data))
    assert len(clean) == 12
    assert_frames_equal(decode_stream(data), clean)


def test_latency_path_stays_on_the_callers_thread(monkeypatch):
    """``gop_chunk=0`` prepares and dispatches every picture on the
    caller's thread and starts no worker."""
    data = _long_stream(8, seed=23)
    dec = _decoder(gop_chunk=0)
    dispatch = GopRecon.dispatch
    threads = set()

    def recording_dispatch(self, *args, **kw):
        threads.add(threading.current_thread().name)
        return dispatch(self, *args, **kw)

    monkeypatch.setattr(GopRecon, "dispatch", recording_dispatch)
    caller = []

    def run():
        caller.append(threading.current_thread().name)
        return dec.decode(data)

    assert_frames_equal(decode_stream(data), watchdog(run))
    assert threads == set(caller)
    assert dec._fill_pool is None and dec._disp_pool is None


@pytest.mark.parametrize("gop_chunk", [0, 4])
def test_prepared_tokens_are_reused(gop_chunk):
    """Once a chunk is prepared its tokens go back to the decoder, and the
    next pictures are tokenized into their arrays: 24 pictures take a few
    sets of token arrays, not 24, and decode as the golden model does."""
    data = _long_stream(24, seed=31)
    dec = _decoder(gop_chunk=gop_chunk)
    tokenize, arrays = dec.tokenize_picture, set()

    def tokenize_picture(*args, **kw):
        tokens = tokenize(*args, **kw)
        arrays.add(tokens.cblk.__array_interface__["data"][0])
        return tokens

    dec.tokenize_picture = tokenize_picture
    assert_frames_equal(decode_stream(data), watchdog(
        lambda: dec.decode(data)))
    # at most 4 chunks' worth: the one being tokenized and up to 3
    # submitted before it (2 in flight, one more until its predecessor
    # is joined); one picture's on the latency path
    assert len(arrays) <= (4 * gop_chunk if gop_chunk else 1)
    # every set comes back, up to the two chunks' worth a decoder keeps
    assert dec._spare_tokens.maxlen == 2 * max(gop_chunk, 1)
    assert len(dec._spare_tokens) == min(len(arrays),
                                         dec._spare_tokens.maxlen)


def test_reused_tokens_equal_fresh_ones():
    """Tokens written into another picture's arrays (``out=``) equal those
    of a fresh tokenize, field for field: the I picture goes into the
    arrays of a B picture, whose vectors and flags must not survive."""
    data = _long_stream(6, seed=37)
    fresh = _decoder(num_threads=1).tokenize_stream(data)
    spare = fresh[2][0]
    assert fresh[2][2].picture_coding_type == 3 and spare.bwd.any()
    dec = _decoder(num_threads=1)
    dec._spare_tokens.append(spare)
    reused = dec.tokenize_stream(data)
    assert reused[0][0] is spare and not dec._spare_tokens
    again = _decoder(num_threads=1).tokenize_stream(data)
    for (a, _, _), (b, _, _) in zip(again, reused):
        k = a.n_coded_blocks
        assert (b.n_coded_blocks, b.bad_slices) == (k, a.bad_slices)
        for name in ("cblk", "cblk_idx", "row_nnz"):
            np.testing.assert_array_equal(getattr(a, name)[:k],
                                          getattr(b, name)[:k])
        for name in ("intra", "fwd", "bwd", "field_pred", "dct_type", "mv",
                     "mvfs", "coded"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


@pytest.mark.parametrize("n_pictures", [1, 5, 9])
def test_slot_count_per_shape(n_pictures):
    """However many chunks a stream has, a blob shape gets at most
    ``N_SLOTS`` slots, taken in turn, as plain numpy on the CPU."""
    data = _long_stream(n_pictures, seed=29)
    dec = _decoder(gop_chunk=1)
    assert_frames_equal(decode_stream(data), watchdog(
        lambda: dec.decode(data)))
    recon, = dec._recons.values()
    slots = [s for shape in recon._stage.values() for s in shape if s]
    assert len(slots) == min(n_pictures, GopRecon.N_SLOTS)
    assert all(s.pinned is None and isinstance(s.blob, np.ndarray)
               for s in slots)


def test_watchdog_fails_a_deadlock_and_the_process_exits():
    """A wedged decode under :func:`torch_parity.watchdog` fails with every
    thread's stack, the fill thread's wait among them, and its process
    then exits with status 1 instead of waiting at exit for the stuck
    worker threads, which would hang the suite."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-c", WEDGED, TESTS, os.path.dirname(TESTS), "2"],
        capture_output=True, text=True, timeout=WATCHDOG_S, env=env)
    assert p.returncode == 1, p.stderr[-2000:]
    assert "deadlock: the work exceeded the 2 s watchdog" in p.stderr
    assert "--- thread mp2v-fill" in p.stderr
    assert "self._cv.wait()" in p.stderr
