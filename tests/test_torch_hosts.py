"""PyTorch port, multi-host decode on the CPU: the port's ``split_gops``
against the JAX package's on the streams of ``tests/test_multihost.py`` and
on the committed 16-picture fixtures four times over; ``MultiHostDecoder``
(worker processes, ``device="cpu"``) and ``DistributedDecoder`` (spawned
``gloo`` ranks) against the JAX package's single-process decoder, byte for
byte in display order; and the refusals: ``device="cuda"`` on a host
without a GPU raises through the pool, a ``"device"`` in ``config_kwargs``
is refused."""
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest

pytest.importorskip("torch")

from m2v_encoder import encode_stream, random_picture  # noqa: E402
from test_multihost import SEQ_END, _gop_stream, _multi_gop_stream  # noqa: E402
from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.parallel import hosts as jax_hosts  # noqa: E402
from torch_ranks import decode_rank  # noqa: E402
import tiny_mp2v_dec_tpu_torch as P  # noqa: E402
from tiny_mp2v_dec_tpu_torch.golden.decoder import scan_start_codes  # noqa: E402
from tiny_mp2v_dec_tpu_torch.parallel.distributed import (  # noqa: E402
    merge_display_order)
from tiny_mp2v_dec_tpu_torch.parallel.hosts import (  # noqa: E402
    MultiHostDecoder, split_gops)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = ("bench_1080p_420_16", "interlaced_1080_422_16",
            "natural_576_420_16")
# seconds a spawned rank may take to start, decode and report
RANK_TIMEOUT = 120


def _offsets(data, code):
    return [int(o) for o in scan_start_codes(data) if data[o + 3] == code]


def _open_gop():
    """Two GOPs, the second open (closed_gop cleared), and the same with the
    second sequence header removed (test_split_gops_open_gop_stays_attached)."""
    b = bytearray(_multi_gop_stream(2))
    gops = _offsets(bytes(b), H.GROUP_START_CODE)
    b[gops[1] + 4 + 3] &= ~0x40
    data = bytes(b)
    sh = _offsets(data, H.SEQUENCE_HEADER_CODE)
    return data, data[:sh[1]] + data[gops[1]:]


def _seq_header_before_p():
    """test_split_no_cut_at_seq_header_before_non_I_picture's stream."""
    a, b = _gop_stream(70, n_pics=4), _gop_stream(71, n_pics=4)
    gop = _offsets(b, H.GROUP_START_CODE)[0]
    gop_end = next(int(o) for o in scan_start_codes(b) if o > gop)
    return a[:-len(SEQ_END)] + b[:gop] + b[gop_end:]


def _quant_matrix_live():
    """test_split_no_cut_while_quant_matrix_extension_live's two streams."""
    rng = np.random.default_rng(72)
    qm = H.QuantMatrixExtension(
        load_intra_quantiser_matrix=1,
        intra_quantiser_matrix=np.clip(
            rng.integers(1, 200, 64), 1, 255).astype(np.uint8))
    pics = []
    for i, pct in enumerate([H.PCT_I, H.PCT_P, H.PCT_P, H.PCT_P]):
        p = random_picture(rng, 4, 3, H.CHROMA_420, pct)
        p.temporal_reference = i
        if i == 1:
            p.qmext = qm
        pics.append(p)
    a = encode_stream(64, 48, H.CHROMA_420, pics)
    b = _gop_stream(73, n_pics=4)
    gop = _offsets(b, H.GROUP_START_CODE)[0]
    return a[:-len(SEQ_END)] + b, a[:-len(SEQ_END)] + b[gop:]


def _split_cases():
    open_gop, open_gop_no_sh = _open_gop()
    qm_sh, qm_no_sh = _quant_matrix_live()
    return {
        "boundaries": (_multi_gop_stream(3, n_pics=4), [4, 4, 4]),
        "open-gop": (open_gop, None),
        "open-gop-no-seq-header": (open_gop_no_sh, [8]),
        "seq-header-before-p": (_seq_header_before_p(), [8]),
        "quant-matrix-live": (qm_no_sh, [8]),
        "quant-matrix-seq-header": (qm_sh, [4, 4]),
        "end-codes": (_gop_stream(80) + _gop_stream(81), [4, 4]),
    }


@pytest.mark.parametrize("case", list(_split_cases()))
def test_split_gops_equals_jax(case):
    data, pictures = _split_cases()[case]
    got, want = split_gops(data), jax_hosts.split_gops(data)
    assert [(c.data, c.n_pictures, c.index) for c in got] == \
        [(c.data, c.n_pictures, c.index) for c in want]
    if pictures is not None:
        assert [c.n_pictures for c in got] == pictures


@pytest.mark.parametrize("name", FIXTURES)
def test_split_gops_cuts_a_fixture_four_times_over(name):
    """The fixture's bytes four times over (each copy with its sequence end
    code): four closed chunks of 16 pictures, each the fixture up to its
    end code."""
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = f.read()
    got = split_gops(data * 4)
    assert [(c.data, c.n_pictures, c.index) for c in got] == \
        [(c.data, c.n_pictures, c.index)
         for c in jax_hosts.split_gops(data * 4)]
    assert [(c.n_pictures, c.index) for c in got] == [(16, i)
                                                     for i in range(4)]
    assert data.endswith(SEQ_END)
    assert all(c.data == data[:-len(SEQ_END)] for c in got)


def _single(data):
    return [f.tobytes() for f in MP2VDecoder(DecoderConfig()).decode(data)]


@pytest.mark.parametrize("n_hosts,kwargs", [
    (1, {}), (2, {"config_kwargs": {"gop_chunk": 4}, "cores_per_host": 1})],
    ids=["1", "2-chunk4-pinned"])
def test_multihost_equals_jax(n_hosts, kwargs):
    data = _multi_gop_stream(4, n_pics=4)
    want = _single(data)
    with MultiHostDecoder(n_hosts, device="cpu", **kwargs) as mh:
        mh.warmup(data)
        assert not mh.launches
        got = mh.decode(data)
        # the CPU runs the kernels' plain versions: no launch
        assert not mh.launches
    assert len(got) == len(want) == 16
    assert got == want


def test_multihost_decodes_every_sequence_where_one_decoder_stops():
    """Sequences joined with their end codes: one decoder stops at the
    first end code, as the reference does; ``split_gops`` closes a chunk
    at each, so the multi-host decoder decodes them all (as in the JAX
    package)."""
    a, b = _gop_stream(80), _gop_stream(81)
    data = a + b
    one = P.MP2VDecoder(P.DecoderConfig(device="cpu")).decode(data)
    assert [f.tobytes() for f in one] == _single(a)
    with MultiHostDecoder(2, device="cpu") as mh:
        got = mh.decode(data)
    assert got == _single(a) + _single(b)
    with jax_hosts.MultiHostDecoder(1) as jmh:
        assert jmh.decode(data) == got


def test_multihost_cuda_without_a_gpu_raises_through_the_pool(monkeypatch):
    """Workers that see no CUDA device (none visible to them) raise from
    ``warmup`` and ``decode``; nothing falls back to the CPU."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    data = _gop_stream(82)
    with MultiHostDecoder(2) as mh:
        assert mh.config_kwargs["device"] == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.warmup(data)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.decode(data)
    with pytest.raises(ValueError, match="device"):
        MultiHostDecoder(1, device="cpu", config_kwargs={"device": "cpu"})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world,init", [(2, "tcp"), (4, "tcp"), (2, "env")])
def test_distributed_decode_equals_jax(world, init):
    """``world`` spawned ``gloo`` ranks (the recipe of
    ``test_jax_distributed_decode``): the merge of their results equals
    the JAX package's single decode, the ranks' chunks are disjoint and
    cover the stream, and every rank sees the whole ('host', 'chip')
    grid."""
    data = _multi_gop_stream(4, seed0=90, n_pics=4)
    want = _single(data)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=decode_rank,
                         args=(r, world, port, data, init, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = []
    try:
        for _ in range(world):
            results.append(q.get(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    errs = [r for r in results if r[1] == "error"]
    assert not errs, f"rank failures: {errs}"
    assert [p.exitcode for p in procs] == [0] * world
    assert sorted(r[0] for r in results) == list(range(world))
    for rank, w, shape, idxs, res in results:
        assert w == world
        assert shape == {"host": world, "chip": 1}
        assert idxs == [i for i in range(4) if i % world == rank]
        assert [i for i, _ in res] == idxs
    assert sorted(i for r in results for i in r[3]) == [0, 1, 2, 3]
    assert merge_display_order([r[4] for r in results]) == want
