"""PyTorch port, the command-line entry points on the CPU: the CLI
(``tiny_mp2v_dec_tpu_torch.cli``) against the JAX package's CLI with the
same arguments, byte for byte (``--mesh rows``, ``--golden`` and
``--hosts`` too), the device it refuses on a host without a GPU, and the
bench
(``tiny_mp2v_dec_tpu_torch.bench``): its result line, its hash check and
that it writes no file."""
import builtins
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from m2v_encoder import encode_stream, random_picture  # noqa: E402
from test_error_containment import _corrupt_slice  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.cli import main as jax_cli  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402
from tiny_mp2v_dec_tpu_torch import bench  # noqa: E402
from tiny_mp2v_dec_tpu_torch.cli import main as port_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the bench's lines that decode the committed 1080p streams
LINES_OFF = ["--no-capacity", "--no-latency", "--no-host-delivery"]


def _cli_stream() -> bytes:
    """``tests/test_cli.py``'s stream: seed 11, I P B at 48x32 4:2:0."""
    rng = np.random.default_rng(11)
    pics = []
    for i, pct in enumerate((H.PCT_I, H.PCT_P, H.PCT_B)):
        p = random_picture(rng, 3, 2, H.CHROMA_420, pct)
        p.temporal_reference = i
        pics.append(p)
    return encode_stream(48, 32, H.CHROMA_420, pics)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The CLI stream, and the same stream with one slice of its B picture
    (decode order 2) corrupted as ``test_error_containment`` corrupts it."""
    d = tmp_path_factory.mktemp("cli")
    data = _cli_stream()
    clean, corrupt = d / "in.m2v", d / "corrupt.m2v"
    clean.write_bytes(data)
    corrupt.write_bytes(_corrupt_slice(data, 2, 1))
    return {"clean": str(clean), "corrupt": str(corrupt)}


@pytest.mark.parametrize("stream,args", [
    ("clean", []),
    ("clean", ["--no-reorder"]),
    ("clean", ["--gop-chunk", "2"]),
    ("clean", ["--size", "48x32", "--chroma", "420"]),
    ("corrupt", ["--on-error", "drop_slice"]),
], ids=["default", "no-reorder", "gop-chunk", "size-chroma", "drop-slice"])
def test_cli_writes_the_jax_cli_bytes(streams, tmp_path, stream, args):
    want, got = tmp_path / "jax.yuv", tmp_path / "port.yuv"
    assert jax_cli(["-v", streams[stream], "-o", str(want), *args]) == 0
    assert port_cli(["-v", streams[stream], "-o", str(got), *args,
                     "--device", "cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert len(want.read_bytes()) == 3 * 48 * 32 * 3 // 2
    if stream == "corrupt":
        # the damage shows: the corrupted B picture differs from the clean
        # decode, the other two frames do not
        clean = b"".join(f.tobytes() for f in decode_stream(
            open(streams["clean"], "rb").read()))
        assert got.read_bytes() != clean


def test_cli_corrupt_stream_raises_by_default(streams, tmp_path):
    with pytest.raises(ValueError):
        port_cli(["-v", streams["corrupt"], "-o", str(tmp_path / "x.yuv"),
                  "--device", "cpu"])


def test_cli_bench_prints_both_lines(streams, capsys):
    assert port_cli(["-v", streams["clean"], "--bench", "2",
                     "--gop-chunk", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("decoded 3 frames in ")
    assert out[1].startswith("bench: 6 frames in ")


@pytest.mark.parametrize("flags", [["--golden"], ["--mesh", "rows"],
                                   ["--hosts", "2"],
                                   ["--hosts", "2", "--device", "cuda"]],
                         ids=["golden", "mesh", "hosts", "hosts-cuda"])
def test_cli_refuses_what_is_not_ported(streams, tmp_path, flags):
    """``--golden``, ``--mesh rows`` and ``--hosts 2``, each refused until
    its module was ported, write the JAX CLI's bytes with the same flags
    (``--device cpu`` on the port); ``--hosts 2 --device cuda`` on a host
    with no CUDA device visible exits non-zero from its workers and writes
    no file."""
    out = tmp_path / "out.yuv"
    if flags[-1] == "cuda":
        proc = subprocess.run(
            [sys.executable, "-m", "tiny_mp2v_dec_tpu_torch.cli", "-v",
             streams["clean"], "-o", str(out), *flags],
            cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**{k: v for k, v in os.environ.items()
                    if k != "PYTHONPATH"}, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert not out.exists()
        return
    want = tmp_path / "jax.yuv"
    assert jax_cli(["-v", streams["clean"], "-o", str(want), *flags]) == 0
    assert port_cli(["-v", streams["clean"], "-o", str(out), *flags,
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == want.read_bytes()
    assert len(want.read_bytes()) == 3 * 48 * 32 * 3 // 2


@pytest.fixture(scope="module")
def bench_stream(tmp_path_factory):
    """A small IPB stream with the record the bench holds it to: its
    sha256 and the golden model's YUV (which the JAX package's decoder
    equals, ``tests/test_torch_fixture.py``)."""
    d = tmp_path_factory.mktemp("bench")
    data = _cli_stream()
    frames = decode_stream(data)
    yuv = b"".join(f.tobytes() for f in frames)
    meta = {"stream_sha256": hashlib.sha256(data).hexdigest(),
            "stream_bytes": len(data),
            "yuv_sha256": hashlib.sha256(yuv).hexdigest(),
            "yuv_bytes": len(yuv), "frames": len(frames)}
    path = d / "small.m2v"
    path.write_bytes(data)
    (d / "small.json").write_text(json.dumps(meta))
    return path, meta


def _bench(path, *extra):
    return bench.main(["--device", "cpu", "--stream", str(path),
                       "--repeats", "1", "--warmup", "0", *LINES_OFF,
                       *extra])


def test_bench_prints_the_four_keys_last(bench_stream, capsys):
    path, _ = bench_stream
    assert _bench(path) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "small_decode_throughput"
    assert last["unit"] == "frames/s/cpu"
    assert last["value"] > 0 and last["vs_baseline"] == 0.0
    lines = err.splitlines()
    assert lines[0].startswith("# best of 1: 3 frames in ")
    assert lines[1].startswith("# hash: 3 frames, YUV sha256 ")
    assert lines[2].startswith("# device cpu")


def test_bench_repeats_the_stream(bench_stream, capsys):
    path, _ = bench_stream
    assert _bench(path, "--repeat", "3", "--repeats", "2") == 0
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1])["metric"] == (
        "small_x3_decode_throughput")
    assert "# best of 2: 9 frames in " in err


@pytest.mark.parametrize("key", ["yuv_sha256", "stream_sha256"])
def test_bench_fails_on_a_wrong_hash(bench_stream, tmp_path, capsys, key):
    path, meta = bench_stream
    bad = tmp_path / "small.m2v"
    bad.write_bytes(path.read_bytes())
    (tmp_path / "small.json").write_text(json.dumps(
        {**meta, key: "0" * 64}))
    assert _bench(bad) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "FAILED" in err and "0" * 64 in err


def _repo_files():
    """Names and mtimes of the repository's top-level files and of
    ``tests/data``, the places a bench would write its record."""
    out = {}
    for d in (REPO, os.path.join(REPO, "tests", "data")):
        for name in os.listdir(d):
            path = os.path.join(d, name)
            if os.path.isfile(path):
                out[path] = os.path.getmtime(path)
    return out


def test_bench_writes_no_file(bench_stream, monkeypatch):
    path, _ = bench_stream
    before = _repo_files()
    writes = []
    real_open = builtins.open

    def watched(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(file)
        return real_open(file, mode, *args, **kw)

    monkeypatch.setattr(builtins, "open", watched)
    assert _bench(path) == 0
    monkeypatch.undo()
    assert writes == []
    assert _repo_files() == before


def test_bench_default_is_the_64_picture_stream():
    """The default stream is the one ``bench.py`` times: 64 pictures of
    ``make_bench_stream``, whose record the fixture tests hold to the JAX
    package; the baseline it is divided by is ``bench.py``'s."""
    from tiny_mp2v_dec_tpu_torch import fixtures
    _, meta = fixtures.load(bench.STREAM)
    assert meta["frames"] == 64
    assert bench.baseline()["fps"] == 790.48
    assert (bench.WARMUP, bench.REPEATS) == (2, 24)
