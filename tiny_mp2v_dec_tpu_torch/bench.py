"""Decode throughput of the port on one NVIDIA GPU: the counterpart of the
repository's ``bench.py``, which times the JAX package.

    python3 -m tiny_mp2v_dec_tpu_torch.bench [--stream NAME] [--repeat K]
        [--repeats N] [--warmup N] [--no-capacity] [--no-latency]
        [--no-host-delivery] [--device cuda|cpu]

Decodes the committed 64-picture 1080p 4:2:0 IBBP stream
(``tests/data/bench_1080p_420_64.m2v``: ``tools/bench_stream.py``'s
``make_bench_stream(64)``, the stream ``bench.py`` times) through
``MP2VDecoder(gop_chunk=16, output_host=False, pictures_pool_size=0)``:
``--warmup`` decodes (2), then ``--repeats`` (24), each a ``reset()`` and a
``decode`` ended by ``torch.cuda.synchronize()``.  The stream's sha256 is
checked against its record (``tests/data/*.json``) before the timing;
after it, one more decode, untimed, is held to the YUV sha256 that the JAX
package decoded from it.  A mismatch exits 1 with no result line.

The last line of standard output is ``bench.py``'s JSON line::

    {"metric": "1080p_420_decode_throughput", "value": <frames/s of the
     best decode>, "unit": "frames/s/chip", "vs_baseline": <value / the
     reference C++ decoder's frames/s in BASELINE_MEASURED.json>}

``#`` lines on standard error, in ``bench.py``'s order: the best decode's
stage seconds per picture with the median and interquartile range of all
the decodes; the hash check with the kernel launches of its decode; two
decoders on two threads (chip capacity); the per-picture latency
(``gop_chunk=0``, no reordering, every frame synchronized, on the 8-picture
stream); host delivery (``output_host=True`` on the 16-picture stream,
timed until every frame's planes are readable on the host); the card, the
host's CPUs and where the baseline was measured.

``--stream`` decodes another committed fixture (or a ``.m2v`` path with
its ``.json`` beside it) ``--repeat`` times over as one stream
(:func:`~.fixtures.repeat_stream`); its metric is named after it and its
``vs_baseline`` is 0, as the baseline was measured on the default stream
alone.  ``--device cpu`` runs the plain PyTorch versions, for tests; its
unit is then ``frames/s/cpu``.
Writes no file.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from . import fixtures
from .ops import _build
from .runtime.decoder import DecoderConfig, MP2VDecoder
from .tools.tbench import card

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = "bench_1080p_420_64"
LATENCY_STREAM = "bench_1080p_420_8"
HOST_STREAM = "bench_1080p_420_16"
METRIC = "1080p_420_decode_throughput"
WARMUP = 2
REPEATS = 24
# best of this many concurrent pairs of decodes, after one warm pair
CAPACITY_RUNS = 4


def baseline() -> dict:
    """``BASELINE_MEASURED.json``: the reference C++ decoder on the default
    stream (its ``fps``, ``cpu_count`` and ``host``), or {} without it."""
    path = os.path.join(_REPO, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def quartiles(xs) -> tuple:
    """(first quartile, median, third quartile) of ``xs``."""
    if len(xs) < 2:
        return xs[0], xs[0], xs[0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return q1, q2, q3


class Bench:
    """The decoders and the synchronize of one device."""

    def __init__(self, device: str):
        self.device = device
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def decoder(self, **kw) -> MP2VDecoder:
        return MP2VDecoder(DecoderConfig(device=self.device, **kw))

    def main_decoder(self) -> MP2VDecoder:
        """The headline's decoder, as ``bench.py`` builds it."""
        return self.decoder(gop_chunk=16, output_host=False,
                            pictures_pool_size=0)

    def decode(self, dec: MP2VDecoder, data: bytes) -> list:
        """One decode of ``data`` from a reset decoder, ended by a
        synchronize."""
        dec.reset()
        frames = dec.decode(data)
        self.sync()
        return frames

    def timed(self, dec, data, repeats: int) -> tuple:
        """``repeats`` timed decodes: (walls in s, each decode's stats,
        frames a decode)."""
        walls, stats, n = [], [], 0
        for _ in range(repeats):
            t0 = time.perf_counter()
            n = len(self.decode(dec, data))
            walls.append(time.perf_counter() - t0)
            stats.append(dict(dec.stats))
        return walls, stats, n

    def capacity(self, data: bytes) -> float:
        """Frames/s of two decoders decoding ``data`` at once on two
        threads: warmed together once, then the best of
        :data:`CAPACITY_RUNS`."""
        decs = [self.main_decoder() for _ in range(2)]
        best, n = math.inf, 0
        with ThreadPoolExecutor(max_workers=2) as ex:
            list(ex.map(lambda d: self.decode(d, data), decs))
            for _ in range(CAPACITY_RUNS):
                t0 = time.perf_counter()
                n = sum(len(f) for f in
                        ex.map(lambda d: self.decode(d, data), decs))
                best = min(best, time.perf_counter() - t0)
        return n / best

    def latency_ms(self, data: bytes) -> float:
        """Wall ms per frame of the picture-at-a-time path (``gop_chunk=0``,
        decode order), each frame synchronized as it is delivered; after two
        warm decodes."""
        dec = self.decoder(gop_chunk=0, output_host=False, reordering=False)
        dec.renderer = lambda frame: self.sync()
        for _ in range(2):
            dec.reset()
            dec.decode(data)
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        return (time.perf_counter() - t0) / max(len(frames), 1) * 1e3

    def host_delivery(self, data: bytes, meta: dict) -> float:
        """Frames/s with host output (``gop_chunk=16, output_host=True``),
        after one warm decode: the window ends when every frame's planes
        are readable on the host.  The frames are then held to the
        stream's record."""
        dec = self.decoder(gop_chunk=16, output_host=True)
        dec.decode(data)
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        # the window ends with every frame's planes read on the host
        sum(f.y.nbytes + f.u.nbytes + f.v.nbytes for f in frames)
        fps = len(frames) / (time.perf_counter() - t0)
        fixtures.check_frames(frames, meta)
        return fps


def card_line(cuda: bool, base: dict) -> str:
    if cuda:
        where = f"card {card()}"
    else:
        where = "device cpu (plain PyTorch versions, no card)"
    return (f"{where}; host {os.cpu_count()} CPUs; baseline "
            f"{base.get('fps', 0.0)} frames/s: the reference C++ decoder "
            f"on another host ({base.get('cpu_count', '?')} CPUs, "
            f"{base.get('host', 'not recorded')}; BASELINE_MEASURED.json)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m tiny_mp2v_dec_tpu_torch.bench",
        description="decode throughput of the port on one NVIDIA GPU")
    ap.add_argument("--stream", default=STREAM, metavar="NAME",
                    help="committed fixture of tests/data, or a .m2v path "
                         "with its .json beside it")
    ap.add_argument("--repeat", type=int, default=1, metavar="K",
                    help="decode the stream K times over as one stream")
    ap.add_argument("--repeats", type=int, default=REPEATS, metavar="N",
                    help="timed decodes (the best sets the value)")
    ap.add_argument("--warmup", type=int, default=WARMUP, metavar="N")
    ap.add_argument("--no-capacity", action="store_true",
                    help="leave out the chip-capacity line")
    ap.add_argument("--no-latency", action="store_true",
                    help="leave out the latency line")
    ap.add_argument("--no-host-delivery", action="store_true",
                    help="leave out the host-delivery line")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu runs the plain PyTorch versions (tests)")
    args = ap.parse_args(argv)
    if args.repeats < 1 or args.repeat < 1 or args.warmup < 0:
        ap.error("--repeats and --repeat must be at least 1, --warmup 0")

    def err(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    try:
        data, meta = fixtures.load(args.stream)
    except ValueError as e:
        err(f"FAILED: {e}")
        return 1
    data = fixtures.repeat_stream(data, args.repeat)
    b = Bench(args.device)
    dec = b.main_decoder()
    for _ in range(args.warmup):
        b.decode(dec, data)
    walls, stats, n_frames = b.timed(dec, data, args.repeats)
    best = min(range(len(walls)), key=walls.__getitem__)
    fps = n_frames / walls[best]
    st = stats[best]
    pics = max(st["pictures"], 1)
    q1, med, q3 = quartiles(walls)
    err(f"best of {args.repeats}: {n_frames} frames in {walls[best]:.4f}s "
        f"| per-pic: tokenize {st['tokenize_s'] / pics * 1e3:.2f} ms, "
        f"fill {st['fill_s'] / pics * 1e3:.2f} ms, device "
        f"{st['device_s'] / pics * 1e3:.2f} ms | median {med:.4f}s "
        f"({n_frames / med:.2f} frames/s), IQR {q1:.4f}-{q3:.4f}s "
        f"({n_frames / q3:.2f}-{n_frames / q1:.2f} frames/s)")

    _build.LAUNCHES.clear()
    frames = b.decode(dec, data)
    launches = dict(_build.LAUNCHES)
    try:
        digest = fixtures.check_frames(frames, meta, args.repeat)
    except ValueError as e:
        err(f"FAILED: {args.stream} x{args.repeat}: {e}")
        return 1
    err(f"hash: {n_frames} frames, YUV sha256 {digest} is the JAX "
        f"package's; launches {json.dumps(launches, sort_keys=True)}")

    if not args.no_capacity:
        err(f"chip-capacity: {b.capacity(data):.2f} frames/s (2 concurrent "
            f"streams)")
    if not args.no_latency:
        lat, _ = fixtures.load(LATENCY_STREAM)
        err(f"latency: {b.latency_ms(lat):.2f} ms/frame (per-picture path, "
            f"1080p)")
    if not args.no_host_delivery:
        host_data, host_meta = fixtures.load(HOST_STREAM)
        try:
            host_fps = b.host_delivery(host_data, host_meta)
        except ValueError as e:
            err(f"FAILED: host delivery of {HOST_STREAM}: {e}")
            return 1
        err(f"host-delivery: {host_fps:.2f} frames/s ({HOST_STREAM}, frames "
            f"read on the host)")
    base = baseline()
    err(card_line(b.cuda, base))

    default = args.stream == STREAM and args.repeat == 1
    base_fps = float(base.get("fps", 0.0)) if default else 0.0
    name = os.path.basename(fixtures.stream_path(args.stream))[:-len(".m2v")]
    metric = METRIC if default else (
        f"{name}{f'_x{args.repeat}' if args.repeat > 1 else ''}"
        f"_decode_throughput")
    print(json.dumps({
        "metric": metric,
        "value": round(fps, 2),
        # a CPU run's rate is not the card's
        "unit": "frames/s/chip" if b.cuda else "frames/s/cpu",
        "vs_baseline": round(fps / base_fps, 3) if base_fps > 0 else 0.0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
