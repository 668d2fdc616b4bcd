"""A/B of the port's decode frames/s between two checkouts of the port, on
one card.

    python3 tools/ab_decode.py PARENT_ROOT [CHANGE_ROOT] [--pairs N]
        [--runs R] [--chunks G[xK] ...] [--out DIR]

``CHANGE_ROOT`` defaults to this checkout.  The two checkouts run in turns,
each in a process of its own, for ``N`` pairs (default 10), alternating
which side runs first (P C, C P, P C, ...).  Each process imports the
package of its checkout, builds its CUDA kernels when they are not built
yet, and decodes both committed 16-picture fixtures
(``tests/data/bench_1080p_420_16.m2v``, 1080p 4:2:0, and
``tests/data/interlaced_1080_422_16.m2v``, 1080-line 4:2:2 with field
motion, from this checkout) under ``MP2V_MC_IMPL=mxu`` through
``MP2VDecoder(gop_chunk=G, output_host=False, pictures_pool_size=0)`` on
``cuda``.  ``--chunks`` gives the configurations in the order each process
runs them (default ``4 16 16x4``): ``G`` decodes the fixture at
``gop_chunk=G``, ``GxK`` the fixture ``K`` times over in one stream
(``tiny_mp2v_dec_tpu_torch/fixtures.py``'s ``repeat_stream``), so that ``16x4`` is the main path's
``gop_chunk=16`` on four chunks.  Each configuration: three decodes to warm
up (the staging slots, three per blob shape, are made in the first three
chunks), then ``R`` decodes (default 7), each timed from its first byte to
``torch.cuda.synchronize()``.

Its readings, per fixture and configuration: frames/s of the median wall;
the median over the decodes of the overlap figure ``(tokenize_s + fill_s +
device_s) / wall`` of the decoder's own stats (above 1: the stages ran at
the same time) and of each of the three; and ``kept_mb``, the host memory
the decoder keeps after its last decode (``chip_smoke.host_kept_bytes``).

Every run prints one JSON line; the summary gives, for each reading, the
median of each side, the parent's interquartile range, whether the
medians lie within it of each other, and the pairs in which the change
read higher; ``cards``: the card's name and power limit as ``nvidia-smi``
gave them to each process, and ``cpus``: the host's ``os.cpu_count()``.
``--out`` also keeps each process's full output there.  Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
FIXTURES = ("bench_1080p_420_16", "interlaced_1080_422_16")
CHUNKS = ("4", "16", "16x4")
STAGES = ("tokenize_s", "fill_s", "device_s")


def _smoke():
    """This checkout's ``chip_smoke.py``, loaded by path (the stream and
    memory helpers, whichever checkout is being timed)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(root: str, runs: int, chunks=CHUNKS) -> dict:
    """The readings of the checkout at ``root`` (see the module
    docstring)."""
    os.environ["MP2V_MC_IMPL"] = "mxu"
    smoke = _smoke()
    sys.path.insert(0, root)
    import torch
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        raise SystemExit("ab_decode: torch finds no CUDA device")
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root) + os.sep):
        raise SystemExit(f"ab_decode: imported {_build.__file__}, not the "
                         f"checkout {root}")
    rec = {"root": root, "cpus": os.cpu_count(),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}
    for name in FIXTURES:
        with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
            fixture = f.read()
        for conf in chunks:
            chunk, _, times = conf.partition("x")
            data = smoke._fixtures().repeat_stream(fixture,
                                                   int(times or 1))
            dec = MP2VDecoder(DecoderConfig(gop_chunk=int(chunk),
                                            output_host=False,
                                            pictures_pool_size=0,
                                            device="cuda"))
            for _ in range(3):
                dec.reset()
                dec.decode(data)
            torch.cuda.synchronize()
            walls, stats = [], []
            for _ in range(runs):
                dec.reset()
                t0 = time.perf_counter()
                frames = dec.decode(data)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                stats.append(dict(dec.stats))
            key = f"{name} gop_chunk={chunk}" + (f" x{times}" if times
                                                  else "")
            rec[f"{key} fps"] = len(frames) / statistics.median(walls)
            rec[f"{key} overlap"] = statistics.median(
                sum(s[k] for k in STAGES) / w for s, w in zip(stats, walls))
            for k in STAGES:
                rec[f"{key} {k}"] = statistics.median(s[k] for s in stats)
            rec[f"{key} kept_mb"] = smoke.host_kept_bytes(dec) / 2**20
    return rec


def summary(runs: list, parent: str, change: str) -> dict:
    """Per reading: median of each side, the parent's interquartile range,
    whether the two medians lie within it of each other, and in how many
    pairs (the i-th run of each side) the change read higher."""
    side = {r: [x for x in runs if x["root"] == r] for r in (parent, change)}
    out = {}
    for key in runs[0]:
        if key in ("root", "card", "cpus"):
            continue
        p = [x[key] for x in side[parent]]
        c = [x[key] for x in side[change]]
        q = statistics.quantiles(p, n=4) if len(p) > 1 else [p[0]] * 3
        pm, cm = statistics.median(p), statistics.median(c)
        out[key] = {"parent_median": pm, "change_median": cm,
                    "parent_iqr": q[2] - q[0],
                    "within_parent_iqr": abs(cm - pm) <= q[2] - q[0],
                    "change_higher": sum(b > a for a, b in zip(p, c)),
                    "pairs": min(len(p), len(c))}
    out["cards"] = sorted({x["card"] for x in runs})
    out["cpus"] = sorted({x["cpus"] for x in runs})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=REPO)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--chunks", nargs="+", default=list(CHUNKS))
    ap.add_argument("--out", help="directory for each run's full output")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(run_one(os.path.abspath(a.parent), a.runs,
                                 a.chunks)))
        return 0
    parent, change = map(os.path.abspath, (a.parent, a.change))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    runs = []
    for i in range(a.pairs):
        order = (parent, change) if i % 2 == 0 else (change, parent)
        for root in order:
            tag = f"{i:02d}_{'parent' if root == parent else 'change'}"
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, "--runs", str(a.runs),
                                "--chunks", *a.chunks],
                               capture_output=True, text=True)
            if a.out:
                with open(os.path.join(a.out, tag + ".txt"), "w") as f:
                    f.write(p.stdout + p.stderr)
            if p.returncode != 0:
                print(p.stdout + p.stderr, file=sys.stderr)
                print(f"ab_decode: run {tag} failed", file=sys.stderr)
                return 1
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            print(tag, json.dumps(rec), flush=True)
            runs.append(rec)
    print(json.dumps({"summary": summary(runs, parent, change)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
