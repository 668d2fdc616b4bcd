"""Where the PyTorch port's 1080p decode spends its time, on one GPU.

    python tools/profile_torch_decode.py [--runs 5] [--out chiprun_out/...]

Decodes the committed 16-picture 1080p 4:2:0 fixture
(``tests/data/bench_1080p_420_16.m2v``) with ``gop_chunk=16`` on ``cuda``:

* stages: the decoder's own path taken apart, with a device synchronize
  after each stage — tokenize (host), prepare (host), upload, decode_blob
  (pairs -> rows, K1, dense grid), and the per-picture reconstruction loop
  (residual layout, mc_meta, K2, K3, packing);
* profiler: one unsynchronized decode under ``torch.profiler``, device
  time summed by kernel name, and the device's busy share of the wall.

Prints one JSON object and writes it to ``--out``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "bench_1080p_420_16.m2v")


def _stages(torch, dec, data):
    """Seconds per stage of one synchronized chunk decode."""
    sync = torch.cuda.synchronize
    t = [time.perf_counter()]
    toks = dec.tokenize_stream(data)
    t.append(time.perf_counter())
    geom = toks[0][1]
    recon = dec._gop_recon_for(geom, dec.config.gop_chunk)
    pcts = [ph.picture_coding_type for _, _, ph in toks]
    (cap_pairs, cap_k), blob, n = recon.prepare([x[0] for x in toks], pcts)
    t.append(time.perf_counter())
    up = torch.from_numpy(blob).to(recon.device, copy=True)
    sync()
    t.append(time.perf_counter())
    recon._decode_blob(up, cap_pairs=cap_pairs, cap_k=cap_k)
    sync()
    t.append(time.perf_counter())
    o5 = recon._layout(cap_pairs, cap_k)[5]
    zero = recon.inner.zero_planes()
    # _gop repeats decode_blob; the loop is its time minus decode_blob's
    recon._gop(up, zero, zero, cap_pairs=cap_pairs, cap_k=cap_k,
               step_flags=blob[o5:o5 + n].copy(), bidir=True)
    sync()
    t.append(time.perf_counter())
    d = [b - a for a, b in zip(t, t[1:])]
    return {"tokenize": d[0], "prepare": d[1], "upload": d[2],
            "decode_blob": d[3], "recon_loop": d[4] - d[3],
            "blob_bytes": int(blob.nbytes), "cap_k": cap_k,
            "cap_pairs": cap_pairs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "profile_torch_decode.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder

    with open(FIXTURE, "rb") as f:
        data = f.read()
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    for _ in range(2):                       # build, load, warm up
        dec.reset()
        dec.decode(data)
    torch.cuda.synchronize()

    walls, stats = [], []
    for _ in range(args.runs):
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stats.append(dict(dec.stats))
    stages = [_stages(torch, dec, data) for _ in range(args.runs)]

    from torch.profiler import ProfilerActivity, profile
    dec.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec.decode(data)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # self device time: each kernel's own duration, counted once
    kernels = {a.key[:80]: [a.self_device_time_total / 1e3, a.count]
               for a in prof.key_averages() if a.self_device_time_total > 0}
    busy_ms = sum(v[0] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]

    med = lambda xs: statistics.median(xs)  # noqa: E731
    out = {
        "card": torch.cuda.get_device_name(0),
        "frames": len(frames),
        "wall_s_median": med(walls),
        "fps_median": len(frames) / med(walls),
        "decoder_stats_median": {k: med([s[k] for s in stats])
                                 for k in ("tokenize_s", "fill_s",
                                           "device_s")},
        "stages_s_median": {k: med([s[k] for s in stages])
                            for k in stages[0]},
        "profiled_wall_ms": prof_wall * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (prof_wall * 1e3),
        "device_launches": sum(v[1] for v in kernels.values()),
        "top_device_ms": [{"name": n, "ms": v[0], "count": v[1]}
                          for n, v in top],
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
