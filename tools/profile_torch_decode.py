"""Where the PyTorch port's 1080-line decode spends its time, on one GPU.

    python tools/profile_torch_decode.py [FIXTURE] [--runs 5] [--out ...]

Decodes a committed 16-picture fixture — by default
``tests/data/bench_1080p_420_16.m2v`` (1080p 4:2:0, frame prediction);
``tests/data/interlaced_1080_422_16.m2v`` is the interlaced 4:2:2 one —
with ``gop_chunk=16`` on ``cuda``:

* stages: the decoder's own path taken apart on one thread, with a device
  synchronize after each stage — tokenize (host), prepare (host), upload
  (from the pinned staging slot, ``GopRecon.upload``), decode_blob
  (pairs -> rows, K1, dense grid), and the per-picture reconstruction loop
  (residual layout, mc_meta / mc_field_meta, the MC kernels, packing);
* profiler: one unsynchronized decode under ``torch.profiler``, device
  time and launches of every kernel (by name: each template form on its
  own), and the device's busy share of the wall.

The MC kernels are those of ``MP2V_MC_IMPL`` (``mxu``, the default: K2 +
K3 or K4; ``roll``: K5 + K6; ``swar``: K7 or K8).  Prints one JSON object
and writes it to ``--out`` (by default
``chiprun_out/profile_torch_decode_<fixture>_<impl>.json``).  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
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
    field = any(bool(t.field_pred.any()) for t, _, _ in toks)
    recon = dec._gop_recon_for(geom, field, dec.config.gop_chunk)
    pcts = [ph.picture_coding_type for _, _, ph in toks]
    staged = recon.prepare([x[0] for x in toks], pcts)
    (cap_pairs, cap_k), blob, n = staged
    t.append(time.perf_counter())
    # the decoder's upload: from the pinned slot, not blocking the host
    up, guard = recon.upload(staged)
    sync()
    t.append(time.perf_counter())
    recon.mark_dispatched(staged, guard)
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
    ap.add_argument("fixture", nargs="?", default=FIXTURE)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()
    name = os.path.splitext(os.path.basename(args.fixture))[0]
    impl = os.environ.get("MP2V_MC_IMPL", "mxu")
    out_path = args.out or os.path.join(
        REPO, "chiprun_out", f"profile_torch_decode_{name}_{impl}.json")

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder

    with open(args.fixture, "rb") as f:
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
    # device-side rows only (kernels, memcpys): a CPU op's row carries the
    # time of the kernels it launched too, which would count them twice
    from torch.autograd import DeviceType
    kernels = {a.key[:80]: [a.self_device_time_total / 1e3, a.count]
               for a in prof.key_averages()
               if a.device_type != DeviceType.CPU
               and a.self_device_time_total > 0}
    busy_ms = sum(v[0] for v in kernels.values())
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1][0])

    med = lambda xs: statistics.median(xs)  # noqa: E731
    out = {
        "fixture": name,
        # the implementations of the recons the decodes built
        "mc_impl": sorted({key[3] for key in dec._recons}),
        "card": torch.cuda.get_device_name(0),
        "nvidia_smi": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
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
        # every device row, so that a kernel's forms can be summed
        "device_ms": [{"name": n, "ms": v[0], "count": v[1]}
                      for n, v in by_time],
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
