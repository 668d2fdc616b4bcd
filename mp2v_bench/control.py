"""The control of the comparison that decides ``correct``: the reference
put in the program's place with one guarantee broken.

The configurations state no precision; they state that every frame is
byte-identical to a conforming decode with the reference decoder's IDCT
arithmetic.  The control breaks that guarantee the way a later change
would be tempted to: it reconstructs with the spec's float IDCT (Annex A,
``ref/golden/idct.py``'s ``float_idct_blocks``) computed in float32,
rounded to the nearest integer and clipped to [-256, 255], in place of the
fixed-point one.  Its frames must read as not correct.

    python3 -m mp2v_bench.control --workload NAME --seeds N [N ...]

prints, for each seed, the bytes and frames of the cell's distinct
pictures (every channel's) in which the control differs from the
reference, and the bytes of one window's comparison (a decode of the
closed loop, a cycle of the pictures in the open one), then one JSON line
with every reading.  Runs on the CPU; no card is needed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from . import reference, spec
from .ref.golden.idct import float_idct_blocks
from .streams import generate


def float32_idct(coeffs: np.ndarray) -> np.ndarray:
    """The spec's float IDCT in float32, rounded and clipped: the
    control's replacement for the golden fixed-point IDCT."""
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    basis = (0.5 * c[None, :] * np.cos(
        (2 * k[:, None] + 1) * k[None, :] * np.pi / 16)).astype(np.float32)
    m = coeffs.reshape(coeffs.shape[:-1] + (8, 8)).astype(np.float32)
    qf = np.swapaxes(m, -1, -2)
    f = np.einsum("yv,...vu,xu->...yx", basis, qf, basis)
    return np.clip(np.rint(f), -256, 255).astype(np.int16)


def reading(config: dict, seed: int, workers: int) -> dict:
    """The control against the reference on one seed's streams, summed
    over the configuration's channels."""
    with generate.worker_pool(workers) as pool:
        streams = spec.channel_streams(config, seed, pool)
    exact = reference.decode_all(streams, workers)
    ctrl = reference.decode_all(streams, workers, idct=float32_idct)
    diffs = [e.frames != c.frames for e, c in zip(exact, ctrl)]
    return {"seed": seed,
            "mismatched_bytes": sum(int(d.sum()) for d in diffs),
            "frames_differing": sum(int(d.any(axis=1).sum())
                                    for d in diffs),
            "frames": sum(len(e.frames) for e in exact)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mp2v_bench.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    # frames one window compares per distinct picture: the pictures of a
    # closed-loop decode, or one cycle of the open loop
    per = cell.traffic.get("repeat", 1)
    workers = max(1, min(8, os.cpu_count() or 1))
    out = []
    for seed in args.seeds:
        t = time.perf_counter()
        r = reading(cell.config, seed, workers)
        r["window_mismatched_bytes"] = r["mismatched_bytes"] * per
        r["seconds"] = time.perf_counter() - t
        print(f"# control {args.workload} seed {seed}: "
              f"{r['mismatched_bytes']} bytes in {r['frames_differing']} of "
              f"{r['frames']} frames differ from the reference "
              f"({r['window_mismatched_bytes']} in one window's "
              f"comparison); {r['seconds']:.1f} s", file=sys.stderr)
        out.append(r)
    print(json.dumps({"workload": args.workload, "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
