"""A/B of the frame-prediction kernels between two checkouts of the port,
on one card, by ``chip_smoke.py``'s own measurement code.

    python3 tools/ab_kernel_times.py PARENT_ROOT [CHANGE_ROOT]
        [--pairs N] [--out DIR]

``CHANGE_ROOT`` defaults to this checkout.  The two checkouts run in turns,
each in a process of its own, for ``N`` pairs (default 10), alternating
which side runs first (P C, C P, P C, ...).  Each process

* builds its checkout's CUDA kernels from their sources and times the
  build (``_build.build(force=True)``, then loading the library);
* compiles its ``csrc/mc_recon.cu`` with ``-Xptxas -v`` and keeps the
  stack size that ``ptxas`` reports for each kernel instantiation;
* times K1 (``chip_smoke.check_idct``: 131,072 blocks), K2 (1088x1920
  luma) and K3 (2 x 544x960 chroma, 8x8 tiles), bidir and forward-only,
  on ``chip_smoke.mc_inputs`` with ``chip_smoke.cuda_ms`` (device time per
  call), after checking each against its plain version.

Every run prints one JSON line; the summary gives, for each reading, the
median of each side, the parent's interquartile range and the pairs in
which the change read lower.  ``--out`` also keeps each process's full
output there.  Needs one CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = (("K2 luma", 1088, 1920, 16, False), ("K3 uv 8x8", 544, 960, 8, True))


def _smoke():
    """This checkout's ``chip_smoke`` (not the one of the checkout under
    test, which comes first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_stacks(nvcc: str, root: str) -> list:
    """Per-thread stack bytes ``ptxas`` reports for each kernel of
    ``root``'s ``csrc/mc_recon.cu``, in the order it compiles them."""
    src = os.path.join(root, "tiny_mp2v_dec_tpu_torch", "csrc", "mc_recon.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-c", "-o",
             os.path.join(tmp, "mc_recon.o"), src],
            capture_output=True, text=True, check=True)
    text = out.stderr + out.stdout
    # ptxas prints one or the other, depending on its version
    found = (re.findall(r"(\d+) bytes cumulative stack size", text)
             or re.findall(r"(\d+) bytes stack frame", text))
    return [int(m) for m in found]


def run_one(root: str) -> dict:
    """Build and time the kernels of the checkout at ``root``."""
    sys.path.insert(0, root)
    smoke = _smoke()
    import numpy as np
    import torch
    from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused
    if not torch.cuda.is_available():
        smoke.fail("torch finds no CUDA device")
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root) + os.sep):
        smoke.fail(f"imported {_build.__file__}, not the checkout {root}")
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.kernel_library()
    rec = {"root": root, "build_s": time.perf_counter() - t0,
           "stacks": ptxas_stacks(_build.nvcc_path(), root)}
    rng = np.random.default_rng(2024)
    rec["K1 idct8x8"] = smoke.check_idct(torch, np, rng)["ms"]
    for name, H, W, t, uv in MC:
        plane, resid, meta = smoke.mc_inputs(torch, np, rng, H, W, t, t,
                                             field=False)
        if uv:
            fn, ref_fn = (mc_fused.fused_mc_recon_uv,
                          mc_fused.fused_mc_recon_uv_ref)
            args = ((plane(), plane()), (plane(), plane()), (resid(), resid()))
        else:
            fn, ref_fn = mc_fused.fused_mc_recon, mc_fused.fused_mc_recon_ref
            args = (plane(), plane(), resid())
        for bidir in (True, False):
            got = fn(*args, *meta, h=t, w=t, bidir=bidir)
            ref = ref_fn(*args, *meta, h=t, w=t, bidir=bidir)
            same = (all(map(torch.equal, got, ref)) if uv
                    else torch.equal(got, ref))
            if not same:
                smoke.fail(f"{name} bidir={bidir} differs from its plain "
                           f"version in {root}")
            rec[f"{name} {'bidir' if bidir else 'fwd'}"] = smoke.cuda_ms(
                torch, lambda: fn(*args, *meta, h=t, w=t, bidir=bidir))
    return rec


def summary(runs: list, parent: str, change: str) -> dict:
    """Per reading: median of each side, the parent's interquartile range,
    and in how many pairs (the i-th run of each side) the change read
    lower."""
    side = {r: [x for x in runs if x["root"] == r] for r in (parent, change)}
    out = {}
    for key in runs[0]:
        if key in ("root", "stacks"):
            continue
        p = [x[key] for x in side[parent]]
        c = [x[key] for x in side[change]]
        q = statistics.quantiles(p, n=4) if len(p) > 1 else [p[0]] * 3
        out[key] = {"parent_median": statistics.median(p),
                    "change_median": statistics.median(c),
                    "parent_iqr": q[2] - q[0],
                    "change_wins": sum(b < a for a, b in zip(p, c)),
                    "pairs": min(len(p), len(c))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=REPO)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", help="directory for each run's full output")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(run_one(os.path.abspath(a.parent))))
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
                                "--one", root], capture_output=True,
                               text=True)
            if a.out:
                with open(os.path.join(a.out, tag + ".txt"), "w") as f:
                    f.write(p.stdout + p.stderr)
            if p.returncode != 0:
                print(p.stdout + p.stderr, file=sys.stderr)
                print(f"ab_kernel_times: run {tag} failed", file=sys.stderr)
                return 1
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            print(tag, json.dumps(rec), flush=True)
            runs.append(rec)
    print(json.dumps({"summary": summary(runs, parent, change)}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
