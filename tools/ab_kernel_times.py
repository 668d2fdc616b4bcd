"""A/B of the port's kernels (K1–K10) between two checkouts of the port,
on one card, by ``chip_smoke.py``'s own measurement code.

    python3 tools/ab_kernel_times.py PARENT_ROOT [CHANGE_ROOT]
        [--pairs N] [--out DIR] [--only WORD ...]

``CHANGE_ROOT`` defaults to this checkout.  The two checkouts run in turns,
each in a process of its own, for ``N`` pairs (default 10), alternating
which side runs first (P C, C P, P C, ...).  Each process

* builds its checkout's CUDA kernels from their sources and times the
  build (``_build.build(force=True)``, then loading the library);
* compiles its ``csrc/mc_recon.cu``, ``csrc/mc_roll.cu``,
  ``csrc/idct.cu`` and ``csrc/mc_rows.cu`` with ``-Xptxas -v`` and keeps
  the registers, stack frame and spilled bytes that ``ptxas`` reports for
  each kernel instantiation (:func:`ptxas_report`);
* compiles ``csrc/mc_recon.cu``, ``csrc/mc_roll.cu`` and
  ``csrc/mc_swar.cu`` to cubins and keeps a digest of the SASS
  (``cuobjdump -sass``) of each instantiation of the controls
  (:func:`sass_digests`): every form of the segment kernel
  ``mc_seg_kernel`` (K2, K3, K4, K8), K5's ``mc_roll_luma_kernel``, K6's
  ``mc_roll_uv_kernel`` and K7's one-component ``mc_swar_kernel``; and K1's
  instructions counted by opcode (:func:`sass_opcodes`);
* times K1 (``chip_smoke.check_idct``: 131,072 and 196,608 blocks, each
  warm and cold) and, by ``chip_smoke.check_mc``
  (``chip_smoke.mc_inputs``, device time per call by
  ``chip_smoke.cuda_ms``, each form checked against its plain version
  first), bidir and forward-only: K2 (1088x1920 luma), K3 at every chroma
  tile (2 x 544x960 at 8x8, 2 x 1088x960 at 16x8, 2 x 1088x1920 at
  16x16), K4 luma and U+V at 16x8, K5 luma, K6 at every chroma tile, K7
  luma and one 544x960 plane at 8x8, K8 luma and one 1088x960 plane at
  16x8, each with
  the field bit on half the MBs; K4 luma and K8 luma again with it on the
  interlaced fixture's share (9,320 of 130,560 MBs); K2 and K3 on a plane
  of one MB (``chip_smoke.one_mb_times``: the fixed cost of a launch); and
  K7 on one 1080p picture at 4:2:0 and 4:2:2 (``chip_smoke.check_swar_yuv``:
  the picture form's one launch, or in a checkout without it the three
  one-component launches it replaces, timed as one callable); and K9 and
  K10 on the MC profiler's 1080p inputs (``chip_smoke.check_rows``, each
  first checked on every case of ``profile_mc_variants.row_case``).

Every run prints one JSON line; the summary gives, for each reading, the
median of each side, the parent's interquartile range, whether the
medians lie within it of each other, and the pairs in which the change
read lower; ``cards``: the card's name and power limit as ``nvidia-smi``
gave them to each process; and ``control_sass_equal``: whether both sides
compiled the controls (K2, K3, K4, K8, K5, K6, K7's one-component form) to
the same machine code.  ``--out`` also keeps each
process's full output there.  Needs one CUDA card and ``nvcc``; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
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
# field-predicted MBs of tests/data/interlaced_1080_422_16.m2v
FIXTURE_FIELD_SHARE = 9320 / 130560
# (reading, plane rows, columns, tile rows, columns, U+V, field form,
# MP2V_MC_IMPL, share of field MBs)
MC = (("K2 luma", 1088, 1920, 16, 16, False, False, "mxu", 0.5),
      ("K3 uv 8x8", 544, 960, 8, 8, True, False, "mxu", 0.5),
      ("K3 uv 16x8", 1088, 960, 16, 8, True, False, "mxu", 0.5),
      ("K3 uv 16x16", 1088, 1920, 16, 16, True, False, "mxu", 0.5),
      ("K4 luma", 1088, 1920, 16, 16, False, True, "mxu", 0.5),
      ("K4 uv 16x8", 1088, 960, 16, 8, True, True, "mxu", 0.5),
      ("K5 luma", 1088, 1920, 16, 16, False, False, "roll", 0.5),
      ("K6 uv 8x8", 544, 960, 8, 8, True, False, "roll", 0.5),
      ("K6 uv 16x8", 1088, 960, 16, 8, True, False, "roll", 0.5),
      ("K6 uv 16x16", 1088, 1920, 16, 16, True, False, "roll", 0.5),
      ("K7 luma", 1088, 1920, 16, 16, False, False, "swar", 0.5),
      ("K7 8x8", 544, 960, 8, 8, False, False, "swar", 0.5),
      ("K8 luma", 1088, 1920, 16, 16, False, True, "swar", 0.5),
      ("K8 16x8", 1088, 960, 16, 8, False, True, "swar", 0.5),
      ("K4 luma fixture share", 1088, 1920, 16, 16, False, True, "mxu",
       FIXTURE_FIELD_SHARE),
      ("K8 luma fixture share", 1088, 1920, 16, 16, False, True, "swar",
       FIXTURE_FIELD_SHARE))
# chip_smoke.one_mb_times' forms -> their readings
ONE_MB = {"mc_recon_luma": "K2 one MB", "mc_recon_uv": "K3 one MB"}
# chip_smoke.CHROMA's formats K7's picture form is timed at
YUV = ("4:2:0", "4:2:2")
# chip_smoke.check_rows' forms -> their kernels
ROWS = {"mc_row": "K9", "mc_row_packed": "K10"}


def _smoke():
    """This checkout's ``chip_smoke`` (not the one of the checkout under
    test, which comes first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the sources whose kernels ptxas_report lists
PTXAS_SOURCES = ("mc_recon", "mc_roll", "idct", "mc_rows")


def ptxas_report(nvcc: str, root: str) -> dict:
    """Registers, stack frame and spilled bytes (stores + loads) that
    ``ptxas -v`` reports for each kernel of ``root``'s
    :data:`PTXAS_SOURCES`, keyed by the kernel's mangled name."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in PTXAS_SOURCES:
            src = os.path.join(root, "tiny_mp2v_dec_tpu_torch", "csrc",
                               name + ".cu")
            p = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
                 os.path.join(tmp, name + ".o"), src],
                capture_output=True, text=True, check=True)
            for fn in (p.stderr + p.stdout).split(
                    "Compiling entry function '")[1:]:
                kernel = fn.split("'", 1)[0]
                # ptxas prints one or the other, depending on its version
                stack = (re.search(r"(\d+) bytes cumulative stack size", fn)
                         or re.search(r"(\d+) bytes stack frame", fn))
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", fn)
                regs = re.search(r"Used (\d+) registers", fn)
                out[kernel] = {
                    "registers": int(regs[1]) if regs else None,
                    "stack": int(stack[1]) if stack else None,
                    "spill": int(spill[1]) + int(spill[2]) if spill else None}
    return out


def sass_listing(nvcc: str, root: str, names) -> str:
    """``cuobjdump -sass`` of ``root``'s ``csrc/<name>.cu`` for each of
    ``names``, each compiled to a cubin as the build compiles it."""
    sass = ""
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            cubin = os.path.join(tmp, name + ".cubin")
            subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-cubin", "-o", cubin,
                 os.path.join(root, "tiny_mp2v_dec_tpu_torch", "csrc",
                              name + ".cu")],
                capture_output=True, text=True, check=True)
            sass += subprocess.run(
                [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                 cubin], capture_output=True, text=True, check=True).stdout
    return sass


def control_sass(nvcc: str, root: str) -> dict:
    """:func:`sass_digests` of ``root``'s ``csrc/mc_recon.cu``,
    ``csrc/mc_roll.cu`` and ``csrc/mc_swar.cu``."""
    return sass_digests(sass_listing(nvcc, root,
                                     ("mc_recon", "mc_roll", "mc_swar")))


def _functions(sass: str):
    """(name line, body) of each function of a ``cuobjdump -sass`` listing,
    the body cut at cuobjdump's closing line of dots."""
    for fn in sass.split("Function : ")[1:]:
        name, _, body = fn.partition("\n")
        yield name, re.split(r"\n\s*\.{4,}\s*\n", body + "\n")[0]


def sass_opcodes(sass: str, kernel: str) -> dict:
    """Instructions of the function whose name holds ``kernel`` in a
    ``cuobjdump -sass`` listing, counted by opcode (without its modifiers
    or predicate), with their ``total``.  K1 is bound by its integer
    instructions, so their number and mix are what a change of it moves."""
    out = {}
    for name, body in _functions(sass):
        if kernel not in name:
            continue
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]"
                         r"[A-Z0-9_]*)", line)
            if m:
                out[m[1]] = out.get(m[1], 0) + 1
    return {"total": sum(out.values()),
            **dict(sorted(out.items(), key=lambda kv: -kv[1]))}


# the controls' mangled names: every vector form of the segment kernel
# (tile rows, columns, planes, bidir, FIELD, RECON: K2/K3 0 1, K4 1 1, K8
# 1 0; the front-end parameter VecFront where the source has one, and not
# the blocks form's BlockFront), K5's warp kernel (bidir), K6's (tile rows,
# columns, bidir) and K7's one-component word kernel (tile rows, columns,
# bidir)
_CONTROLS = (
    (r"mc_seg_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E"
     r"(?:NS_8VecFrontILb\dEEE)?E",
     "seg {}x{} np={} bidir={} field={} recon={}"),
    (r"mc_roll_luma_kernelILb(\d)EE", "roll luma bidir={}"),
    (r"mc_roll_uv_kernelILi(\d+)ELi(\d+)ELb(\d)EE",
     "roll uv {}x{} bidir={}"),
    (r"mc_swar_kernelILi(\d+)ELi(\d+)ELb(\d)EE", "swar {}x{} bidir={}"))


def sass_digests(sass: str) -> dict:
    """sha256 of each instantiation of the controls in ``cuobjdump -sass``
    output (:data:`_CONTROLS`: the forms of ``mc_seg_kernel``, K5's
    ``mc_roll_luma_kernel``, K6's ``mc_roll_uv_kernel``, K7's
    ``mc_swar_kernel``), keyed by its kernel
    and its template arguments: the lines of its body up to
    cuobjdump's closing line of dots — each instruction and its encoding —
    without the function's name line, what follows the body (after the
    last function of a listing, the next listing's header), runs of
    blanks (cuobjdump pads columns to the file's longest instruction) or
    the file-wide numbering of branch labels.  Other kernels (K7's picture
    form, the empty kernel) are left out."""
    out = {}
    for name, body in _functions(sass):
        for pattern, key in _CONTROLS:
            m = re.search(pattern, name)
            if m:
                labels = {}
                body = re.sub(r"\.L_x_\d+", lambda x: labels.setdefault(
                    x[0], f".L{len(labels)}"), body)
                body = "\n".join(" ".join(line.split())
                                 for line in body.splitlines())
                out[key.format(*m.groups())] = hashlib.sha256(
                    body.encode()).hexdigest()
    return out


def run_one(root: str, only=()) -> dict:
    """Build and time the kernels of the checkout at ``root``; with
    ``only``, just the readings whose names begin with one of its words
    (``K1`` is K1's readings, not K10's), and neither the ``ptxas`` report
    nor the SASS."""
    def want(*names):
        return not only or any(n == w or n.startswith(w + " ")
                               for n in names for w in only)

    sys.path.insert(0, root)
    smoke = _smoke()
    import numpy as np
    import torch
    from tiny_mp2v_dec_tpu_torch.ops import _build
    if not torch.cuda.is_available():
        smoke.fail("torch finds no CUDA device")
    if not os.path.abspath(_build.__file__).startswith(
            os.path.abspath(root) + os.sep):
        smoke.fail(f"imported {_build.__file__}, not the checkout {root}")
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.kernel_library()
    rec = {"root": root, "build_s": time.perf_counter() - t0,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               check=True).stdout.strip()}
    if not only:
        rec["ptxas"] = ptxas_report(_build.nvcc_path(), root)
        rec["control_sass"] = control_sass(_build.nvcc_path(), root)
        rec["k1_sass"] = sass_opcodes(
            sass_listing(_build.nvcc_path(), root, ("idct",)),
            "idct8x8_kernel")
    rng = np.random.default_rng(2024)
    if want("K1"):
        for n, r in smoke.check_idct(torch, np, rng)["blocks"].items():
            rec[f"K1 idct8x8 {n} warm"] = r["ms"]
            rec[f"K1 idct8x8 {n} cold"] = r["cold_ms"]
    for name, H, W, th, tw, uv, field, impl, share in MC:
        if not want(name):
            continue
        r = smoke.check_mc(torch, np, rng, name, H, W, th, tw, uv=uv,
                           field=field, impl=impl, field_share=share)
        rec[f"{name} bidir"], rec[f"{name} fwd"] = r["ms"], r["fwd_ms"]
    if want(*ONE_MB.values()):
        for form, r in smoke.one_mb_times(torch, np, rng).items():
            name = ONE_MB[form]
            rec[f"{name} bidir"], rec[f"{name} fwd"] = r["ms"], r["fwd_ms"]
    for label, tile, H, W in smoke.CHROMA:
        if label in YUV and want(f"K7 picture {label}"):
            r = smoke.check_swar_yuv(torch, np, rng, label, tile, H, W)
            name = f"K7 picture {label}"
            rec[f"{name} bidir"], rec[f"{name} fwd"] = r["ms"], r["fwd_ms"]
    if want(*ROWS.values()):
        for name, r in smoke.check_rows(torch).items():
            rec[f"{ROWS[name]} {name}"] = r["ms"]
    return rec


def summary(runs: list, parent: str, change: str) -> dict:
    """Per reading: median of each side, the parent's interquartile range,
    whether the two medians lie within it of each other, and in how many
    pairs (the i-th run of each side) the change read lower."""
    side = {r: [x for x in runs if x["root"] == r] for r in (parent, change)}
    out = {}
    for key in runs[0]:
        if key in ("root", "card", "ptxas", "control_sass", "k1_sass"):
            continue
        p = [x[key] for x in side[parent]]
        c = [x[key] for x in side[change]]
        q = statistics.quantiles(p, n=4) if len(p) > 1 else [p[0]] * 3
        pm, cm = statistics.median(p), statistics.median(c)
        out[key] = {"parent_median": pm, "change_median": cm,
                    "parent_iqr": q[2] - q[0],
                    "within_parent_iqr": abs(cm - pm) <= q[2] - q[0],
                    "change_wins": sum(b < a for a, b in zip(p, c)),
                    "pairs": min(len(p), len(c))}
    if "control_sass" in runs[0]:
        out["control_sass_equal"] = bool(runs[0]["control_sass"]) and all(
            x["control_sass"] == runs[0]["control_sass"] for x in runs)
    out["cards"] = sorted({x["card"] for x in runs})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=REPO)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", help="directory for each run's full output")
    ap.add_argument("--only", nargs="+", default=(), metavar="WORD",
                    help="time only the readings whose names begin with "
                    "these words (e.g. K9 K10), without the ptxas report "
                    "and the SASS")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        print(json.dumps(run_one(os.path.abspath(a.parent), a.only)))
        return 0
    parent, change = map(os.path.abspath, (a.parent, a.change))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    runs = []
    for i in range(a.pairs):
        order = (parent, change) if i % 2 == 0 else (change, parent)
        for root in order:
            tag = f"{i:02d}_{'parent' if root == parent else 'change'}"
            only = ["--only", *a.only] if a.only else []
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, *only], capture_output=True,
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
