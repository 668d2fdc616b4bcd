"""Smoke run of the PyTorch port (``tiny_mp2v_dec_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels (``tiny_mp2v_dec_tpu_torch/csrc/*.cu``, nvcc for
   sm_90a) and the native tokenizer, from this checkout into ``build/``;
3. kernels: K1 (IDCT), K2 (luma MC+recon), K3 (U+V MC+recon, at the
   chroma tile of every format: 8x8, 16x8, 16x16), K4 (their field form:
   luma 16x16, chroma at every tile), K5 and K6 (the same function through
   a window staged in shared memory, ``MP2V_MC_IMPL=roll``: luma, and U+V
   at every chroma tile), K7 and K8 (packed prediction, four pixels per
   word, frame and field form, ``MP2V_MC_IMPL=swar``: one component per
   call, luma and one chroma plane at every tile), each on the card at the
   shapes a 1080-line chunk gives it, with ``bidir`` True and False,
   compared with its plain PyTorch version on the same inputs — exact
   equality, as all arithmetic is integer — and timed against it (device
   time per call, see :func:`cuda_ms`);
4. end to end, five paths through ``MP2VDecoder`` on ``cuda``: a
   committed fixture under one ``MP2V_MC_IMPL`` (set before the path's
   decoder is built), each with the launch counts reset just before and
   read just after its decode.  The 16-picture 1080p 4:2:0 IBBP stream
   (``tests/data/bench_1080p_420_16.m2v``) under ``mxu`` (K1, K2, K3),
   ``roll`` (K1, K5, K6) and ``swar`` (K1, K7); the interlaced 1080-line
   4:2:2 stream with field motion and field DCT
   (``tests/data/interlaced_1080_422_16.m2v``) under ``mxu`` (K1, K4) and
   ``swar`` (K1, K8).  Each path must launch its kernels exactly as often
   as :data:`PATHS` says and no MC kernel of another implementation, and
   each YUV sha256 must equal the one recorded from the JAX package (the
   ``.json`` beside each stream); then warm decode frames/s of each.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(REPO, "tiny_mp2v_dec_tpu_torch")
DATA = os.path.join(REPO, "tests", "data")
# end-to-end paths: (fixture, MP2V_MC_IMPL) -> the launches of its decode
# (one chunk of 16 pictures: K1 once, the two-plane MC kernels once per
# picture, the SWAR kernels once per component per picture)
PATHS = {
    ("bench_1080p_420_16", "mxu"): {
        "idct8x8": 1, "mc_recon_luma": 16, "mc_recon_uv": 16},
    ("interlaced_1080_422_16", "mxu"): {
        "idct8x8": 1, "mc_field_luma": 16, "mc_field_uv": 16},
    ("bench_1080p_420_16", "roll"): {
        "idct8x8": 1, "mc_roll_luma": 16, "mc_roll_uv": 16},
    ("bench_1080p_420_16", "swar"): {"idct8x8": 1, "mc_swar": 48},
    ("interlaced_1080_422_16", "swar"): {"idct8x8": 1, "mc_swar_field": 48},
}
MC_KERNELS = {k for counts in PATHS.values() for k in counts} - {"idct8x8"}
TIMED_RUNS = 20
# warm decodes per path: the two mxu paths 5, the others 3 (time limit)
DECODE_RUNS = {"mxu": 5, "roll": 3, "swar": 3}
# (label, tile, plane rows, plane columns) of each plane a kernel takes
LUMA = (("luma", (16, 16), 1088, 1920),)
CHROMA = (("4:2:0", (8, 8), 544, 960), ("4:2:2", (16, 8), 1088, 960),
          ("4:4:4", (16, 16), 1088, 1920))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


_CYCLES_PER_MS = []


def _sleep_cycles_per_ms(torch) -> float:
    """GPU clock cycles per millisecond of ``torch.cuda._sleep``, timed once
    with CUDA events."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def cuda_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``runs`` calls back to back
    between two CUDA events, queued behind a GPU sleep that outlasts the
    host's enqueue of all of them, so that the host's per-call work (the
    wrapper's checks, ``ctypes``, allocation) does not show as device
    time; the mean over the runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # generous: the sleep ends before the start event, so it costs no time
    torch.cuda._sleep(int((4 * enqueue_ms + 10) * _sleep_cycles_per_ms(torch)))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def max_abs_err(torch, got, ref) -> int:
    return int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())


def check_idct(torch, np, rng):
    """K1 on ~130k blocks, including all-zero and saturating rows."""
    from tiny_mp2v_dec_tpu_torch.ops.idct import idct_blocks, idct_blocks_ref
    coeffs = rng.integers(-2048, 2048, (131072, 64)).astype(np.int16)
    coeffs[0] = 0
    coeffs[1] = 2047
    coeffs[2] = -2048
    x = torch.from_numpy(coeffs).cuda()
    got = idct_blocks(x)
    ref = idct_blocks_ref(x)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, ref)
    if err or not torch.equal(got, ref):
        fail(f"K1 idct8x8 differs from its plain version (max abs err {err})")
    ms = cuda_ms(torch, lambda: idct_blocks(x))
    plain_ms = cuda_ms(torch, lambda: idct_blocks_ref(x))
    print(f"K1 idct8x8: {len(coeffs)} blocks, equal to plain; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def mc_inputs(torch, np, rng, H, W, th, tw, field):
    """Random refs, residual and per-MB metadata for one (H, W) plane of
    (th x tw) MBs: MVs cover all four half-pel phases and the edge clamps;
    modes cover every combination of fwd/bwd/coded.  ``field``: also the
    field tuples of both directions (random field selects, MVs of both
    units), with the field bit on about half the MBs."""
    from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_meta
    mbh, mbw = H // th, W // tw
    n = mbh * mbw
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    plane = lambda: t(rng.integers(0, 256, (H, W)).astype(np.uint8))  # noqa
    resid = lambda: t(  # noqa: E731
        rng.integers(-300, 300, (H, W)).astype(np.int16))
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos_y = t((mb_y * th).astype(np.int32))
    pos_x = t((mb_x * tw).astype(np.int32))
    mv = t(rng.integers(-64, 64, (n, 2, 2, 2)).astype(np.int16))
    meta = [*mc_meta(pos_y, pos_x, mv[:, 0, 0, 0], mv[:, 0, 0, 1], H, W,
                     th, tw),
            *mc_meta(pos_y, pos_x, mv[:, 0, 1, 0], mv[:, 0, 1, 1], H, W,
                     th, tw)]
    mode = rng.permutation(np.arange(n) % 8)
    if field:
        # imported here: tools/ab_kernel_times.py runs the frame form on
        # checkouts that have no field form
        from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_field_meta
        mvfs = t(rng.integers(0, 2, (n, 2, 2)).astype(np.uint8))
        mode = mode + 8 * (rng.random(n) < 0.5)
        meta += [t(mode.astype(np.int32))] + [
            mc_field_meta(pos_y, pos_x, mv[:, :, s], mvfs[:, :, s], H, W,
                          th, tw) for s in range(2)]
    else:
        meta.append(t(mode.astype(np.int32)))
    return plane, resid, meta


def mc_kernel(mc_fused, impl: str, uv: bool, field: bool):
    """(wrapper, plain version) of the MC kernel of ``impl`` in that form:
    ``mxu`` K2 (luma) or K3 (U+V), K4 with ``field``; ``roll`` K5 or K6;
    ``swar`` K7 (one component, no residual), K8 with ``field``."""
    if impl == "swar":
        return ((mc_fused.fused_mc_pred_swar_field,
                 mc_fused.fused_mc_pred_swar_field_ref) if field else
                (mc_fused.fused_mc_pred_swar, mc_fused.fused_mc_pred_swar_ref))
    if uv:
        return ({"mxu": mc_fused.fused_mc_recon_uv,
                 "roll": mc_fused.fused_mc_recon_uv_roll}[impl],
                mc_fused.fused_mc_recon_uv_ref)
    return ({"mxu": mc_fused.fused_mc_recon,
             "roll": mc_fused.fused_mc_recon_roll}[impl],
            mc_fused.fused_mc_recon_ref)


def check_mc(torch, np, rng, name, H, W, th, tw, uv: bool,
             field: bool = False, impl: str = "mxu"):
    """The MC kernel of ``impl`` (see :func:`mc_kernel`) on one (H, W)
    plane, or U and V with ``uv``, with ``bidir`` True and False.  The SWAR
    kernels' words are compared as words and their error read on the
    unpacked pixels."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    plane, resid, meta = mc_inputs(torch, np, rng, H, W, th, tw, field)
    fn, ref_fn = mc_kernel(mc_fused, impl, uv, field)
    if impl == "swar":
        args = (plane(), plane())
    elif uv:
        args = ((plane(), plane()), (plane(), plane()), (resid(), resid()))
    else:
        args = (plane(), plane(), resid())
    out = {}
    for bidir in (True, False):
        def kern():
            return fn(*args, *meta, h=th, w=tw, bidir=bidir)

        def plain():
            return ref_fn(*args, *meta, h=th, w=tw, bidir=bidir)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = torch.stack(got) if uv else got
        ref = torch.stack(ref) if uv else ref
        if impl == "swar":
            err = max_abs_err(torch, mc_fused.unpack_words(got),
                              mc_fused.unpack_words(ref))
        else:
            err = max_abs_err(torch, got, ref)
        if err or not torch.equal(got, ref):
            fail(f"{name} bidir={bidir} differs from its plain version "
                 f"(max abs err {err})")
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        planes = "2 x " if uv else ""
        print(f"{name} bidir={bidir}: {planes}{H}x{W} in {th}x{tw} tiles, "
              f"equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if bidir:   # the record carries the B-picture (bidir) form
            out = {"ms": ms, "plain_ms": plain_ms}
        out["max_abs_err"] = max(out.get("max_abs_err", 0), err)
    return out


def check_tiles(torch, np, rng, name, planes, main, **kw):
    """:func:`check_mc` on each (label, tile, H, W) of ``planes``.  The
    record keeps the times of plane ``main`` (the one the main path gives
    the kernel), every plane's times under ``tiles`` and the largest
    error of all."""
    recs = {label: check_mc(torch, np, rng, f"{name} {label}", H, W, *tile,
                            **kw)
            for label, tile, H, W in planes}
    rec = dict(recs[main])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    rec["tiles"] = {label: {"ms": r["ms"], "plain_ms": r["plain_ms"]}
                    for label, r in recs.items()}
    return rec


def decode_path(torch, _build, MP2VDecoder, DecoderConfig, name, impl,
                expected):
    """Decode one fixture under ``MP2V_MC_IMPL=impl`` through the decoder's
    entry point with the launch counts reset just before and read just
    after; check the hash, that every kernel of the path launched as often
    as ``expected`` says and that no MC kernel of another implementation
    did; then time warm decodes.  Returns (launches, frames/s)."""
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        want = json.load(f)
    if hashlib.sha256(data).hexdigest() != want["stream_sha256"]:
        fail(f"{name}: the stream fixture does not match its recorded "
             f"sha256")
    os.environ["MP2V_MC_IMPL"] = impl
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    label = f"{name} [{impl}]"
    _build.LAUNCHES.clear()
    frames = dec.decode(data)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    digest, n_bytes = yuv_sha256(frames)
    print(f"decode {label}: {len(frames)} frames, {n_bytes} YUV bytes, "
          f"sha256 {digest}; launches {launches}")
    if len(frames) != want["frames"] or n_bytes != want["yuv_bytes"]:
        fail(f"{label}: decoded {len(frames)} frames / {n_bytes} bytes, "
             f"expected {want['frames']} / {want['yuv_bytes']}")
    if digest != want["yuv_sha256"]:
        fail(f"{label}: YUV sha256 {digest} != JAX reference "
             f"{want['yuv_sha256']}")
    for k, n in expected.items():
        if launches.get(k, 0) != n:
            fail(f"{label}: kernel {k} launched {launches.get(k, 0)} "
                 f"times, expected {n}")
    stray = {k: n for k, n in launches.items()
             if k in MC_KERNELS and k not in expected}
    if stray:
        fail(f"{label}: MC kernels of another implementation launched: "
             f"{stray}")
    runs = DECODE_RUNS[impl]
    walls = []
    for _ in range(runs):
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    fps = len(frames) / wall
    print(f"decode {label} warm: median {wall:.4f} s over {runs} "
          f"runs = {fps:.2f} frames/s (best {min(walls):.4f} s)")
    return launches, fps


def yuv_sha256(frames) -> tuple:
    h = hashlib.sha256()
    n = 0
    for f in frames:
        b = f.tobytes()
        h.update(b)
        n += len(b)
    return h.hexdigest(), n


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    missing = [p for p in [PACKAGE] + [os.path.join(DATA, n + ".m2v")
                                       for n, _ in PATHS]
               if not os.path.exists(p)]
    if missing:
        fail(f"run from a checkout of the repository: {missing} missing")
    sys.path.insert(0, REPO)
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu_torch.ops import _build
    from tiny_mp2v_dec_tpu_torch.tokenizer import build as tok_build

    # 1) the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch device 0: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2) build from this checkout
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.kernel_library()
    t1 = time.perf_counter()
    tok_build.build(force=True)
    t2 = time.perf_counter()
    print(f"build: CUDA kernels {t1 - t0:.1f} s (nvcc sm_90a), "
          f"tokenizer {t2 - t1:.1f} s (g++)")

    # 3) kernels against their plain versions, at 1080-line shapes
    rng = np.random.default_rng(2024)
    rec = {
        "idct8x8": check_idct(torch, np, rng),
        "mc_recon_luma": check_mc(torch, np, rng, "K2 mc_recon_luma",
                                  1088, 1920, 16, 16, uv=False),
        "mc_recon_uv": check_tiles(torch, np, rng, "K3 mc_recon_uv", CHROMA,
                                   "4:2:0", uv=True),
        "mc_field_luma": check_mc(torch, np, rng, "K4 mc_field_luma",
                                  1088, 1920, 16, 16, uv=False, field=True),
        "mc_field_uv": check_tiles(torch, np, rng, "K4 mc_field_uv", CHROMA,
                                   "4:2:2", uv=True, field=True),
        "mc_roll_luma": check_mc(torch, np, rng, "K5 mc_roll_luma",
                                 1088, 1920, 16, 16, uv=False, impl="roll"),
        "mc_roll_uv": check_tiles(torch, np, rng, "K6 mc_roll_uv", CHROMA,
                                  "4:2:0", uv=True, impl="roll"),
        "mc_swar": check_tiles(torch, np, rng, "K7 mc_swar", LUMA + CHROMA,
                               "luma", uv=False, impl="swar"),
        "mc_swar_field": check_tiles(torch, np, rng, "K8 mc_swar_field",
                                     LUMA + CHROMA, "luma", uv=False,
                                     field=True, impl="swar"),
    }

    # 4) end to end through the decoder's entry point, one path at a time
    launches = {}
    for (name, impl), expected in PATHS.items():
        counts, _ = decode_path(torch, _build, MP2VDecoder, DecoderConfig,
                                name, impl, expected)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    csrc = "tiny_mp2v_dec_tpu_torch/csrc/"
    mcp = "tiny_mp2v_dec_tpu/ops/mc_pallas.py"
    sources = {
        "idct8x8": ("idct.cu", "tiny_mp2v_dec_tpu/ops/idct.py:49"),
        "mc_recon_luma": ("mc_recon.cu", f"{mcp}:445"),
        "mc_recon_uv": ("mc_recon.cu", f"{mcp}:489"),
        "mc_field_luma": ("mc_recon.cu", f"{mcp}:353"),
        "mc_field_uv": ("mc_recon.cu", f"{mcp}:353"),
        "mc_roll_luma": ("mc_roll.cu", f"{mcp}:122"),
        "mc_roll_uv": ("mc_roll.cu", f"{mcp}:245"),
        "mc_swar": ("mc_swar.cu", f"{mcp}:769"),
        "mc_swar_field": ("mc_swar.cu", f"{mcp}:805"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": sources[name][1],
                "launches": launches.get(name, 0), **r}
               for name, r in rec.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
