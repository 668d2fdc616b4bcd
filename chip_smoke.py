"""Smoke run of the PyTorch port (``tiny_mp2v_dec_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels (``tiny_mp2v_dec_tpu_torch/csrc/*.cu``, nvcc for
   sm_90a) and the native tokenizer, from this checkout into ``build/``;
3. kernels: K1 (IDCT), K2 (luma MC+recon) and K3 (U+V MC+recon), each on
   the card at the shapes a 1080p chunk gives it, compared with its plain
   PyTorch version on the same inputs — exact equality, as all arithmetic
   is integer — and timed against it (median of CUDA-event-timed runs);
4. end to end: the committed 16-picture 1080p 4:2:0 IBBP stream
   (``tests/data/bench_1080p_420_16.m2v``) through ``MP2VDecoder`` on
   ``cuda`` with launch counts reset just before; every kernel must have
   launched, and the YUV sha256 must equal the one recorded from the JAX
   package (``tests/data/bench_1080p_420_16.json``); then warm decode
   frames/s.

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
FIXTURE = os.path.join(REPO, "tests", "data", "bench_1080p_420_16")
TIMED_RUNS = 20
DECODE_RUNS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def mc_inputs(torch, np, rng, H, W, tile):
    """Random refs, residual and per-MB metadata for one (H, W) plane of
    (tile x tile) MBs: MVs cover all four half-pel phases and the edge
    clamps; modes cover every combination of fwd/bwd/coded."""
    from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_meta
    mbh, mbw = H // tile, W // tile
    n = mbh * mbw
    dev = torch.device("cuda")
    plane = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
    resid = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(-300, 300, (H, W)).astype(np.int16)).to(dev)
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos_y = torch.from_numpy((mb_y * tile).astype(np.int32)).to(dev)
    pos_x = torch.from_numpy((mb_x * tile).astype(np.int32)).to(dev)
    mv = torch.from_numpy(
        rng.integers(-64, 64, (n, 2, 2)).astype(np.int16)).to(dev)
    fwd = mc_meta(pos_y, pos_x, mv[:, 0, 0], mv[:, 0, 1], H, W, tile, tile)
    bwd = mc_meta(pos_y, pos_x, mv[:, 1, 0], mv[:, 1, 1], H, W, tile, tile)
    mode = torch.from_numpy(
        rng.permutation(np.arange(n) % 8).astype(np.int32)).to(dev)
    return plane, resid, (*fwd, *bwd, mode)


def check_mc(torch, np, rng, name, H, W, tile, uv: bool):
    """K2 (uv=False, one plane) or K3 (uv=True, U and V) with ``bidir``
    True and False."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    plane, resid, meta = mc_inputs(torch, np, rng, H, W, tile)
    if uv:
        fn, ref_fn = mc_fused.fused_mc_recon_uv, mc_fused.fused_mc_recon_uv_ref
        args = ((plane(), plane()), (plane(), plane()), (resid(), resid()))
    else:
        fn, ref_fn = mc_fused.fused_mc_recon, mc_fused.fused_mc_recon_ref
        args = (plane(), plane(), resid())
    out = {}
    for bidir in (True, False):
        def kern():
            return fn(*args, *meta, h=tile, w=tile, bidir=bidir)

        def plain():
            return ref_fn(*args, *meta, h=tile, w=tile, bidir=bidir)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = torch.stack(got) if uv else got
        ref = torch.stack(ref) if uv else ref
        err = max_abs_err(torch, got, ref)
        if err or not torch.equal(got, ref):
            fail(f"{name} bidir={bidir} differs from its plain version "
                 f"(max abs err {err})")
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        planes = "2 x " if uv else ""
        print(f"{name} bidir={bidir}: {planes}{H}x{W}, equal to plain; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if bidir:   # the record carries the B-picture (bidir) form
            out = {"ms": ms, "plain_ms": plain_ms}
        out["max_abs_err"] = max(out.get("max_abs_err", 0), err)
    return out


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
    if not os.path.isdir(PACKAGE) or not os.path.exists(FIXTURE + ".m2v"):
        fail(f"run from a checkout of the repository: {PACKAGE} or "
             f"{FIXTURE}.m2v is missing")
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

    # 3) kernels against their plain versions, at 1080p shapes
    rng = np.random.default_rng(2024)
    rec = {
        "idct8x8": check_idct(torch, np, rng),
        "mc_recon_luma": check_mc(torch, np, rng, "K2 mc_recon_luma",
                                  1088, 1920, 16, uv=False),
        "mc_recon_uv": check_mc(torch, np, rng, "K3 mc_recon_uv",
                                544, 960, 8, uv=True),
    }

    # 4) end to end through the decoder's entry point
    with open(FIXTURE + ".m2v", "rb") as f:
        data = f.read()
    with open(FIXTURE + ".json") as f:
        want = json.load(f)
    if hashlib.sha256(data).hexdigest() != want["stream_sha256"]:
        fail("the stream fixture does not match its recorded sha256")
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    _build.LAUNCHES.clear()
    frames = dec.decode(data)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    digest, n_bytes = yuv_sha256(frames)
    print(f"decode: {len(frames)} frames, {n_bytes} YUV bytes, sha256 "
          f"{digest}; launches {launches}")
    if len(frames) != want["frames"] or n_bytes != want["yuv_bytes"]:
        fail(f"decoded {len(frames)} frames / {n_bytes} bytes, expected "
             f"{want['frames']} / {want['yuv_bytes']}")
    if digest != want["yuv_sha256"]:
        fail(f"YUV sha256 {digest} != JAX reference {want['yuv_sha256']}")
    for name in rec:
        if launches.get(name, 0) < 1:
            fail(f"the decode never launched kernel {name}")
    walls = []
    for _ in range(DECODE_RUNS):
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"decode warm: median {wall:.4f} s over {DECODE_RUNS} runs = "
          f"{len(frames) / wall:.2f} frames/s (best {min(walls):.4f} s); "
          f"card: {card}")

    sources = {
        "idct8x8": ("tiny_mp2v_dec_tpu_torch/csrc/idct.cu",
                    "tiny_mp2v_dec_tpu/ops/idct.py:49"),
        "mc_recon_luma": ("tiny_mp2v_dec_tpu_torch/csrc/mc_recon.cu",
                          "tiny_mp2v_dec_tpu/ops/mc_pallas.py:445"),
        "mc_recon_uv": ("tiny_mp2v_dec_tpu_torch/csrc/mc_recon.cu",
                        "tiny_mp2v_dec_tpu/ops/mc_pallas.py:489"),
    }
    kernels = [{"name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": launches[name],
                **r} for name, r in rec.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
