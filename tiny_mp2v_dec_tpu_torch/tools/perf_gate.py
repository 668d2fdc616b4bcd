"""Kernel performance gate on a CUDA card: the port's counterpart of the
JAX package's ``tools/perf_gate.py``, gates 1, 2 and 3.

    python -m tiny_mp2v_dec_tpu_torch.tools.perf_gate

* Gate 1: K2 (``fused_mc_recon``, every MB forward + backward + coded,
  bidir) on a 1088x1920 plane from ``default_rng(0)``, against the gather
  formulation of the JAX gate (two ``mc_unidir_tiles``,
  ``mc_bidir_tiles``, residual add, clip; :func:`gather_recon`).  Device
  time per call (``tbench.cuda_ms``); K2 must be at least 1.25x as fast.
* Gate 2: the ``GopRecon`` chunk step — ``dispatch`` of the 16 pictures
  of ``tests/data/bench_1080p_420_16.m2v`` from zero references: upload,
  pairs to rows, IDCT, the per-picture MC loop — with the hand kernels
  against the same step with their plain versions on the card
  (``use_kernels=False``).  Host time of a step ended by a synchronize
  (``tbench.step_ms``): the host's glue bounds the step, so its device
  time alone would leave out what a user waits for.
  The kernels' step must be at least as fast (1.0x).
* Gate 3: the serving step — ``StreamBatchRecon.dispatch`` of 2 streams
  on the card, the first 2 pictures of the same stream as their pictures,
  B-coded from zero references (the JAX gate's step): upload, one chunk
  transport, each stream's MC — with the hand kernels against their plain versions, timed
  as gate 2 (``tbench.step_ms``) for the same reason.  The kernels' step
  must be at least as fast (1.0x; the JAX gate's 2x held Pallas against an
  XLA gather formulation, which the port does not have).

Each gate also checks that kernels and plain versions give equal outputs.
Prints one JSON record and writes no file.  Exits 0 when the three gates
pass, 1 when one fails, 2 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.mc import mc_bidir_tiles, mc_unidir_tiles, pad_for_mc
from ..ops.mc_fused import fused_mc_recon, mc_meta
from ..ops.mc_rows import plane_of_tiles
from ..ops.recon import GopRecon
from ..parallel.mesh import StreamBatchRecon
from ..runtime.decoder import DecoderConfig, MP2VDecoder

STREAM = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "bench_1080p_420_16.m2v")
MC_GATE, CHUNK_GATE, SERVE_GATE = 1.25, 1.0, 1.0
# streams of gate 3's step
SERVE_STREAMS = 2


def mc_gate_inputs(H: int = 1088, W: int = 1920, seed: int = 0,
                   device="cuda"):
    """Gate 1's inputs, drawn as the JAX gate draws them: a uint8 plane,
    an int16 residual in [-64, 64), one int16 MV per MB in [-63, 64), and
    the per-MB window vectors of that MV for both directions."""
    rng = np.random.default_rng(seed)
    mbw = W // 16
    n = (H // 16) * mbw
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    plane = t(rng.integers(0, 256, (H, W)).astype(np.uint8))
    res = t(rng.integers(-64, 64, (H, W)).astype(np.int16))
    mv = t(rng.integers(-63, 64, (n, 2)).astype(np.int16))
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos_y, pos_x = t((mb_y * 16).astype(np.int32)), t(
        (mb_x * 16).astype(np.int32))
    return SimpleNamespace(
        H=H, W=W, plane=plane, padded=pad_for_mc(plane), res=res,
        mvx=mv[:, 0], mvy=mv[:, 1], pos_y=pos_y, pos_x=pos_x,
        meta=mc_meta(pos_y, pos_x, mv[:, 0], mv[:, 1], H, W, 16, 16),
        mode=torch.full((n,), 7, dtype=torch.int32, device=device))


def gather_recon(x):
    """The JAX gate's gather formulation of bidir luma MC + residual:
    (n, 16, 16) uint8 tiles."""
    pf = mc_unidir_tiles(x.padded, x.pos_y, x.pos_x, x.mvx, x.mvy, 16, 16)
    pb = mc_unidir_tiles(x.padded, x.pos_y, x.pos_x, x.mvx, x.mvy, 16, 16)
    both = mc_bidir_tiles(pf, pb)
    tiles = x.res.reshape(x.H // 16, 16, x.W // 16, 16).permute(
        0, 2, 1, 3).reshape(-1, 16, 16)
    return torch.clamp(both.to(torch.int16) + tiles, 0, 255).to(torch.uint8)


def kernel_recon(x):
    """The same function through K2 (its plain version on the CPU):
    (H, W) uint8."""
    return fused_mc_recon(x.plane, x.plane, x.res, *x.meta, *x.meta, x.mode,
                          h=16, w=16, bidir=True)


def chunk_steps(data: bytes, device, mc_impl: str = "mxu") -> dict:
    """Gate 2's two chunk steps on the pictures of one chunk-sized stream:
    ``{"kernel": fn, "plain": fn}``, each ``fn()`` dispatching the same
    prepared chunk from zero references and returning ``(r0, r1,
    packs)``."""
    seq = MP2VDecoder(DecoderConfig(device=str(device))).tokenize_stream(data)
    geom = seq[0][1]
    toks = [t for t, _, _ in seq]
    pcts = [ph.picture_coding_type for _, _, ph in seq]
    field = any(bool(t.field_pred.any()) for t in toks)
    steps = {}
    for name, use in (("kernel", True), ("plain", False)):
        gr = GopRecon(geom, len(toks), device, field_support=field,
                      mc_impl=mc_impl, use_kernels=use)
        staged = gr.prepare(toks, pcts)
        steps[name] = lambda gr=gr, staged=staged: gr.dispatch(staged)
    return steps


def serve_steps(data: bytes, device, n_streams: int = SERVE_STREAMS,
                mc_impl: str = "mxu") -> dict:
    """Gate 3's two serving steps: ``{"kernel": fn, "plain": fn}``, each
    ``fn()`` dispatching the same staged step of a ``StreamBatchRecon`` of
    ``n_streams`` streams on ``device`` — the first ``n_streams`` pictures
    of ``data``, one a stream, B-coded from zero references — and
    returning ``(refs0, refs1, planes)``."""
    seq = MP2VDecoder(DecoderConfig(device=str(device))).tokenize_stream(data)
    geom = seq[0][1]
    toks = [t for t, _, _ in seq[:n_streams]]
    field = any(bool(t.field_pred.any()) for t in toks)
    is_b, is_ip = [True] * n_streams, [False] * n_streams
    steps = {}
    for name, use in (("kernel", True), ("plain", False)):
        sb = StreamBatchRecon(geom, [device], field, n_streams, mc_impl,
                              use_kernels=use)
        staged = sb.transport.prepare(toks, [3] * n_streams)
        steps[name] = lambda sb=sb, staged=staged: sb.dispatch(
            staged, is_b, is_ip)
    return steps


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return len(a) == len(b) and all(map(_equal, a, b))


def run_gates() -> dict:
    """Gates 1, 2 and 3 on the current CUDA device: the JSON record."""
    from .tbench import card, cuda_ms, step_ms
    rec = {"card": card(), "device": torch.cuda.get_device_name(0)}
    x = mc_gate_inputs(device="cuda")
    rec["mc_equal"] = bool(torch.equal(
        kernel_recon(x), plane_of_tiles(gather_recon(x), x.H, x.W)))
    rec["mc_kernel_ms"] = cuda_ms(lambda: kernel_recon(x))
    rec["mc_gather_ms"] = cuda_ms(lambda: gather_recon(x))
    rec["speedup"] = rec["mc_gather_ms"] / rec["mc_kernel_ms"]
    rec["gate"] = MC_GATE
    with open(STREAM, "rb") as f:
        data = f.read()
    steps = chunk_steps(data, torch.device("cuda"))
    rec["chunk_equal"] = _equal(steps["kernel"](), steps["plain"]())
    rec["chunk_kernel_ms"] = step_ms(steps["kernel"])
    rec["chunk_plain_ms"] = step_ms(steps["plain"])
    rec["chunk_speedup"] = rec["chunk_plain_ms"] / rec["chunk_kernel_ms"]
    rec["chunk_gate"] = CHUNK_GATE
    serve = serve_steps(data, torch.device("cuda"))
    rec["serve_streams"] = SERVE_STREAMS
    rec["serve_equal"] = _equal(serve["kernel"](), serve["plain"]())
    rec["serve_kernel_ms"] = step_ms(serve["kernel"])
    rec["serve_plain_ms"] = step_ms(serve["plain"])
    rec["serve_speedup"] = rec["serve_plain_ms"] / rec["serve_kernel_ms"]
    rec["serve_gate"] = SERVE_GATE
    rec["pass"] = bool(rec["mc_equal"] and rec["chunk_equal"]
                       and rec["serve_equal"]
                       and rec["speedup"] >= MC_GATE
                       and rec["chunk_speedup"] >= CHUNK_GATE
                       and rec["serve_speedup"] >= SERVE_GATE)
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_gate: torch finds no CUDA device — skipped",
              file=sys.stderr)
        return 2
    rec = run_gates()
    print(json.dumps(rec))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
