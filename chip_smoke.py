"""Smoke run of the PyTorch port (``tiny_mp2v_dec_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: the CUDA kernels (``tiny_mp2v_dec_tpu_torch/csrc/*.cu``, nvcc for
   sm_90a) and the native tokenizer, from this checkout into ``build/``;
3. kernels: K1 (IDCT, at the block counts of both fixtures' chunks, warm
   and cold), the chunk transport (:func:`check_transport`: pairs to rows,
   K1's transform and the residual grid in three launches, on both
   fixtures' 16-picture chunks, a batch step of 8 and a chunk of 1, timed
   beside its plain version), K2 (luma
   MC+recon), K3 (U+V MC+recon, at the chroma tile of every format: 8x8,
   16x8, 16x16), K4 (their field form:
   luma 16x16, chroma at every tile), K5 and K6 (the same function through
   aligned window words loaded once, ``MP2V_MC_IMPL=roll``: luma, and U+V
   at every chroma tile), K7 and K8 (packed prediction, four pixels per
   word, frame and field form, ``MP2V_MC_IMPL=swar``: one component per
   call, luma and one chroma plane at every tile; and K7's picture form,
   the three components of a picture in one launch, at 4:2:0, 4:2:2 and
   4:4:4), each on the card at the
   shapes a 1080-line chunk gives it, with ``bidir`` True and False,
   compared with its plain PyTorch version on the same inputs — exact
   equality, as all arithmetic is integer — and timed against it (device
   time per call, see :func:`cuda_ms`); then K9 and K10 (the MC profiler's
   whole-plane prediction, bytes and 4-pixel words) at the profiler's
   1080p inputs, with every window at the bottom and right edges, at every
   ``sx & 3`` at every phase, each also on the tightest plane they take
   (``profile_mc_variants.row_case``), and on a 1088x1904 plane;
   then the blocks form of K2/K3/K4, which the decoder's ``mxu`` path
   launches (:func:`check_blocks`: a picture's residual block grid and
   metadata rows in, luma and U+V, on a 1080p 4:2:0 frame picture and a
   1080-line 4:2:2 field one), equal to its plain version and timed beside
   the vector form's kernel and beside the glue and that kernel together;
   its grouped form, the decoder's one MC launch a group of pictures
   (:func:`check_blocks_group`: 16 pictures of each of those two kinds,
   and the first alone), equal to its plain version and timed beside the
   one-picture launches it replaces; then K2 and K3 on a plane of one MB (:func:`one_mb_times`), K2 on a
   plane of uncoded MBs (:func:`uncoded_time`), K2, K7 and K8 on a plane of
   MBs that all predict in both directions (:func:`mode7_times`) and a
   kernel that does nothing (:func:`empty_times`);
4. end to end, five paths through ``MP2VDecoder`` on ``cuda``: a
   committed fixture under one ``MP2V_MC_IMPL`` (set before the path's
   decoder is built), each with the launch counts reset just before and
   read just after its decode.  The 16-picture 1080p 4:2:0 IBBP stream
   (``tests/data/bench_1080p_420_16.m2v``) under ``mxu`` (the chunk
   transport, K2, K3 in their grouped blocks form, and no launch of their
   vector form nor of the one-picture blocks form), ``roll`` (the transport, K5, K6) and ``swar`` (the transport,
   K7); the interlaced 1080-line 4:2:2 stream with field motion and field
   DCT (``tests/data/interlaced_1080_422_16.m2v``) under ``mxu`` (the
   transport, K4's grouped blocks form) and ``swar`` (the transport, K8).  Each path must launch its kernels exactly as often
   as :data:`PATHS` says and no MC kernel of another implementation, and
   each YUV sha256 must equal the one recorded from the JAX package (the
   ``.json`` beside each stream); then warm decode frames/s of each.
   Then both streams under ``mxu`` at ``gop_chunk=4``
   (:data:`PIPELINED`): four chunks through the decoder's pipeline (the
   caller's thread tokenizes, a fill thread prepares, a dispatch thread
   uploads and launches), once with ``pictures_pool_size=0`` and frames
   left on the device and once with a pool of one and host output (each
   chunk's frames copied to pinned host memory as soon as its kernels are
   queued), each to the same hash with the transport once a chunk; their
   warm frames/s and the overlap figure ``(tokenize_s + fill_s +
   device_s) / wall`` (above 1: the stages ran at the same time), beside
   the host's CPU count.  Last, the main path over several chunks
   (:data:`MULTI_CHUNK`): each stream four times over in one stream
   (``fixtures.repeat_stream`` of the package) under ``mxu`` at
   ``gop_chunk=16``, each 16-frame group to the fixture's hash, every
   launch four times the one-chunk decode's, with the host memory the
   decoder keeps after it (:func:`host_kept_bytes`);
5. the MC profiler and the kernel gate: the parity run of
   ``tools/profile_mc_variants.py`` (variants b, c = K9 and d = K10 equal
   to a), with the launch counts reset just before and read just after —
   exactly one launch each of K9 and K10 and of no other kernel — then
   gates 1–3 of ``tools/perf_gate.py``, which must pass;
6. the entry points, each phase timed: (a) natural content, the committed
   SD stream (``tests/data/natural_576_420_16.m2v``, 720x576 4:2:0, made by
   ``tests/natural_m2v.py``'s motion search) under ``mxu``, ``roll`` and
   ``swar`` at ``gop_chunk`` 0, 4 and 16 (:data:`NATURAL`), each to its
   JAX hash with the launches of :func:`natural_launches`; (b) the bench,
   ``python3 -m tiny_mp2v_dec_tpu_torch.bench --repeats 3 --warmup 1`` on
   the 64-picture stream, which must exit 0 after its own hash checks,
   report its hash decode's launches as :data:`BENCH_LAUNCHES` says and end
   with its four-key JSON line, its ``#`` lines printed here; (c) the CLI,
   ``python3 -m tiny_mp2v_dec_tpu_torch.cli`` on the 16-picture 4:2:0
   fixture at ``--gop-chunk`` 0 and 16, writing YUV into a temporary
   directory whose sha256 must be the fixture's recorded one;
7. the serving and row-sharded paths, each phase timed, each decode with
   the launch counts reset just before and read just after, every stream
   to its JAX hash and every launch count exact: (a)
   ``MP2VDecoder.decode_batch`` of four committed streams (:data:`BATCH`:
   three geometry groups, two 1080p 4:2:0 streams of unequal length, the
   shorter padded with no-op pictures, the interlaced stream on K4) under
   ``mxu``, the two 1080p 4:2:0 streams also under ``roll`` and ``swar``
   (:data:`BATCH_CASES`: the transport once a step); (b) serving at width: 16 copies
   of the 16-picture 1080p 4:2:0 stream in one batch
   (:data:`SERVE_LAUNCHES`), beside two independent decoders on two
   threads (the bench's chip-capacity run) on the same stream; (c) first
   the MC kernels of the row path at its shapes (:func:`check_bands`:
   each of 4 bands of 17 MB rows of a 1080-line picture, K7 and K8 given
   the band's rows as ``H=``, K2–K4's vector form the band's residual
   rows, their blocks form the band's grid, rows and first MB, each equal
   to its plain version on the band and to the same rows of the
   whole-picture launch), then ``mesh="rows"`` in those 4 bands on the
   1080p 4:2:0 and the interlaced streams under ``mxu`` and ``swar``
   (:data:`ROWS`: the transport once a picture); each with warm frames/s.  Gate 3
   (the serving step) is in phase 5's ``perf_gate`` record;
8. the multi-host paths on the card, each phase timed, each fixture four
   times over as plain bytes (``data * 4``, every copy with its sequence
   end code, which ``split_gops`` cuts into four closed chunks of 16
   pictures; one decoder would stop at the first end code), every 16-frame
   group to the fixture's JAX hash and the launches summed over the
   processes exact (:data:`MULTI_CHUNK`): (a) ``MultiHostDecoder(n,
   device="cuda", config_kwargs={"gop_chunk": 16})`` for n = 1 and 2 on
   the 1080p 4:2:0 stream (:data:`HOST_RUNS`), each pool warmed first,
   with warm frames/s, the efficiency ``T1 / (2 * T2)`` of
   ``tools/bench_multihost.py`` (best decodes), the host's CPU count and
   each worker's peak thread count, and the same with the frames dropped
   in the workers instead of sent back through the pool's pipe
   (:func:`_decode_only`), beside the time the pool takes to return one
   chunk's bytes from a worker;
   then the interlaced stream at n = 2;
   (b) ``DistributedDecoder`` in :data:`RANKS` spawned ``gloo`` ranks on
   the card (:func:`_rank_main`), whose ``merge_display_order`` gives the
   four hashes, whose chunk indices are disjoint and cover the stream, and
   whose grid has :data:`RANKS` hosts; (c) the CLI with ``--hosts 2`` on
   the 16-picture 4:2:0 fixture, its file's sha256 the fixture's.

The line before the last is the kernels' JSON record: per kernel its
launches on its paths (the bench's hash decode and the multi-host paths'
workers and ranks among them), its error and
device time against its plain version, and its bound (:func:`bound`);
the line before it K2's and K3's one-MB times, K2's uncoded time, the
all-mode-7 times and the empty kernel's; the last line is
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import multiprocessing
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(REPO, "tiny_mp2v_dec_tpu_torch")
DATA = os.path.join(REPO, "tests", "data")
# MC launches under mxu (the grouped blocks form of K2/K3 or K4, one a
# group of pictures that read no output of one another: ops/recon.py
# mc_groups) of the 16-picture fixtures, whose decode order is I P B B P B
# B ...: by gop_chunk, {I} {P} {B B P} x4 {B B} in one chunk of 16; 3 + 2 +
# 2 + 2 in four chunks of 4; a picture a chunk at gop_chunk=0
MXU_GROUPS = {16: 7, 4: 9, 0: 16}
# end-to-end paths: (fixture, MP2V_MC_IMPL) -> the launches of its decode
# (one chunk of 16 pictures: the chunk transport once, its three launches
# counted; under mxu the grouped blocks form of K2/K3 or K4 once a group;
# the two-plane MC kernels of roll and K7's picture form once per picture,
# K8 once per component per picture; no launch of K1 alone)
PATHS = {
    ("bench_1080p_420_16", "mxu"): {
        "transport": 3, "mc_recon_blocks_group": MXU_GROUPS[16]},
    ("interlaced_1080_422_16", "mxu"): {
        "transport": 3, "mc_field_blocks_group": MXU_GROUPS[16]},
    ("bench_1080p_420_16", "roll"): {
        "transport": 3, "mc_roll_luma": 16, "mc_roll_uv": 16},
    ("bench_1080p_420_16", "swar"): {"transport": 3, "mc_swar_yuv": 16},
    ("interlaced_1080_422_16", "swar"): {"transport": 3, "mc_swar_field": 48},
}
# pipelined paths, under mxu at gop_chunk=4: the transport once for each
# of the four chunks, the MC kernels once a group of each chunk
PIPELINED = {
    "bench_1080p_420_16": {
        "transport": 12, "mc_recon_blocks_group": MXU_GROUPS[4]},
    "interlaced_1080_422_16": {
        "transport": 12, "mc_field_blocks_group": MXU_GROUPS[4]},
}
# (pictures_pool_size, output_host) of each pipelined path's two decodes
DELIVERY = ((0, False), (1, True))
# the main path over several chunks: each fixture REPEAT times over in one
# stream (repeat_stream), under mxu at gop_chunk=16, so every launch REPEAT
# times that of the fixture's one-chunk decode
REPEAT = 4
MULTI_CHUNK = {name: {k: n * REPEAT for k, n in PATHS[name, "mxu"].items()}
               for name in PIPELINED}
# natural content (phase 6a): the SD stream at each of these chunk sizes
# under each MP2V_MC_IMPL
NATURAL = "natural_576_420_16"
NATURAL_CHUNKS = (0, 4, 16)
# the launches of the bench's hash decode: the 64-picture stream (one GOP,
# I P B B P B B ... in decode order) under mxu at gop_chunk=16, four
# chunks: 7 MC groups in the first, 6 in each other ({P} {B B P} x5; {B B
# P} x5 {B}; {B P} {B B P} x4 {B B})
BENCH_LAUNCHES = {"transport": 12, "mc_recon_blocks_group": 25}
# phase 7 (a): decode_batch of these streams (three geometry groups; two
# 1080p 4:2:0 streams of unequal length; the interlaced stream on K4);
# MP2V_MC_IMPL -> (streams, launches on one card: the transport once a step
# (three launches), the longest stream of a group setting its steps; under
# mxu the MC kernels once a step, all of the step's streams in one launch;
# under roll and swar once a stream a step, no-op padding included)
BATCH = ("bench_1080p_420_16", "bench_1080p_420_8", "interlaced_1080_422_16",
         NATURAL)
BATCH_CASES = {
    "mxu": (BATCH, {"transport": 144, "mc_recon_blocks_group": 32,
                    "mc_field_blocks_group": 16}),
    "roll": (BATCH[:2], {"transport": 48, "mc_roll_luma": 32,
                         "mc_roll_uv": 32}),
    "swar": (BATCH[:2], {"transport": 48, "mc_swar_yuv": 32}),
}
# phase 7 (b): serving at width, this many copies of the 16-picture 1080p
# 4:2:0 stream in one batch (BASELINE.json's "16x 1080p"), under mxu
SERVE = "bench_1080p_420_16"
SERVE_COPIES = 16
SERVE_LAUNCHES = {"transport": 48, "mc_recon_blocks_group": 16}
# phase 7 (c): mesh="rows" in this many bands (68 MB rows: 17 a band);
# (fixture, MP2V_MC_IMPL) -> launches: the transport once a picture (three
# launches), the MC kernels
# once a band a picture (under mxu a group of one, luma and U+V in one
# launch; the interlaced stream's I picture, which has no field MB, on the
# frame kernels)
ROW_BANDS = 4
ROWS = {
    ("bench_1080p_420_16", "mxu"): {
        "transport": 48, "mc_recon_blocks_group": 64},
    ("bench_1080p_420_16", "swar"): {"transport": 48, "mc_swar_yuv": 64},
    ("interlaced_1080_422_16", "mxu"): {
        "transport": 48, "mc_recon_blocks_group": 4,
        "mc_field_blocks_group": 60},
    ("interlaced_1080_422_16", "swar"): {
        "transport": 48, "mc_swar_yuv": 4, "mc_swar_field": 180},
}
# phase 8: the multi-host paths, each fixture REPEAT times over as plain
# bytes (four closed chunks), under mxu at gop_chunk=16: (fixture, worker
# processes) of each MultiHostDecoder run, in order; the launches summed
# over the workers (or ranks) are MULTI_CHUNK's
HOST_RUNS = (("bench_1080p_420_16", 1), ("bench_1080p_420_16", 2),
             ("interlaced_1080_422_16", 2))
HOST_CONFIG = {"gop_chunk": 16}
# warm decodes timed on each pool, each way (frames back, decode only)
HOST_DECODES = 2
# DistributedDecoder ranks (phase 8b), on the 1080p 4:2:0 stream, and the
# seconds each may take to start, decode and report
RANKS = 2
RANK_STREAM = "bench_1080p_420_16"
RANK_TIMEOUT = 240
# seconds the bench (run short) and each CLI decode may take
ENTRY_TIMEOUT = 300
# the vector form of K2/K3/K4, which no decode path launches since the
# blocks form took its place under mxu, and the blocks form's one-picture
# entries, which none launches since the grouped form took theirs
VECTOR_FORM = ("mc_recon_luma", "mc_recon_uv", "mc_field_luma",
               "mc_field_uv")
ONE_PICTURE = ("mc_recon_blocks_luma", "mc_recon_blocks_uv",
               "mc_field_blocks_luma", "mc_field_blocks_uv")
# every MC kernel's counter: the paths', K7's one-component form, the
# vector form of K2/K3/K4 and the blocks form's one-picture entries, which
# no path launches
MC_KERNELS = ({k for counts in PATHS.values() for k in counts}
              | {"mc_swar", *VECTOR_FORM, *ONE_PICTURE}) - {"transport",
                                                            "idct8x8"}
TIMED_RUNS = 20
# the card's peaks for the bound (H100 SXM data sheet): HBM bytes and
# non-tensor arithmetic per ms; the data sheet lists no rate for integer
# arithmetic outside the tensor cores, so it counts at the float32 one
HBM_BYTES_PER_MS = 3.35e9
OPS_PER_MS = 67e9
# integer operations per output element (pixel, word or coefficient),
# counted on the plain versions' arithmetic at the costliest phase: a
# half-pel average is 3, an MPEG clip 2; the IDCT's two butterfly passes
# about 24 each per coefficient
OPS_PER_OUT = {"idct8x8": 50, "recon": 27, "swar": 17, "mc_row": 10,
               "mc_row_packed": 10}
# K1's blocks in one 16-picture chunk of each fixture (cap_k of
# GopRecon._decode_blob): bench_1080p_420_16, interlaced_1080_422_16
IDCT_BLOCKS = (131072, 196608)
# input/output pairs K1's cold time takes in turn: 4 x 33.5 MB at 131,072
# blocks, well past the card's 50 MB L2
COLD_PAIRS = 4
# warm decodes per path: the two mxu paths 5, the others 3 (time limit)
DECODE_RUNS = {"mxu": 5, "roll": 3, "swar": 3}
# (label, tile, plane rows, plane columns) of each plane a kernel takes
LUMA = (("luma", (16, 16), 1088, 1920),)
CHROMA = (("4:2:0", (8, 8), 544, 960), ("4:2:2", (16, 8), 1088, 960),
          ("4:4:4", (16, 16), 1088, 1920))
# the blocks form's pictures (check_blocks, and on the row path's bands
# check_bands): (label, chroma format, field rows) of the two 1080-line
# streams; MB grid 120 x 68
BLOCK_PICTURES = (("4:2:0 frame", 1, False), ("4:2:2 field", 2, True))
BLOCK_MBW, BLOCK_MBH = 120, 68
# phase 7 (c)'s MC kernels on the row path's bands (check_bands): the
# vector form of K2-K4, and the SWAR kernels (kernel, MP2V_MC_IMPL, U+V,
# field, the planes the row path gives it on the two 1080-line streams)
BAND_MC = (
    ("K2 mc_recon_luma", "mxu", False, False, LUMA),
    ("K3 mc_recon_uv", "mxu", True, False, CHROMA[:1]),
    ("K4 mc_field_luma", "mxu", False, True, LUMA),
    ("K4 mc_field_uv", "mxu", True, True, CHROMA[1:2]),
    ("K8 mc_swar_field", "swar", False, True, LUMA + CHROMA[1:2]),
)
# ... and K7's picture form, at the chroma planes of both streams
BAND_YUV = CHROMA[:2]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


@functools.lru_cache(maxsize=None)
def _fixtures():
    """This checkout's ``tiny_mp2v_dec_tpu_torch/fixtures.py`` (the
    fixtures' records, ``repeat_stream``), loaded by path:
    ``tools/ab_decode.py`` decodes other checkouts' packages with it."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_fixtures", os.path.join(PACKAGE, "fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _tbench():
    """This checkout's ``tiny_mp2v_dec_tpu_torch/tools/tbench.py``, loaded
    by path: ``tools/ab_kernel_times.py`` times other checkouts' kernels
    through :func:`cuda_ms`, and those may not have the module."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_tbench", os.path.join(PACKAGE, "tools", "tbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``tbench.cuda_ms`` (calls
    queued behind a GPU sleep that outlasts their enqueue, timed by CUDA
    events; the mean over ``runs``)."""
    return _tbench().cuda_ms(fn, runs, warmup)


def bound(tensors_in, tensors_out, ops_per_out: int,
          read_bytes: int = 0) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input tensor read once, each output written once, plus
    ``read_bytes`` of inputs of which only part is needed, counted by the
    caller) over the memory rate and its operations (``ops_per_out`` per
    output element) over the arithmetic rate.  No PyTorch call computes
    any of these bit-exact integer functions, so ``library_ms`` is null."""
    nbytes = read_bytes + sum(t.numel() * t.element_size()
                              for t in (*tensors_in, *tensors_out))
    ops = ops_per_out * sum(t.numel() for t in tensors_out)
    b_ms, o_ms = nbytes / HBM_BYTES_PER_MS, ops / OPS_PER_MS
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None}


def max_abs_err(torch, got, ref) -> int:
    return int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())


def idct_cold_ms(torch, fn, x, pairs: int = COLD_PAIRS) -> float:
    """Device ms per call of ``fn`` (K1 or its plain version) taken in turn
    on ``pairs`` copies of ``x``, each call's output kept until its copy
    comes round again: every call reads an input and writes an output that
    the traffic of the calls between has pushed out of the card's L2 (50
    MB), as a flush would.  :func:`cuda_ms` on one input is the warm
    time."""
    xs = [x] + [x.clone() for _ in range(pairs - 1)]
    outs = [None] * pairs
    calls = [0]

    def call():
        j = calls[0] % pairs
        outs[j] = fn(xs[j])
        calls[0] += 1

    return cuda_ms(torch, call)


def check_idct(torch, np, rng):
    """K1 at the block counts of the two fixtures' chunks (the 4:2:0
    fixture's first, its record the main one), each including all-zero and
    saturating rows: equal to the plain version, device time warm (the same
    tensors again, served from L2 where they fit) and cold
    (:func:`idct_cold_ms`), and the bound.  The decoder's paths run K1's
    transform inside the chunk transport (:func:`check_transport`), not
    this kernel."""
    from tiny_mp2v_dec_tpu_torch.ops.idct import idct_blocks, idct_blocks_ref
    recs = {}
    for n in IDCT_BLOCKS:
        # the first count from the run's generator, as before there was a
        # second; the second from its own
        gen = rng if not recs else np.random.default_rng(n)
        coeffs = gen.integers(-2048, 2048, (n, 64)).astype(np.int16)
        coeffs[0] = 0
        coeffs[1] = 2047
        coeffs[2] = -2048
        x = torch.from_numpy(coeffs).cuda()
        got = idct_blocks(x)
        ref = idct_blocks_ref(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, ref)
        if err or not torch.equal(got, ref):
            fail(f"K1 idct8x8 on {n} blocks differs from its plain version "
                 f"(max abs err {err})")
        rec = {"max_abs_err": err,
               "ms": cuda_ms(torch, lambda: idct_blocks(x)),
               "cold_ms": idct_cold_ms(torch, idct_blocks, x),
               "plain_ms": cuda_ms(torch, lambda: idct_blocks_ref(x)),
               **bound((x,), (got,), OPS_PER_OUT["idct8x8"])}
        print(f"K1 idct8x8: {n} blocks, equal to plain; kernel "
              f"{rec['ms']:.4f} ms warm, {rec['cold_ms']:.4f} ms cold, "
              f"plain {rec['plain_ms']:.4f} ms; bound "
              f"{rec['bound_ms']:.4f} ms")
        recs[n] = rec
    main = dict(recs[IDCT_BLOCKS[0]])
    main["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    main["blocks"] = {str(n): {k: r[k] for k in ("ms", "cold_ms", "plain_ms",
                                                  "bound_ms")}
                      for n, r in recs.items()}
    return main


# (label, fixture, chunk, the fixture's pictures, batch step form) that
# check_transport decodes, the first the main record: the chunk
# pipeline's 16-picture chunks of both fixtures, a decode_batch step of 8
# streams (one picture each, picture types as the step flags give them:
# B or not) and the latency path's chunk of one picture
TRANSPORT_CASES = (
    ("chunk of 16", "bench_1080p_420_16", 16, range(16), False),
    ("chunk of 16", "interlaced_1080_422_16", 16, range(16), False),
    ("batch step of 8", "bench_1080p_420_16", 8, range(0, 16, 2), True),
    ("chunk of 1", "bench_1080p_420_16", 1, range(1), False),
)


def check_transport(torch) -> dict:
    """The chunk transport (``csrc/transport.cu``, three launches) on each
    of :data:`TRANSPORT_CASES` as the decoder prepares and uploads it:
    ``(dense, meta, flags)`` equal to the plain version's, with the device
    ms of the kernel (``ms``) and of the plain version, and the bound: the
    grid written and the blob's sections read (pairs, counts, block
    positions, rows a picture) over the memory rate, beside K1's
    operations on the coded rows over the arithmetic rate."""
    from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder
    from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon
    recs = {}
    for label, name, chunk, pictures, batch in TRANSPORT_CASES:
        data, _ = _fixtures().load(name)
        toks = MP2VDecoder(DecoderConfig(device="cpu")).tokenize_stream(data)
        toks = [toks[i] for i in pictures]
        field = any(bool(t.field_pred.any()) for t, _, _ in toks)
        pcts = [ph.picture_coding_type for _, _, ph in toks]
        if batch:
            # StreamBatchRecon.step's picture types: B, or I/P as 2
            pcts = [3 if p == 3 else 2 for p in pcts]
        rec = GopRecon(toks[0][1], chunk, "cuda", field_support=field)
        staged = rec.prepare([t for t, _, _ in toks], pcts)
        (cap_pairs, cap_k), _, _ = staged
        up = rec._upload_released(staged)
        kw = dict(cap_pairs=cap_pairs, cap_k=cap_k)

        def kern():
            return rec._decode_blob(up, **kw)

        def plain():
            return rec._decode_blob_ref(up, **kw)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        for part, g, w in zip(("dense", "meta", "flags"), got, want):
            if not torch.equal(g, w):
                fail(f"transport {name} {label}: {part} differs from the "
                     f"plain version's (max abs err "
                     f"{max_abs_err(torch, g, w)})")
        coded = sum(t.n_coded_blocks for t, _, _ in toks)
        read = rec._layout(cap_pairs, cap_k)[5]
        b_ms = (read + got[0].numel() * 2) / HBM_BYTES_PER_MS
        o_ms = coded * 64 * OPS_PER_OUT["idct8x8"] / OPS_PER_MS
        r = {"max_abs_err": 0, "ms": cuda_ms(torch, kern),
             "plain_ms": cuda_ms(torch, plain),
             "bound_ms": max(b_ms, o_ms),
             "bound_by": "bytes" if b_ms >= o_ms else "operations",
             "library_ms": None, "chunk": chunk, "pictures": len(toks),
             "rows": cap_k, "coded_rows": coded,
             "grid_bytes": got[0].numel() * 2, "blob_bytes_read": read}
        print(f"transport {name} {label}: {len(toks)} pictures, {coded} "
              f"coded rows of {cap_k}, grid {r['grid_bytes'] / 1e6:.1f} MB; "
              f"equal to plain; kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; operations {o_ms:.4f} ms)")
        recs[f"{name} {label}"] = r
    main = dict(next(iter(recs.values())))
    main["chunks"] = {n: {k: r[k] for k in ("chunk", "pictures", "ms",
                                            "plain_ms", "bound_ms")}
                      for n, r in recs.items()}
    return main


def mc_inputs(torch, np, rng, H, W, th, tw, field, mode_all=None,
              device="cuda", field_share=0.5):
    """Random refs, residual and per-MB metadata for one (H, W) plane of
    (th x tw) MBs on ``device``: MVs cover all four half-pel phases and the
    edge clamps; modes cover every combination of fwd/bwd/coded, or are all
    ``mode_all``.  ``field``: also the field tuples of both directions
    (random field selects, MVs of both units), with the field bit on a
    ``field_share`` of the MBs, drawn at random."""
    from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_meta
    mbh, mbw = H // th, W // tw
    n = mbh * mbw
    dev = torch.device(device)
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
    if mode_all is not None:
        mode = np.full(n, mode_all)
    if field:
        # imported here: tools/ab_kernel_times.py runs the frame form on
        # checkouts that have no field form
        from tiny_mp2v_dec_tpu_torch.ops.mc_fused import mc_field_meta
        mvfs = t(rng.integers(0, 2, (n, 2, 2)).astype(np.uint8))
        mode = mode + 8 * (rng.random(n) < field_share)
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
             field: bool = False, impl: str = "mxu", mode_all=None,
             field_share: float = 0.5):
    """The MC kernel of ``impl`` (see :func:`mc_kernel`) on one (H, W)
    plane, or U and V with ``uv``, with ``bidir`` True and False (its time
    in ``fwd_ms``), every MB at ``mode_all`` if given, the field bit on a
    ``field_share`` of the MBs with ``field``.  The SWAR kernels' words are
    compared as words and their error read on the unpacked pixels."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    plane, resid, meta = mc_inputs(torch, np, rng, H, W, th, tw, field,
                                   mode_all, field_share=field_share)
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
            # the inputs count by the bytes this run's modes need
            read = mc_read_bytes(torch, meta, H, W, th, tw,
                                 n_planes=2 if uv else 1, field=field,
                                 recon=impl != "swar")
            out = {"ms": ms, "plain_ms": plain_ms, **bound(
                (), (got,), OPS_PER_OUT["swar" if impl == "swar" else "recon"],
                read)}
        else:
            out["fwd_ms"] = ms
        out["max_abs_err"] = max(out.get("max_abs_err", 0), err)
    return out


def swar_yuv_read_bytes(torch, meta_y, meta_c, Hc: int, Wc: int, th: int,
                        tw: int) -> int:
    """Input bytes a bidir call of K7's picture form needs: the three
    components' :func:`mc_read_bytes` — luma 16x16 on the (Hc*16/th,
    Wc*16/tw) plane with ``meta_y``, U and V (th x tw) on (Hc, Wc) planes
    sharing ``meta_c`` — with the mode vector, which all three share,
    counted once."""
    luma = mc_read_bytes(torch, meta_y, Hc * 16 // th, Wc * 16 // tw, 16, 16,
                         n_planes=1, field=False, recon=False)
    chroma = mc_read_bytes(torch, meta_c, Hc, Wc, th, tw, n_planes=2,
                           field=False, recon=False)
    return luma + chroma - 4 * meta_y[6].numel()


def check_swar_yuv(torch, np, rng, label, tile, Hc, Wc):
    """K7's picture form on one picture with (Hc, Wc) chroma planes of
    ``tile`` MBs (luma 16x16 on the same MB grid), random vectors per
    component and one mode vector, against its plain version, ``bidir`` True
    and False; the record of :func:`check_mc`.  In a checkout without the
    picture form (``tools/ab_kernel_times.py`` runs this on other
    checkouts) the kernel side is the three one-component launches it
    replaces, timed as one callable."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    th, tw = tile
    Hy, Wy = Hc * 16 // th, Wc * 16 // tw
    plane_y, _, meta_y = mc_inputs(torch, np, rng, Hy, Wy, 16, 16, False)
    plane_c, _, meta_c = mc_inputs(torch, np, rng, Hc, Wc, th, tw, False)
    mode = meta_y[6]
    meta_c = [*meta_c[:6], mode]
    ref0 = (plane_y(), plane_c(), plane_c())
    ref1 = (plane_y(), plane_c(), plane_c())
    comps = ((16, 16, meta_y), (th, tw, meta_c), (th, tw, meta_c))
    yuv = getattr(mc_fused, "fused_mc_pred_swar_yuv", None)
    name = f"K7 mc_swar_yuv {label}"
    out = {}
    for bidir in (True, False):
        def per_component(fn):
            return tuple(fn(r0, r1, *m, h=h, w=w, bidir=bidir)
                         for r0, r1, (h, w, m) in zip(ref0, ref1, comps))

        def kern():
            if yuv is None:
                return per_component(mc_fused.fused_mc_pred_swar)
            return yuv(ref0, ref1, meta_y[:6], meta_c[:6], mode, h=th, w=tw,
                       bidir=bidir)

        def plain():
            return per_component(mc_fused.fused_mc_pred_swar_ref)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, mc_fused.unpack_words(g),
                              mc_fused.unpack_words(r))
                  for g, r in zip(got, ref))
        if err or not all(torch.equal(g, r) for g, r in zip(got, ref)):
            fail(f"{name} bidir={bidir} differs from its plain version "
                 f"(max abs err {err})")
        ms, plain_ms = cuda_ms(torch, kern), cuda_ms(torch, plain)
        print(f"{name} bidir={bidir}: {Hy}x{Wy} + 2 x {Hc}x{Wc} in {th}x{tw} "
              f"tiles, equal to plain; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms")
        if bidir:
            read = swar_yuv_read_bytes(torch, meta_y, meta_c, Hc, Wc, th, tw)
            out = {"ms": ms, "plain_ms": plain_ms,
                   **bound((), got, OPS_PER_OUT["swar"], read)}
        else:
            out["fwd_ms"] = ms
        out["max_abs_err"] = max(out.get("max_abs_err", 0), err)
    return out


def check_tiles(torch, np, rng, name, planes, main, check=None, **kw):
    """:func:`check_mc` (or ``check``, called as :func:`check_swar_yuv`) on
    each (label, tile, H, W) of ``planes``.  The record keeps the times of
    plane ``main`` (the one the main path gives the kernel), every plane's
    times under ``tiles`` and the largest error of all."""
    if check is None:
        def check(torch, np, rng, label, tile, H, W):
            return check_mc(torch, np, rng, f"{name} {label}", H, W, *tile,
                            **kw)
    recs = {label: check(torch, np, rng, label, tile, H, W)
            for label, tile, H, W in planes}
    rec = dict(recs[main])
    rec["max_abs_err"] = max(r["max_abs_err"] for r in recs.values())
    rec["tiles"] = {label: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
                    for label, r in recs.items()}
    return rec


@functools.lru_cache(maxsize=None)
def _blocks_cases():
    """This checkout's ``tests/blocks_cases.py`` (the blocks form's random
    pictures, which ``tests/test_torch_gpu.py`` uses too), loaded by
    path."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_blocks_cases",
        os.path.join(REPO, "tests", "blocks_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blocks_inputs(torch, np, rng, cf: int, field: bool):
    """One 1080-line picture of :data:`BLOCK_MBW` x :data:`BLOCK_MBH` MBs
    for the blocks form on the card: ((Y, U, V) references twice, the
    residual block grid, the metadata rows as the chunk blob carries them),
    ``blocks_cases.blocks_case``'s draws: dct_type, uncoded MBs, every
    phase, windows clamped at every edge, and with ``field`` field
    prediction with selects of both parities."""
    refs0, refs1, dense, meta = _blocks_cases().blocks_case(
        rng, cf, field, BLOCK_MBW, BLOCK_MBH)
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return (tuple(map(t, refs0)), tuple(map(t, refs1)), t(dense), t(meta))


def check_blocks(torch, np, rng) -> dict:
    """The blocks form of K2/K3/K4, which the decoder's mxu path launches,
    on each picture of :data:`BLOCK_PICTURES` (luma, then U+V), ``bidir``
    True and False: equal to its plain version, with the device ms of the
    kernel (``ms``, ``fwd_ms``), of the vector form's kernel alone on the
    same picture's vectors and planes (``vector_ms``), of the per-picture
    glue and that kernel together (``glue_ms``: what the decoder's path
    ran for the component before the blocks form), of the plain version,
    and the bound (the bytes this picture's modes need, the metadata rows
    in place of the vectors).  Returns the four entry points' records."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    out = {}
    for label, cf, field in BLOCK_PICTURES:
        r0, r1, dense, meta = blocks_inputs(torch, np, rng, cf, field)
        form = "field" if field else "recon"
        for uv in (False, True):
            name = f"mc_{form}_blocks_{'uv' if uv else 'luma'}"
            fn, ref_fn, vec_fn = (
                (mc_fused.fused_mc_recon_uv_blocks,
                 mc_fused.fused_mc_recon_uv_blocks_ref,
                 mc_fused.fused_mc_recon_uv) if uv else
                (mc_fused.fused_mc_recon_blocks,
                 mc_fused.fused_mc_recon_blocks_ref,
                 mc_fused.fused_mc_recon))
            a0, a1 = (tuple(r0[1:]), tuple(r1[1:])) if uv else (r0[0], r1[0])
            ref = r0[1] if uv else r0[0]
            rec = {}
            for bidir in (True, False):
                kw = dict(chroma_format=cf, mbw=BLOCK_MBW, bidir=bidir)

                def kern():
                    return fn(a0, a1, dense, meta, **kw)

                def plain():
                    return ref_fn(a0, a1, dense, meta, **kw)

                def glue():
                    res, vecs, h, w = mc_fused.blocks_to_vectors(
                        ref, dense, meta, cf, BLOCK_MBW, uv=uv)
                    return vec_fn(a0, a1, res if uv else res[0], *vecs, h=h,
                                  w=w, bidir=bidir)

                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = torch.stack(got) if uv else got
                want = torch.stack(want) if uv else want
                err = max_abs_err(torch, got, want)
                if err or not torch.equal(got, want):
                    fail(f"{name} {label} bidir={bidir} differs from its "
                         f"plain version (max abs err {err})")
                res, vecs, h, w = mc_fused.blocks_to_vectors(
                    ref, dense, meta, cf, BLOCK_MBW, uv=uv)
                vec_args = (a0, a1, res if uv else res[0], *vecs)
                ms = cuda_ms(torch, kern)
                if bidir:
                    vec_ms = cuda_ms(torch, lambda: vec_fn(
                        *vec_args, h=h, w=w, bidir=bidir))
                    glue_ms = cuda_ms(torch, glue)
                    plain_ms = cuda_ms(torch, plain)
                    H, W = ref.shape
                    flat = [*vecs[:7], *(vecs[7:] if field else ())]
                    read = mc_read_bytes(
                        torch, flat, H, W, h, w, n_planes=2 if uv else 1,
                        field=field, recon=True,
                        meta_bytes=2 * meta.numel())
                    rec = {"ms": ms, "vector_ms": vec_ms, "glue_ms": glue_ms,
                           "plain_ms": plain_ms,
                           **bound((), (got,), OPS_PER_OUT["recon"], read)}
                    print(f"{name} {label} bidir=True: equal to plain; "
                          f"kernel {ms:.4f} ms, the vector form's kernel "
                          f"{vec_ms:.4f} ms, glue + vector form "
                          f"{glue_ms:.4f} ms, plain {plain_ms:.4f} ms; "
                          f"bound {rec['bound_ms']:.5f} ms")
                else:
                    rec["fwd_ms"] = ms
                    print(f"{name} {label} bidir=False: equal to plain; "
                          f"kernel {ms:.4f} ms")
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0), err)
            out[name] = rec
    return out


def check_blocks_group(torch, np, rng) -> dict:
    """The grouped blocks form, which the decoder's mxu path launches, on a
    chunk of 16 pictures of each of :data:`BLOCK_PICTURES` — the two
    references shared, as a group's pictures share them, and each picture
    bidir or forward-only as the offline chunk's decode order (I P B B P B
    B ...) makes it — and on its first picture alone: each ``torch.equal``
    to the plain version (the one-picture plain versions, picture by
    picture).  Device ms of the group's one launch (``ms``), of the 32
    one-picture launches it replaces (``replaced_ms``), of the group of
    one and of the two launches it replaces (``one_ms``,
    ``one_replaced_ms``), of the plain version, and the bound (the bytes
    the pictures' modes need, each picture's metadata rows once).  Returns
    the two entry points' records."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    out = {}
    for label, cf, field in BLOCK_PICTURES:
        r0, r1, _, _ = blocks_inputs(torch, np, rng, cf, field)
        pictures = []
        for k in range(16):
            _, _, dense, meta = blocks_inputs(torch, np, rng, cf, field)
            pictures.append((r0, r1, dense, meta, k > 1 and k % 3 != 1))
        name = f"mc_{'field' if field else 'recon'}_blocks_group"
        kw = dict(chroma_format=cf, mbw=BLOCK_MBW)

        def kern(group):
            return mc_fused.fused_mc_recon_blocks_group(group, **kw)

        def plain(group):
            return mc_fused.fused_mc_recon_blocks_group_ref(group, **kw)

        def replaced(group):
            return [(mc_fused.fused_mc_recon_blocks(
                        a0[0], a1[0], d, m, bidir=b, **kw),
                     *mc_fused.fused_mc_recon_uv_blocks(
                         a0[1:], a1[1:], d, m, bidir=b, **kw))
                    for a0, a1, d, m, b in group]

        rec, errs = {}, []
        for size in (16, 1):
            group = pictures[:size]
            got, want = kern(group), plain(group)
            torch.cuda.synchronize()
            err = max(max_abs_err(torch, g, w) for gp, wp in zip(got, want)
                      for g, w in zip(gp, wp))
            if err or not all(torch.equal(g, w) for gp, wp in zip(got, want)
                              for g, w in zip(gp, wp)):
                fail(f"{name} {label} group of {size} differs from its "
                     f"plain version (max abs err {err})")
            errs.append(err)
            ms = cuda_ms(torch, lambda: kern(group))
            rep_ms = cuda_ms(torch, lambda: replaced(group))
            if size == 1:
                rec.update(one_ms=ms, one_replaced_ms=rep_ms)
                continue
            read = 0
            for a0, _, dense, meta, bidir in group:
                for uv in (False, True):
                    ref = a0[1] if uv else a0[0]
                    _, vecs, h, w = mc_fused.blocks_to_vectors(
                        ref, dense, meta, cf, BLOCK_MBW, uv=uv)
                    # a forward-only picture reads no backward window
                    mode = vecs[6] if bidir else vecs[6] & ~2
                    flat = [*vecs[:6], mode, *(vecs[7:] if field else ())]
                    read += mc_read_bytes(
                        torch, flat, *ref.shape, h, w,
                        n_planes=2 if uv else 1, field=field, recon=True,
                        meta_bytes=0 if uv else 2 * meta.numel())
            rec = {"ms": ms, "replaced_ms": rep_ms,
                   "plain_ms": cuda_ms(torch, lambda: plain(group), runs=3),
                   "pictures": size,
                   **bound((), [p for gp in got for p in gp],
                           OPS_PER_OUT["recon"], read)}
        rec["max_abs_err"] = max(errs)
        print(f"{name} {label}: groups of 16 and 1 equal to plain; 16 "
              f"pictures in one launch {rec['ms']:.4f} ms, in 32 one-picture "
              f"launches {rec['replaced_ms']:.4f} ms; one picture in one "
              f"launch {rec['one_ms']:.4f} ms, in two "
              f"{rec['one_replaced_ms']:.4f} ms; plain {rec['plain_ms']:.2f} "
              f"ms; bound {rec['bound_ms']:.5f} ms")
        out[name] = rec
    return out


def one_mb_times(torch, np, rng) -> dict:
    """K2 and K3 on a plane that holds one MB (16x16 luma; 8x8 U and V),
    coded and bidirectional, checked against the plain version like every
    form: device ms per call, bidir and forward-only.  The fixed cost of a
    launch of these kernels, which no design of them removes."""
    forms = (("mc_recon_luma", "K2 one MB", 16, False),
             ("mc_recon_uv", "K3 one MB", 8, True))
    out = {}
    for name, label, t, uv in forms:
        r = check_mc(torch, np, rng, label, t, t, t, t, uv=uv, mode_all=7)
        out[name] = {"ms": r["ms"], "fwd_ms": r["fwd_ms"]}
    return out


def uncoded_time(torch, np, rng) -> dict:
    """K2 on a 1088x1920 plane of uncoded MBs (mode 0 everywhere), checked
    like every form: the whole grid's launch, its mode loads and its 2 MB
    of zeros stored, no reference or residual read.  Device ms per call."""
    r = check_mc(torch, np, rng, "K2 all uncoded", 1088, 1920, 16, 16,
                 uv=False, mode_all=0)
    return {"mc_recon_luma": {"ms": r["ms"], "fwd_ms": r["fwd_ms"]}}


def mode7_times(torch, np, rng) -> dict:
    """K2, K7 (one component) and K8 (no MB field-predicted) on a 1088x1920
    luma plane with every MB at mode 7 (coded, both directions), checked
    like every form: device ms per call.  With modes drawn evenly
    (:func:`mc_inputs`) the recon kernels predict only coded MBs, 4 uses of
    a direction in 8 MBs, and the SWAR kernels, which ignore the coded bit,
    every MB with a direction bit, 8 in 8; at mode 7 all three predict the
    same windows, and K2 loads the residual on top."""
    forms = (("mc_recon_luma", "K2 all mode 7", "mxu", False),
             ("mc_swar", "K7 all mode 7", "swar", False),
             ("mc_swar_field", "K8 all mode 7", "swar", True))
    out = {}
    for name, label, impl, field in forms:
        r = check_mc(torch, np, rng, label, 1088, 1920, 16, 16, uv=False,
                     field=field, impl=impl, mode_all=7, field_share=0.0)
        out[name] = {"ms": r["ms"], "fwd_ms": r["fwd_ms"]}
    return out


# blocks of a 1080p luma grid of the segment kernels: 8160 MBs, 8 a block
K2_BLOCKS = 1020


def empty_times(torch, _build) -> dict:
    """Device ms per launch of a kernel that does nothing, in one block and
    in a 1080p K2 grid's blocks (256 threads each): the launch's share of
    the one-MB floor of :func:`one_mb_times`, the rest being the chain of
    dependent loads."""
    dev = torch.device("cuda")
    return {f"{n} blocks": cuda_ms(torch, lambda: _build.empty_kernel(dev, n))
            for n in (1, K2_BLOCKS)}


def window_bytes(torch, sy, sx, ph, H, W, word: int = 1) -> int:
    """Bytes of a padded plane that the MBs' 16x16 prediction windows
    need, read in units of ``word`` bytes (:func:`tap_bytes`), at the
    starts ``(sy, sx)`` clamped into the plane: the row and column a
    half-pel phase adds lie in the padding, which is in memory and counts.
    The union over all MBs: what this run's vectors need read, however
    wide the padding is."""
    sy = torch.clamp(sy.to(torch.int64), 0, H - 16)
    sx = torch.clamp(sx.to(torch.int64), 0, W - 16)
    return tap_bytes(torch, [(sy, sx, ph, 1, 16)], H + 1, W + word, 16, word)


def tap_bytes(torch, wins, H: int, W: int, w: int, word: int = 1) -> int:
    """Bytes of an (H, W) plane under the union of the taps of ``wins``,
    read in units of ``word`` bytes (a unit counts whole when any of its
    bytes is needed): each (row0, col0, ph, vs, n) holds per window its
    first tap row and column, its phase, the rows between its vertical
    taps and its tile rows; a window is rows ``row0 + vs * k`` for the
    ``n`` tile rows k, and one more under a vertical half-pel phase
    (``ph`` bit 1), by columns ``col0 ..`` for the ``w`` tile columns, one
    more under a horizontal one (bit 0).  Taps at a row >= H or a column
    >= W read the zero pad, which is not in memory, and count nothing."""
    nw = -(-W // word)
    need = torch.zeros((H + 1, nw + 1), dtype=torch.bool,
                       device=wins[0][0].device)
    for row0, col0, ph, vs, n in wins:
        if not row0.numel():
            continue
        ph = ph.to(torch.int64)[:, None]
        r = torch.arange(n + 1, device=row0.device)
        c = torch.arange(w + 1, device=row0.device)
        # an unneeded last tap repeats the first, which the union ignores
        rows = row0.to(torch.int64)[:, None] + vs * torch.where(
            r < n + ((ph >> 1) & 1), r, 0)
        cols = col0.to(torch.int64)[:, None] + torch.where(
            c < w + (ph & 1), c, 0)
        need[rows.clamp(max=H)[:, :, None],
             (cols.clamp(max=W) // word).clamp(max=nw)[:, None, :]] = True
    return int(need[:H, :nw].sum()) * word


def mc_read_bytes(torch, meta, H: int, W: int, th: int, tw: int,
                  n_planes: int, field: bool, recon: bool,
                  meta_bytes=None) -> int:
    """Input bytes a bidir call of an MC kernel needs at this run's
    inputs (:func:`mc_inputs`' ``meta`` for an (H, W) plane of (th x tw)
    MBs, ``n_planes`` planes sharing it): the mode vector; per direction,
    the vectors and the reference windows (:func:`tap_bytes`, per plane)
    of the MBs whose mode uses that direction — frame windows, or with
    ``field`` the two units' field windows of the MBs with mode bit 8; and
    with ``recon`` (K2–K6: residual, clip, coded mask) only of coded MBs
    (bit 4), whose residual is the rest.  An uncoded MB's output is 0
    whatever its inputs, and the SWAR kernels (not ``recon``) ignore the
    coded bit.  ``meta_bytes``: the bytes of what the kernel reads in
    place of the vectors (the blocks form's metadata rows), counted
    instead of the mode vector and the per-direction vectors."""
    mode = meta[6].to(torch.int64)
    fld = (mode & 8) != 0 if field else torch.zeros_like(mode, dtype=bool)
    coded = (mode & 4) != 0 if recon else torch.ones_like(fld)
    vector_bytes = 4 * mode.numel()
    nbytes = 0
    for d in range(2):
        use = coded & ((mode & (1 << d)) != 0)
        frame, by_field = use & ~fld, use & fld
        sy, sx, ph = meta[3 * d:3 * d + 3]
        wins = [(sy[frame], sx[frame], ph[frame], 1, th)]
        if field:
            tup = [x[by_field] for x in meta[7 + d]]
            # unit u's tile rows are u, u + 2, ...: frame rows C_u + u + 2k
            wins += [(tup[3 * u] + u, tup[3 * u + 1], tup[3 * u + 2], 2,
                      th // 2) for u in range(2)]
        vector_bytes += 4 * (3 * int(frame.sum()) + 6 * int(by_field.sum()))
        nbytes += n_planes * tap_bytes(torch, wins, H, W, tw)
    if recon:
        nbytes += n_planes * 2 * th * tw * int(coded.sum())
    return nbytes + (vector_bytes if meta_bytes is None else meta_bytes)


def check_rows(torch):
    """K9 and K10 against their plain versions on each case of
    ``profile_mc_variants.row_case`` at the MC profiler's 1080p inputs (its
    starts, edge starts, every ``sx & 3`` at every phase, each also on the
    tightest plane the kernels take) and on a 1088x1904 plane, whose 119
    MBs a row put the kernels' 8-MB blocks across MB rows and leave the
    last block 4 MBs.  The words of K10 are compared as words, its error
    read on the pixels.  Returns the two records, timed on the profiler's
    inputs."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_rows
    from tiny_mp2v_dec_tpu_torch.ops.mc_fused import unpack_words
    from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv
    x = pmv.make_inputs(device="cuda")
    cases = [(f"{s} starts{', tight plane' if tight else ''}",
              pmv.row_case(x, s, tight))
             for tight in (False, True) for s in pmv.ROW_STARTS] + [
        ("1088x1904 plane", pmv.make_inputs(W=1904, device="cuda"))]
    forms = {  # name: (kernel, wrapper, plain version, inputs, unpack)
        "mc_row": ("K9", mc_rows.mc_row_pred, mc_rows.mc_row_pred_ref,
                   ("plane_pad", "sy", "sx", "ph"), None),
        "mc_row_packed": ("K10", mc_rows.mc_row_pred_packed,
                          mc_rows.mc_row_pred_packed_ref,
                          ("plane32", "sy", "sxq", "rb", "ph"), unpack_words),
    }
    recs = {}
    for name, (k, fn, ref_fn, names, unpack) in forms.items():
        err, out = 0, None
        for label, v in cases:
            args = [getattr(v, a) for a in names]
            got = fn(*args, H=v.H, W=v.W)
            ref = ref_fn(*args, H=v.H, W=v.W)
            if out is None:     # the profiler's starts: the record's bound
                out = got
            torch.cuda.synchronize()
            e = max_abs_err(torch, *((unpack(got), unpack(ref)) if unpack
                                     else (got, ref)))
            if e or not torch.equal(got, ref):
                fail(f"{k} {name} on the {label} differs from its plain "
                     f"version (max abs err {e})")
            err = max(err, e)
        args = [getattr(x, a) for a in names]
        ms = cuda_ms(torch, lambda: fn(*args, H=x.H, W=x.W))
        plain_ms = cuda_ms(torch, lambda: ref_fn(*args, H=x.H, W=x.W))
        print(f"{k} {name}: {x.H}x{x.W} from a {tuple(args[0].shape)} "
              f"plane, equal to plain (and on {len(cases) - 1} more cases: "
              f"edges, every sx & 3 at every phase, the tight plane, "
              f"1088x1904); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        # the plane counts by the bytes the windows need, not its padding
        read = window_bytes(torch, x.sy, x.sx, x.ph, x.H, x.W,
                            1 if unpack is None else 4)
        recs[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      **bound(args[1:], (out,), OPS_PER_OUT[name], read)}
    return recs


def profiler_and_gates(torch, _build):
    """Phase 5: the MC profiler's parity run with the launch counts reset
    just before and read just after, then gates 1–3.  Returns the parity
    run's launches."""
    from tiny_mp2v_dec_tpu_torch.tools import perf_gate
    from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv
    x = pmv.make_inputs(device="cuda")
    _build.LAUNCHES.clear()
    parity = pmv.parity(x)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"profile_mc_variants parity vs variant a: {parity}; launches "
          f"{launches}")
    if not all(parity.values()):
        fail(f"MC profiler: a variant differs from variant a: {parity}")
    if launches != {"mc_row": 1, "mc_row_packed": 1}:
        fail(f"MC profiler: launches {launches}, expected one each of "
             f"mc_row and mc_row_packed")
    rec = perf_gate.run_gates()
    print(f"perf_gate: {json.dumps(rec)}")
    if not rec["pass"]:
        fail(f"perf_gate failed: {rec}")
    return launches


def host_kept_bytes(dec) -> int:
    """Host bytes a decoder keeps between decodes: the token arrays it
    keeps for reuse (``MP2VDecoder._spare_tokens``, where it has them) and
    its recons' staging blobs (one per blob shape in a decoder that
    uploads synchronously, up to ``GopRecon.N_SLOTS`` slots in one that
    pipelines)."""
    import numpy as np
    n = sum(a.nbytes for t in getattr(dec, "_spare_tokens", ())
            for a in vars(t).values() if isinstance(a, np.ndarray))
    for recon in dec._recons.values():
        for stage in recon._stage.values():
            blobs = ([s.blob for s in stage if s is not None]
                     if isinstance(stage, list) else [stage[0]])
            n += sum(b.nbytes for b in blobs)
    return n


def decode_path(torch, _build, MP2VDecoder, DecoderConfig, name, impl,
                expected, gop_chunk=16, pool=0, output_host=False,
                repeat=1, runs=None):
    """Decode one fixture (``repeat`` times over in one stream) under
    ``MP2V_MC_IMPL=impl`` through the decoder's entry point with the
    launch counts reset just before and read just after; check the hash
    (of each repeat), that every kernel of the path launched as often as
    ``expected`` says and that neither K1 alone nor an MC kernel of another
    implementation did; then time ``runs`` warm decodes (by default
    :data:`DECODE_RUNS`).  Returns (launches, frames/s, overlap: the
    median over the warm decodes of ``(tokenize_s + fill_s + device_s) /
    wall``)."""
    fixtures = _fixtures()
    try:
        data, want = fixtures.load(name)
    except ValueError as e:
        fail(str(e))
    data = fixtures.repeat_stream(data, repeat)
    os.environ["MP2V_MC_IMPL"] = impl
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk,
                                    output_host=output_host,
                                    pictures_pool_size=pool, device="cuda"))
    label = f"{name} [{impl}]"
    if gop_chunk != 16:
        label += (f" gop_chunk={gop_chunk} pool={pool} "
                  f"output_host={output_host}")
    if repeat > 1:
        label += f" x{repeat}"
    _build.LAUNCHES.clear()
    frames = dec.decode(data)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    digest, n_bytes = fixtures.yuv_sha256(frames)
    print(f"decode {label}: {len(frames)} frames, {n_bytes} YUV bytes, "
          f"sha256 {digest}; launches {launches}")
    try:
        fixtures.check_frames(frames, want, repeat)
    except ValueError as e:
        fail(f"{label}: {e}")
    for k, n in expected.items():
        if launches.get(k, 0) != n:
            fail(f"{label}: kernel {k} launched {launches.get(k, 0)} "
                 f"times, expected {n}")
    stray = {k: n for k, n in launches.items()
             if k in MC_KERNELS | {"idct8x8"} and k not in expected}
    if stray:
        fail(f"{label}: K1 alone or MC kernels of another implementation "
             f"launched: {stray}")
    runs = DECODE_RUNS[impl] if runs is None else runs
    walls, overlaps = [], []
    for _ in range(runs):
        dec.reset()
        t0 = time.perf_counter()
        frames = dec.decode(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        st = dec.stats
        overlaps.append((st["tokenize_s"] + st["fill_s"] + st["device_s"])
                        / walls[-1])
    wall = statistics.median(walls)
    fps = len(frames) / wall
    overlap = statistics.median(overlaps)
    print(f"decode {label} warm: median {wall:.4f} s over {runs} "
          f"runs = {fps:.2f} frames/s (best {min(walls):.4f} s); overlap "
          f"(tokenize + fill + device) / wall {overlap:.3f}; host memory "
          f"kept after the decode {host_kept_bytes(dec) / 2**20:.1f} MiB")
    return launches, fps, overlap


def natural_launches(impl: str, gop_chunk: int) -> dict:
    """The launches of a decode of the natural stream's 16 frame-predicted
    pictures: the transport once a chunk (a picture is a chunk at
    ``gop_chunk=0``; three launches), the MC kernels of ``impl``: under
    mxu once a group (:data:`MXU_GROUPS`), else once a picture."""
    if impl == "mxu":
        mc = {"mc_recon_blocks_group": MXU_GROUPS[gop_chunk]}
    else:
        mc = {k: 16 for k in {"roll": ("mc_roll_luma", "mc_roll_uv"),
                              "swar": ("mc_swar_yuv",)}[impl]}
    return {"transport": 3 * (16 // gop_chunk if gop_chunk else 16), **mc}


def entry_point(args: list, label: str) -> subprocess.CompletedProcess:
    """``python3 -m tiny_mp2v_dec_tpu_torch.<args>`` from this checkout,
    as a user runs it, under the default ``MP2V_MC_IMPL``; fails the run
    unless it exits 0."""
    proc = subprocess.run([sys.executable, "-m",
                           f"tiny_mp2v_dec_tpu_torch.{args[0]}", *args[1:]],
                          cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "MP2V_MC_IMPL": "mxu"},
                          timeout=ENTRY_TIMEOUT)
    if proc.returncode != 0:
        fail(f"{label} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc


def run_bench() -> dict:
    """Phase 6b: the bench, run short, on the 64-picture stream.  Checks
    that it exited 0, that its hash check passed with the launches of
    :data:`BENCH_LAUNCHES`, and that its last line holds the four keys
    with a value above 0; prints its ``#`` lines.  Returns its hash
    decode's launches."""
    proc = entry_point(["bench", "--repeats", "3", "--warmup", "1"], "bench")
    lines = [ln for ln in proc.stderr.splitlines() if ln.startswith("# ")]
    for ln in lines:
        print(f"bench {ln}")
    hashed = [ln for ln in lines if ln.startswith("# hash: ")]
    if len(hashed) != 1 or " is the JAX package's; launches " not in \
            hashed[0]:
        fail(f"bench: no passed hash check in {lines}")
    launches = json.loads(hashed[0].split("; launches ", 1)[1])
    if launches != BENCH_LAUNCHES:
        fail(f"bench: hash decode launched {launches}, expected "
             f"{BENCH_LAUNCHES}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"bench result: {json.dumps(last)}")
    if set(last) != {"metric", "value", "unit", "vs_baseline"} or not (
            last["value"] > 0):
        fail(f"bench: last line {last}")
    return launches


def run_cli(tmp: str) -> None:
    """Phase 6c: the CLI on the 16-picture 4:2:0 fixture at
    ``--gop-chunk`` 0 and 16, each output file's sha256 held to the
    fixture's recorded YUV hash."""
    name = "bench_1080p_420_16"
    _, want = _fixtures().load(name)
    for chunk in (0, 16):
        out = os.path.join(tmp, f"{name}_{chunk}.yuv")
        proc = entry_point(["cli", "-v", os.path.join(DATA, name + ".m2v"),
                            "-o", out, "--gop-chunk", str(chunk)],
                           f"cli --gop-chunk {chunk}")
        h = hashlib.sha256()
        with open(out, "rb") as f:
            for block in iter(lambda: f.read(1 << 22), b""):
                h.update(block)
        os.remove(out)
        print(f"cli --gop-chunk {chunk}: "
              f"{proc.stdout.strip().splitlines()[0]}; YUV sha256 "
              f"{h.hexdigest()}")
        if h.hexdigest() != want["yuv_sha256"]:
            fail(f"cli --gop-chunk {chunk}: YUV sha256 {h.hexdigest()} != "
                 f"JAX reference {want['yuv_sha256']}")


def _counted(torch, _build, label, expected, fn):
    """``fn()`` with the launch counts reset just before and read just
    after (a synchronize between); fails unless they are ``expected``
    exactly.  Returns ``(fn's result, launches)``."""
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"{label}: launches {json.dumps(launches, sort_keys=True)}")
    if launches != expected:
        fail(f"{label}: launches {launches}, expected {expected}")
    return out, launches


def _check_streams(label, outs, loaded) -> None:
    fixtures = _fixtures()
    for (name, want), frames in zip(loaded, outs):
        try:
            digest = fixtures.check_frames(frames, want)
        except ValueError as e:
            fail(f"{label}: {name}: {e}")
    print(f"{label}: {len(outs)} streams, each YUV sha256 the JAX "
          f"package's (last {digest})")


def _warm_fps(torch, label, dec, fn) -> float:
    """Frames/s of one more call of ``fn`` (a list of frame lists) from a
    reset decoder, ended by a synchronize; printed with its stage
    seconds."""
    dec.reset()
    t0 = time.perf_counter()
    outs = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(len(frames) for frames in outs)
    st = dec.stats
    print(f"{label} warm: {n} frames in {wall:.4f} s = {n / wall:.2f} "
          f"frames/s; tokenize {st['tokenize_s']:.4f} s (summed over "
          f"threads), device {st['device_s']:.4f} s")
    return n / wall


def batch_path(torch, _build, MP2VDecoder, DecoderConfig, names, impl,
               expected, label) -> tuple:
    """Phase 7 (a) and (b): ``decode_batch`` of the committed streams
    ``names`` under ``MP2V_MC_IMPL=impl`` on the card, launches counted
    (:func:`_counted`), every stream held to its hash; then one warm
    decode timed.  Returns (launches, frames/s)."""
    fixtures = _fixtures()
    loaded = []
    for name in names:
        try:
            data, want = fixtures.load(name)
        except ValueError as e:
            fail(str(e))
        loaded.append((name, data, want))
    os.environ["MP2V_MC_IMPL"] = impl
    dec = MP2VDecoder(DecoderConfig(output_host=False, device="cuda"))
    streams = [d for _, d, _ in loaded]
    label = f"decode_batch {label} [{impl}]"
    outs, launches = _counted(torch, _build, label, expected,
                              lambda: dec.decode_batch(streams))
    _check_streams(label, outs, [(n, w) for n, _, w in loaded])
    del outs
    return launches, _warm_fps(torch, label, dec,
                               lambda: dec.decode_batch(streams))


def _band_cut(meta, sl):
    """The per-MB vectors (field tuples included) of the MBs ``sl``."""
    return [tuple(v[sl] for v in m) if isinstance(m, tuple) else m[sl]
            for m in meta]


def _same(torch, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _rows(x, rows):
    return tuple(p[rows] for p in x) if isinstance(x, tuple) else x[rows]


def _hold_bands(torch, name, kern, plain, whole_rows, n_mb_row, per):
    """Each of :data:`ROW_BANDS` bands of ``per`` MB rows: ``kern(sl, k)``
    and ``plain(sl, k)`` on the band's MBs ``sl`` must be equal, and equal
    to ``whole_rows(k)``, the same rows of the whole-picture launch."""
    for k in range(ROW_BANDS):
        sl = slice(k * per * n_mb_row, (k + 1) * per * n_mb_row)
        got, want = kern(sl, k), plain(sl, k)
        torch.cuda.synchronize()
        if not _same(torch, got, want):
            fail(f"{name}: band {k} differs from its plain version")
        if not _same(torch, got, whole_rows(k)):
            fail(f"{name}: band {k} differs from the same rows of the "
                 f"whole-picture launch")


def check_bands(torch, np, rng) -> None:
    """Phase 7 (c)'s MC kernels at the row path's shapes: each of
    :data:`ROW_BANDS` bands of MB rows of a 1080-line picture gets the
    band's per-MB vectors (window starts in the whole reference), the
    whole reference planes and, for K2–K4's vector form, the band's
    residual rows, for K7 and K8 the band's output rows as ``H=``, for the
    blocks form, which the row path launches under mxu, the band's block
    grid and metadata rows and its first MB; its output must equal the
    plain version's on the same band and the same rows of the
    whole-picture launch, ``bidir`` True and False.  These launches are
    not counted in the path's launches."""
    from tiny_mp2v_dec_tpu_torch.ops import mc_fused
    for name, impl, uv, field, planes in BAND_MC:
        fn, ref_fn = mc_kernel(mc_fused, impl, uv, field)
        for label, (th, tw), H, W in planes:
            plane, resid, meta = mc_inputs(torch, np, rng, H, W, th, tw,
                                           field)
            refs = (((plane(), plane()), (plane(), plane())) if uv
                    else (plane(), plane()))
            res = ((resid(), resid()) if uv else resid()) \
                if impl != "swar" else None
            per = H // th // ROW_BANDS
            for bidir in (True, False):
                kw = dict(h=th, w=tw, bidir=bidir)
                if res is None:
                    whole = fn(*refs, *meta, **kw)

                    def args(sl, k):
                        return (*refs, *_band_cut(meta, sl)), {
                            **kw, "H": per * th}
                else:
                    whole = fn(*refs, res, *meta, **kw)

                    def args(sl, k):
                        rows = slice(k * per * th, (k + 1) * per * th)
                        return (*refs, _rows(res, rows),
                                *_band_cut(meta, sl)), kw

                def call(f):
                    def run(sl, k):
                        a, b = args(sl, k)
                        return f(*a, **b)
                    return run

                _hold_bands(
                    torch, f"{name} {label} bidir={bidir}", call(fn),
                    call(ref_fn),
                    lambda k: _rows(whole, slice(k * per * th,
                                                 (k + 1) * per * th)),
                    W // tw, per)
            print(f"{name} {label}: {ROW_BANDS} bands of {per} MB rows of "
                  f"{H}x{W}, bidir True and False: each equal to its plain "
                  f"version and to the rows of the whole-picture launch")
    per = BLOCK_MBH // ROW_BANDS
    for label, cf, field in BLOCK_PICTURES:
        r0, r1, dense, meta = blocks_inputs(torch, np, rng, cf, field)
        bpm = dense.shape[0] // meta.shape[0]
        for uv, fn, ref_fn in (
                (False, mc_fused.fused_mc_recon_blocks,
                 mc_fused.fused_mc_recon_blocks_ref),
                (True, mc_fused.fused_mc_recon_uv_blocks,
                 mc_fused.fused_mc_recon_uv_blocks_ref)):
            a0, a1 = (tuple(r0[1:]), tuple(r1[1:])) if uv else (r0[0], r1[0])
            for bidir in (True, False):
                kw = dict(chroma_format=cf, mbw=BLOCK_MBW, bidir=bidir)
                whole = fn(a0, a1, dense, meta, **kw)
                th = (whole[0] if uv else whole).shape[0] // BLOCK_MBH

                def call(f):
                    return lambda sl, k: f(
                        a0, a1, dense[sl.start * bpm:sl.stop * bpm],
                        meta[sl], **kw, mb0=sl.start)

                _hold_bands(
                    torch, f"blocks {'U+V' if uv else 'luma'} {label} "
                    f"bidir={bidir}", call(fn), call(ref_fn),
                    lambda k: _rows(whole, slice(k * per * th,
                                                 (k + 1) * per * th)),
                    BLOCK_MBW, per)
        print(f"blocks form {label}: {ROW_BANDS} bands of {per} MB rows, "
              f"luma and U+V, bidir True and False: each equal to its "
              f"plain version and to the rows of the whole-picture launch")
    for label, (th, tw), Hc, Wc in BAND_YUV:
        Hy, Wy = Hc * 16 // th, Wc * 16 // tw
        plane_y, _, meta_y = mc_inputs(torch, np, rng, Hy, Wy, 16, 16, False)
        plane_c, _, meta_c = mc_inputs(torch, np, rng, Hc, Wc, th, tw, False)
        mode = meta_y[6]
        ref0 = (plane_y(), plane_c(), plane_c())
        ref1 = (plane_y(), plane_c(), plane_c())
        per = Hy // 16 // ROW_BANDS
        for bidir in (True, False):
            kw = dict(h=th, w=tw, bidir=bidir)
            whole = mc_fused.fused_mc_pred_swar_yuv(ref0, ref1, meta_y[:6],
                                                    meta_c[:6], mode, **kw)

            def call(f):
                return lambda sl, k: f(
                    ref0, ref1, _band_cut(meta_y[:6], sl),
                    _band_cut(meta_c[:6], sl), mode[sl], **kw, H=per * 16)

            def whole_rows(k):
                return tuple(p[k * per * t:(k + 1) * per * t]
                             for p, t in zip(whole, (16, th, th)))

            _hold_bands(torch, f"K7 mc_swar_yuv {label} bidir={bidir}",
                        call(mc_fused.fused_mc_pred_swar_yuv),
                        call(mc_fused.fused_mc_pred_swar_yuv_ref),
                        whole_rows, Wy // 16, per)
        print(f"K7 mc_swar_yuv {label}: {ROW_BANDS} bands of {per} MB rows "
              f"of {Hy}x{Wy} + 2 x {Hc}x{Wc}, bidir True and False: each "
              f"equal to its plain version and to the rows of the "
              f"whole-picture launch")


def rows_path(torch, _build, MP2VDecoder, DecoderConfig, name, impl,
              expected) -> tuple:
    """Phase 7 (c): ``mesh="rows"`` in :data:`ROW_BANDS` bands on the
    card.  Returns (launches, frames/s)."""
    fixtures = _fixtures()
    data, want = fixtures.load(name)
    os.environ["MP2V_MC_IMPL"] = impl
    dec = MP2VDecoder(DecoderConfig(mesh="rows", mesh_devices=ROW_BANDS,
                                    output_host=False, device="cuda"))
    label = f"mesh=rows x{ROW_BANDS} {name} [{impl}]"
    frames, launches = _counted(torch, _build, label, expected,
                                lambda: dec.decode(data))
    _check_streams(label, [frames], [(name, want)])
    return launches, _warm_fps(torch, label, dec, lambda: [dec.decode(data)])


def serving_and_rows(torch, _build, MP2VDecoder, DecoderConfig) -> dict:
    """Phase 7: (a) the stream batch of :data:`BATCH_CASES`, (b) serving
    at width beside two independent decoders, (c) the row path's MC
    kernels on its bands (:func:`check_bands`), then the row mesh of
    :data:`ROWS`.  Returns the launches of the decodes."""
    from tiny_mp2v_dec_tpu_torch import bench
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    for impl, (names, expected) in BATCH_CASES.items():
        add(batch_path(torch, _build, MP2VDecoder, DecoderConfig, names,
                       impl, expected, f"{len(names)} streams")[0])
    t1 = time.perf_counter()
    counts, fps = batch_path(torch, _build, MP2VDecoder, DecoderConfig,
                             (SERVE,) * SERVE_COPIES, "mxu", SERVE_LAUNCHES,
                             f"{SERVE_COPIES}x {SERVE}")
    add(counts)
    os.environ["MP2V_MC_IMPL"] = "mxu"
    data, _ = _fixtures().load(SERVE)
    pair = bench.Bench("cuda").capacity(data)
    print(f"serving at width: {SERVE_COPIES} streams in one batch "
          f"{fps:.2f} frames/s; two independent decoders on two threads "
          f"(the bench's chip-capacity run, gop_chunk=16) on {SERVE} "
          f"{pair:.2f} frames/s")
    t2 = time.perf_counter()
    import numpy as np
    check_bands(torch, np, np.random.default_rng(2026))
    for (name, impl), expected in ROWS.items():
        add(rows_path(torch, _build, MP2VDecoder, DecoderConfig, name, impl,
                      expected)[0])
    t3 = time.perf_counter()
    print(f"serving and row phases: stream batch {t1 - t0:.1f} s, serving "
          f"at width {t2 - t1:.1f} s, rows {t3 - t2:.1f} s")
    return launches


def _hold_groups(label, frames, want) -> None:
    """Each :data:`REPEAT`-th of ``frames`` (YUV bytes) to the fixture's
    hash (a ``memoryview`` has the ``tobytes`` of a decoded frame)."""
    try:
        digest = _fixtures().check_frames([memoryview(b) for b in frames],
                                          want, REPEAT)
    except ValueError as e:
        fail(f"{label}: {e}")
    print(f"{label}: {len(frames)} frames, each of the {REPEAT} groups the "
          f"JAX package's YUV sha256; sha256 of all {digest}")


def _sample_threads(pids, stop, peaks) -> None:
    """The largest ``Threads:`` count of each process in ``pids`` (from
    ``/proc``) until ``stop`` is set."""
    while not stop.is_set():
        for pid in pids:
            try:
                with open(f"/proc/{pid}/status") as f:
                    for line in f:
                        if line.startswith("Threads:"):
                            peaks[pid] = max(peaks.get(pid, 0),
                                             int(line.split()[1]))
            except OSError:
                pass
        time.sleep(0.001)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _decode_only(payload) -> tuple:
    """Phase 8 (a)'s decode-only reading, run in a pool worker:
    ``hosts._worker_decode`` with the frames dropped there instead of sent
    back through the pool's pipe.  Returns (index, YUV bytes, launches,
    seconds in the worker)."""
    from tiny_mp2v_dec_tpu_torch.parallel import hosts
    t0 = time.perf_counter()
    idx, frames, launches = hosts._worker_decode(payload)
    return idx, sum(map(len, frames)), launches, time.perf_counter() - t0


def hosts_path(mh, name, n, expected) -> tuple:
    """Phase 8 (a): the fixture ``name`` :data:`REPEAT` times over as plain
    bytes through the pool ``mh`` of ``n`` workers: warmed, then a decode
    with the launch counts reset just before and read just after, held to
    the hashes and to ``expected``, then :data:`HOST_DECODES` - 1 more, all
    timed; then :data:`HOST_DECODES` decode-only runs of the same chunks
    (:func:`_decode_only`), timed, every byte count checked; the workers'
    peak thread counts sampled during the runs after the first; last, the
    seconds the pool takes to return one chunk's YUV bytes from a worker
    (``bytes(n)`` run there), best of 2.  Returns (launches, best seconds,
    best decode-only seconds)."""
    from tiny_mp2v_dec_tpu_torch.parallel.hosts import split_gops
    data, want = _fixtures().load(name)
    data = data * REPEAT
    label = f"MultiHostDecoder({n}) {os.path.basename(name)} x{REPEAT}"
    t0 = time.perf_counter()
    mh.warmup(data)
    t1 = time.perf_counter()
    mh.launches.clear()
    frames = mh.decode(data)
    walls = [time.perf_counter() - t1]
    launches = dict(mh.launches)
    print(f"{label}: warmup {t1 - t0:.2f} s; workers' launches "
          f"{json.dumps(launches, sort_keys=True)}")
    _hold_groups(label, frames, want)
    if launches != expected:
        fail(f"{label}: launches {launches}, expected {expected}")
    n_frames = len(frames)
    del frames
    payloads = [(c.index, c.data, mh.config_kwargs) for c in split_gops(data)]
    pids = [p.pid for p in multiprocessing.active_children()]
    peaks, stop = {}, threading.Event()
    sampler = threading.Thread(target=_sample_threads,
                               args=(pids, stop, peaks))
    sampler.start()
    only, in_worker = [], []
    try:
        for _ in range(HOST_DECODES - 1):
            t0 = time.perf_counter()
            mh.decode(data)
            walls.append(time.perf_counter() - t0)
        for _ in range(HOST_DECODES):
            t0 = time.perf_counter()
            res = list(mh._pool.map(_decode_only, payloads))
            only.append(time.perf_counter() - t0)
            in_worker.append(sum(r[3] for r in res))
            if sum(r[1] for r in res) != want["yuv_bytes"] * REPEAT:
                fail(f"{label}: decode-only runs gave "
                     f"{sum(r[1] for r in res)} YUV bytes")
    finally:
        stop.set()
        sampler.join()
    chunk_bytes = want["yuv_bytes"]
    back = min(_timed(lambda: mh._pool.submit(bytes, chunk_bytes).result())
               for _ in range(2))
    best, med = min(walls), statistics.median(walls)
    print(f"{label} warm: best {best:.4f} s = {n_frames / best:.2f} "
          f"frames/s, median {med:.4f} s = {n_frames / med:.2f} frames/s "
          f"over {HOST_DECODES} decodes; decode only (frames dropped in "
          f"the workers): best {min(only):.4f} s = "
          f"{n_frames / min(only):.2f} frames/s, the workers' decodes "
          f"summed {min(in_worker):.4f} s; peak threads per worker "
          f"{sorted(peaks.values())} on {os.cpu_count()} CPUs; the pool "
          f"returns one chunk's {chunk_bytes} bytes from a worker in "
          f"{back:.4f} s = {chunk_bytes / back / 1e6:.1f} MB/s")
    return launches, best, min(only)


def _rank_main(rank: int, world: int, port: int, name: str, device: str,
               q) -> None:
    """Phase 8 (b): one rank of a ``gloo`` world on ``device``: join it,
    build the ('host', 'chip') grid, decode this rank's chunks of the
    fixture ``name`` :data:`REPEAT` times over with ``DistributedDecoder``
    (``gop_chunk=16``) and put ``(rank, record)`` on ``q``: its grid shape,
    chunk indices, results, launches and seconds, or the error."""
    try:
        import torch
        import torch.distributed as dist
        from tiny_mp2v_dec_tpu_torch import DecoderConfig
        from tiny_mp2v_dec_tpu_torch.ops import _build
        from tiny_mp2v_dec_tpu_torch.parallel.distributed import (
            DistributedDecoder, host_chip_mesh, init_distributed)
        t0 = time.perf_counter()
        init_distributed(f"127.0.0.1:{port}", world, rank)
        shape = host_chip_mesh(device=device).shape
        data = _fixtures().load(name)[0] * REPEAT
        dd = DistributedDecoder(DecoderConfig(**HOST_CONFIG, device=device))
        _build.LAUNCHES.clear()
        t1 = time.perf_counter()
        results = dd.decode(data)
        if device == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        q.put((rank, {"shape": shape,
                      "indices": [c.index for c in dd.my_chunks(data)],
                      "results": results, "launches": dict(_build.LAUNCHES),
                      "setup_s": t1 - t0, "decode_s": t2 - t1}))
        dist.destroy_process_group()
    except Exception:  # the parent reports it and fails the run
        q.put((rank, {"error": traceback.format_exc()}))


def ranks_path(name: str, expected: dict, device: str = "cuda") -> dict:
    """Phase 8 (b): :data:`RANKS` spawned ranks (:func:`_rank_main`) on the
    fixture ``name``, each joined with a timeout.  Holds their merged
    frames to the fixture's hashes, their chunks to a disjoint cover of the
    stream, their grid to :data:`RANKS` hosts and their summed launches to
    ``expected``.  Returns the summed launches."""
    from tiny_mp2v_dec_tpu_torch.parallel.distributed import (
        merge_display_order)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, RANKS, port, name, device, q))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    recs = {}
    try:
        for _ in range(RANKS):
            try:
                rank, rec = q.get(timeout=RANK_TIMEOUT)
            except Exception:
                fail(f"DistributedDecoder: a rank sent nothing in "
                     f"{RANK_TIMEOUT} s (ranks in {sorted(recs)})")
            if "error" in rec:
                fail(f"DistributedDecoder rank {rank}: {rec['error']}")
            recs[rank] = rec
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        fail(f"DistributedDecoder: ranks exited {bad}")
    label = (f"DistributedDecoder {RANKS} ranks (gloo) "
             f"{os.path.basename(name)} x{REPEAT}")
    idxs = sorted(i for rec in recs.values() for i in rec["indices"])
    if idxs != list(range(REPEAT)) or any(
            [i for i, _ in rec["results"]] != rec["indices"]
            for rec in recs.values()):
        fail(f"{label}: chunks {[r['indices'] for r in recs.values()]}")
    if any(rec["shape"].get("host") != RANKS for rec in recs.values()):
        fail(f"{label}: grids {[r['shape'] for r in recs.values()]}")
    launches = {}
    for rec in recs.values():
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for rank, rec in sorted(recs.items()):
        print(f"{label} rank {rank}: grid {rec['shape']}, chunks "
              f"{rec['indices']}, join + grid + decoder "
              f"{rec['setup_s']:.2f} s, decode {rec['decode_s']:.2f} s "
              f"(first use), launches "
              f"{json.dumps(rec['launches'], sort_keys=True)}")
    _, want = _fixtures().load(name)
    _hold_groups(label, merge_display_order(
        [recs[r]["results"] for r in sorted(recs)]), want)
    if launches != expected:
        fail(f"{label}: summed launches {launches}, expected {expected}")
    return launches


def multihost_paths(card: str) -> dict:
    """Phase 8: (a) :data:`HOST_RUNS` through ``MultiHostDecoder`` with the
    efficiency ``T1 / (2 * T2)``, (b) :func:`ranks_path`, (c) the CLI with
    ``--hosts 2``.  Returns the workers' and ranks' launches."""
    from tiny_mp2v_dec_tpu_torch.parallel.hosts import MultiHostDecoder
    # the workers and ranks read it when their decoders are built
    os.environ["MP2V_MC_IMPL"] = "mxu"
    launches, best, only = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    for n in sorted({n for _, n in HOST_RUNS}):
        ts = time.perf_counter()
        with MultiHostDecoder(n, device="cuda",
                              config_kwargs=HOST_CONFIG) as mh:
            for name, _ in (r for r in HOST_RUNS if r[1] == n):
                counts, best[name, n], only[name, n] = hosts_path(
                    mh, name, n, MULTI_CHUNK[name])
                add(counts)
        print(f"MultiHostDecoder({n}): {time.perf_counter() - ts:.1f} s "
              f"from the pool's start to its close")
    for what, t in (("", best), (" decode only", only)):
        t1_s, t2_s = t[RANK_STREAM, 1], t[RANK_STREAM, 2]
        print(f"multi-host efficiency{what} T1 / (2 * T2) on {RANK_STREAM} "
              f"x{REPEAT}: {t1_s:.4f} / (2 * {t2_s:.4f}) = "
              f"{t1_s / (2 * t2_s):.3f} (best of {HOST_DECODES}); host "
              f"{os.cpu_count()} CPUs; {card}")

    t1 = time.perf_counter()
    add(ranks_path(RANK_STREAM, MULTI_CHUNK[RANK_STREAM]))
    t2 = time.perf_counter()
    name = RANK_STREAM
    _, want = _fixtures().load(name)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"{name}_hosts.yuv")
        proc = entry_point(["cli", "-v", os.path.join(DATA, name + ".m2v"),
                            "-o", out, "--hosts", "2"], "cli --hosts 2")
        with open(out, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    print(f"cli --hosts 2: {proc.stdout.strip().splitlines()[0]}; YUV "
          f"sha256 {digest}")
    if digest != want["yuv_sha256"]:
        fail(f"cli --hosts 2: YUV sha256 {digest} != JAX reference "
             f"{want['yuv_sha256']}")
    t3 = time.perf_counter()
    print(f"multi-host phases: MultiHostDecoder {t1 - t0:.1f} s, "
          f"DistributedDecoder {t2 - t1:.1f} s, CLI --hosts {t3 - t2:.1f} s")
    return launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    missing = [p for p in [PACKAGE] + [
        os.path.join(DATA, n + ".m2v")
        for n in {n for n, _ in PATHS} | set(BATCH) | {"bench_1080p_420_64"}]
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
        "transport": check_transport(torch),
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
        # K7: the picture form, which the path launches, with the
        # one-component form's record under "component"
        "mc_swar_yuv": {
            **check_tiles(torch, np, rng, "K7 mc_swar_yuv", CHROMA, "4:2:0",
                          check=check_swar_yuv),
            "component": check_tiles(torch, np, rng, "K7 mc_swar",
                                     LUMA + CHROMA, "luma", uv=False,
                                     impl="swar")},
        "mc_swar_field": check_tiles(torch, np, rng, "K8 mc_swar_field",
                                     LUMA + CHROMA, "luma", uv=False,
                                     field=True, impl="swar"),
        **check_rows(torch),
        **check_blocks(torch, np, rng),
        **check_blocks_group(torch, np, rng),
    }
    one_mb = one_mb_times(torch, np, rng)
    uncoded = uncoded_time(torch, np, rng)
    mode7 = mode7_times(torch, np, rng)
    empty = empty_times(torch, _build)

    # 4) end to end through the decoder's entry point, one path at a time
    launches = {}
    runs = [(name, impl, expected, {})
            for (name, impl), expected in PATHS.items()]
    runs += [(name, "mxu", expected,
              {"gop_chunk": 4, "pool": pool, "output_host": host})
             for name, expected in PIPELINED.items()
             for pool, host in DELIVERY]
    runs += [(name, "mxu", expected, {"repeat": REPEAT})
             for name, expected in MULTI_CHUNK.items()]
    print(f"host: {os.cpu_count()} CPUs; {card}")
    for name, impl, expected, opts in runs:
        counts, _, _ = decode_path(torch, _build, MP2VDecoder,
                                   DecoderConfig, name, impl, expected,
                                   **opts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # 5) the MC profiler (K9, K10) and the kernel gate
    launches.update(profiler_and_gates(torch, _build))

    # 6) the entry points: (a) natural content through every MC
    # implementation at three chunk sizes, (b) the bench, (c) the CLI
    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    for impl in ("mxu", "roll", "swar"):
        for chunk in NATURAL_CHUNKS:
            counts, _, _ = decode_path(
                torch, _build, MP2VDecoder, DecoderConfig, NATURAL, impl,
                natural_launches(impl, chunk), gop_chunk=chunk, runs=2)
            add(counts)
    t1 = time.perf_counter()
    add(run_bench())
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_cli(tmp)
    t3 = time.perf_counter()
    print(f"entry-point phases: natural content {t1 - t0:.1f} s, bench "
          f"{t2 - t1:.1f} s, CLI {t3 - t2:.1f} s")

    # 7) the serving and row-sharded paths
    add(serving_and_rows(torch, _build, MP2VDecoder, DecoderConfig))

    # 8) the multi-host paths: worker processes, ranks, the CLI
    add(multihost_paths(card))

    csrc = "tiny_mp2v_dec_tpu_torch/csrc/"
    mcp = "tiny_mp2v_dec_tpu/ops/mc_pallas.py"
    sources = {
        "idct8x8": ("idct.cu", "tiny_mp2v_dec_tpu/ops/idct.py:49"),
        "transport": ("transport.cu", "tiny_mp2v_dec_tpu/ops/recon.py:868"),
        "mc_recon_luma": ("mc_recon.cu", f"{mcp}:448"),
        "mc_recon_uv": ("mc_recon.cu", f"{mcp}:492"),
        "mc_field_luma": ("mc_recon.cu", f"{mcp}:353"),
        "mc_field_uv": ("mc_recon.cu", f"{mcp}:353"),
        "mc_roll_luma": ("mc_roll.cu", f"{mcp}:122"),
        "mc_roll_uv": ("mc_roll.cu", f"{mcp}:245"),
        "mc_swar_yuv": ("mc_swar.cu", f"{mcp}:769"),
        "mc_swar_field": ("mc_recon.cu", f"{mcp}:805"),
        "mc_row": ("mc_rows.cu", "tools/profile_mc_variants.py:88"),
        "mc_row_packed": ("mc_rows.cu", "tools/profile_mc_variants.py:206"),
        "mc_recon_blocks_luma": ("mc_recon.cu", f"{mcp}:448"),
        "mc_recon_blocks_uv": ("mc_recon.cu", f"{mcp}:492"),
        "mc_field_blocks_luma": ("mc_recon.cu", f"{mcp}:353"),
        "mc_field_blocks_uv": ("mc_recon.cu", f"{mcp}:353"),
        "mc_recon_blocks_group": ("mc_recon.cu", f"{mcp}:448"),
        "mc_field_blocks_group": ("mc_recon.cu", f"{mcp}:353"),
    }
    kernels = [{"name": name, "route": "cuda",
                "source": csrc + sources[name][0],
                "replaces": sources[name][1],
                "launches": launches.get(name, 0), **r}
               for name, r in rec.items()]
    print(json.dumps({"one_mb_ms": one_mb, "uncoded_ms": uncoded,
                      "mode7_ms": mode7, "empty_ms": empty, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
