"""Write the stream fixtures that the PyTorch port decodes on the GPU
(``chip_smoke.py``, ``python3 -m tiny_mp2v_dec_tpu_torch.bench``), with the
hashes they are held to.

The machine with the GPU has no JAX, so it can neither generate a stream
(the encoder imports the JAX package) nor decode a reference.  This tool
does both here, once, for these streams:

* ``tests/data/bench_1080p_420_N.m2v``: ``make_bench_stream(N)``, the
  stream ``bench.py`` times (1920x1088 4:2:0, frame prediction, random
  content), at N = 16, 64 (the 64 pictures ``bench.py`` times, the port's
  bench headline) and 8 (``bench.py``'s latency line); ``--pictures N``
  writes it at any N;
* ``tests/data/interlaced_1080_422_16.m2v``: interlaced content as 1080i
  broadcast and 4:2:2 production video code it — 1920x1088 4:2:2 frame
  pictures with field/frame-adaptive motion and DCT
  (``frame_pred_frame_dct=0``), I P B B …, every picture carrying all four
  quant matrices as ``make_bench_stream`` loads them, from seed 1729;
* ``tests/data/natural_576_420_16.m2v``: 16 pictures of natural content
  (``tests/natural_m2v.natural_stream``: a float DCT of synthesized
  moving pictures, quantized with the default matrices, block-matching
  motion search with half-pel candidates) at 720x576 4:2:0, the size of
  PAL SD broadcast, I B B P ..., seed 576;
* beside each, ``.json``: the stream's sha256 and the sha256, byte count
  and frame count of the YUV (display order, planes concatenated per
  frame) that the JAX package decodes from it on the CPU with
  ``gop_chunk=16``; for the interlaced stream also its counts of
  field-predicted and field-DCT macroblocks.

Run from the repository root:

    python tools/make_torch_fixture.py [NAME ...] [--pictures N ...]

with no argument it writes every fixture of :data:`FIXTURES` (about 2
minutes on a CPU).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "tools"),
           os.path.join(_REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

N_PICTURES = 16
# every reference hash is the JAX package's decode at this chunk size
GOP_CHUNK = 16
DATA_DIR = os.path.join(_REPO, "tests", "data")
STREAM_NAME = "bench_1080p_420_16.m2v"
META_NAME = "bench_1080p_420_16.json"
INTERLACED_STREAM_NAME = "interlaced_1080_422_16.m2v"
INTERLACED_META_NAME = "interlaced_1080_422_16.json"
# the natural stream: 45 x 36 MBs (720x576), its seed
NATURAL_MBS = (45, 36)
NATURAL_SEED = 576


def bench_name(n_pictures: int) -> str:
    return f"bench_1080p_420_{n_pictures}"


def make_stream(n_pictures: int = N_PICTURES) -> bytes:
    """The benchmark stream of ``n_pictures``, generated from its fixed
    seed."""
    from bench_stream import make_bench_stream
    with tempfile.TemporaryDirectory() as tmp:
        return make_bench_stream(n_pictures, tmp)


def make_natural_stream() -> bytes:
    """The SD natural-content stream, generated from its fixed seed (about
    12 s on a CPU: the motion search runs in numpy)."""
    from natural_m2v import natural_stream
    mbw, mbh = NATURAL_MBS
    return natural_stream(seed=NATURAL_SEED, mbw=mbw, mbh=mbh,
                          n_pics=N_PICTURES)


def _full_qmext(rng):
    """A quant-matrix extension loading all four matrices at random, drawn
    as ``tools/bench_stream.py`` draws them."""
    import numpy as np
    from tiny_mp2v_dec_tpu import headers as H

    def mat():
        return rng.integers(1, 256, 64).astype(np.uint8)
    return H.QuantMatrixExtension(
        load_intra_quantiser_matrix=1, intra_quantiser_matrix=mat(),
        load_non_intra_quantiser_matrix=1, non_intra_quantiser_matrix=mat(),
        load_chroma_intra_quantiser_matrix=1,
        chroma_intra_quantiser_matrix=mat(),
        load_chroma_non_intra_quantiser_matrix=1,
        chroma_non_intra_quantiser_matrix=mat())


def make_interlaced_stream(mbw: int = 120, mbh: int = 68) -> bytes:
    """The interlaced 4:2:2 stream, generated from its fixed seed."""
    import numpy as np
    from m2v_encoder import encode_stream, random_picture
    from tiny_mp2v_dec_tpu import headers as H
    rng = np.random.default_rng(1729)
    pcts = [H.PCT_I] + [H.PCT_P, H.PCT_B, H.PCT_B] * (N_PICTURES // 3)
    pics = []
    for i in range(N_PICTURES):
        p = random_picture(rng, mbw, mbh, H.CHROMA_422, pcts[i], fpfd=False,
                           allow_field_motion=True)
        p.temporal_reference = i
        p.qmext = _full_qmext(rng)
        pics.append(p)
    return encode_stream(mbw * 16, mbh * 16, H.CHROMA_422, pics)


def describe(data: bytes, field_counts: bool = False) -> dict:
    """Hashes of a stream and of the YUV the JAX package decodes from it;
    with ``field_counts``, also how many macroblocks are field-predicted
    and field-DCT coded."""
    from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
    frames = MP2VDecoder(DecoderConfig(gop_chunk=GOP_CHUNK)).decode(data)
    yuv = hashlib.sha256()
    n_bytes = 0
    for f in frames:
        b = f.tobytes()
        yuv.update(b)
        n_bytes += len(b)
    meta = {
        "stream_sha256": hashlib.sha256(data).hexdigest(),
        "stream_bytes": len(data),
        "yuv_sha256": yuv.hexdigest(),
        "yuv_bytes": n_bytes,
        "frames": len(frames),
        "decoded_by": "tiny_mp2v_dec_tpu MP2VDecoder(gop_chunk=16), JAX CPU",
    }
    if field_counts:
        toks = [t for t, _, _ in MP2VDecoder().tokenize_stream(data)]
        meta["macroblocks"] = sum(t.geom.n_mb for t in toks)
        meta["field_pred_mbs"] = sum(int(t.field_pred.sum()) for t in toks)
        meta["field_dct_mbs"] = sum(int(t.dct_type.sum()) for t in toks)
    return meta


# name -> (maker, whether the record counts field MBs)
FIXTURES = {
    bench_name(16): (make_stream, False),
    "interlaced_1080_422_16": (make_interlaced_stream, True),
    bench_name(64): (lambda: make_stream(64), False),
    bench_name(8): (lambda: make_stream(8), False),
    "natural_576_420_16": (make_natural_stream, False),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="NAME",
                    help=f"fixtures to write, of {', '.join(FIXTURES)} "
                         f"(default: all of them, unless --pictures is "
                         f"given)")
    ap.add_argument("--pictures", type=int, nargs="+", default=[],
                    metavar="N", help="write the bench stream of N "
                    "pictures, bench_1080p_420_N")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.names) - set(FIXTURES))
    if unknown:
        ap.error(f"no fixture named {', '.join(unknown)}")
    todo = {name: FIXTURES[name] for name in args.names}
    for n in args.pictures:
        todo[bench_name(n)] = (lambda n=n: make_stream(n), False)
    os.makedirs(DATA_DIR, exist_ok=True)
    for name, (make, counts) in (todo or FIXTURES).items():
        data = make()
        meta = describe(data, counts)
        with open(os.path.join(DATA_DIR, name + ".m2v"), "wb") as f:
            f.write(data)
        with open(os.path.join(DATA_DIR, name + ".json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.write("\n")
        print(json.dumps({"name": name, **meta}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
