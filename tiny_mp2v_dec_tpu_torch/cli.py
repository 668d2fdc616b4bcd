"""Command-line decoder of the port: the counterpart of the JAX package's
``tiny_mp2v_dec_tpu/cli.py`` (reference analog:
tiny_decoder/tiny_mp2v_dec.cpp).

Usage:
    python3 -m tiny_mp2v_dec_tpu_torch.cli -v in.m2v -o out.yuv
    python3 -m tiny_mp2v_dec_tpu_torch.cli -v in.m2v --bench 10

Writes planar YUV (cropped, no stride padding) frame by frame; prints
wall-clock decode time.  ``--bench N`` decodes the stream N times after the
first pass and reports frames/s, the window ended by a synchronize.  The
decode runs on the card (``--device cuda``, the default, which raises
without one); ``--device cpu`` runs the kernels' plain PyTorch versions.
``--mesh rows`` reconstructs each picture in bands of MB rows, one band
per visible device.  ``--golden`` decodes with the numpy golden model on
the host (``--device`` does not apply to it).  ``--hosts N`` distributes
closed GOPs over N worker processes, each decoding on ``--device``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from .runtime.decoder import DecoderConfig, MP2VDecoder


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tiny_mp2v_dec_tpu_torch",
                                 description="MPEG-2 decoder on an NVIDIA "
                                             "GPU (PyTorch + CUDA)")
    ap.add_argument("-v", "--video", required=True,
                    help="input .m2v elementary stream")
    ap.add_argument("-o", "--output", help="output planar YUV file")
    ap.add_argument("--no-reorder", action="store_true",
                    help="emit frames in decode order")
    ap.add_argument("--bench", type=int, default=0, metavar="N",
                    help="benchmark: decode N times after warm-up, print fps")
    ap.add_argument("--golden", action="store_true",
                    help="use the numpy golden decoder (on the host)")
    ap.add_argument("--size", metavar="WxH",
                    help="override coded size from the sequence header")
    ap.add_argument("--chroma", choices=["420", "422", "444"],
                    help="override chroma format from the sequence extension")
    ap.add_argument("--gop-chunk", type=int, default=0, metavar="N",
                    help="decode N pictures per chunk from one upload "
                         "(throughput mode; 0 = picture at a time)")
    ap.add_argument("--mesh", choices=["rows"],
                    help="shard each picture's MB rows across local "
                         "devices")
    ap.add_argument("--hosts", type=int, default=0, metavar="N",
                    help="distribute closed GOPs over N worker processes")
    ap.add_argument("--on-error", choices=["raise", "drop_slice"],
                    default="raise",
                    help="malformed-slice policy: abort (default) or "
                         "contain the damage to the bad slice and keep "
                         "decoding")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the reconstruction runs (default cuda; cpu "
                         "runs the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)

    with open(args.video, "rb") as f:
        data = f.read()

    w = h = 0
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
    chroma = {None: 0, "420": 1, "422": 2, "444": 3}[args.chroma]

    mh = None
    if args.hosts:
        from .parallel.hosts import MultiHostDecoder
        mh = MultiHostDecoder(args.hosts, device=args.device,
                              config_kwargs=dict(
                                  reordering=not args.no_reorder, width=w,
                                  height=h, chroma_format=chroma,
                                  gop_chunk=args.gop_chunk,
                                  on_error=args.on_error))

        class _F:  # minimal frame shim: MultiHostDecoder returns raw bytes
            def __init__(self, b):
                self._b = b

            def tobytes(self):
                return self._b

        decode = lambda: [_F(b) for b in mh.decode(data)]
    elif args.golden:
        from .golden.decoder import decode_stream
        decode = lambda: decode_stream(data, reordering=not args.no_reorder)
    else:
        dec = MP2VDecoder(DecoderConfig(
            reordering=not args.no_reorder, width=w, height=h,
            chroma_format=chroma, gop_chunk=args.gop_chunk, mesh=args.mesh,
            on_error=args.on_error, device=args.device))

        def decode():
            dec.reset()
            frames = dec.decode(data)
            if dec.device.type == "cuda":
                torch.cuda.synchronize()
            return frames

    try:
        return _run(args, decode)
    finally:
        if mh is not None:
            mh.close()


def _run(args, decode) -> int:
    """Time the first decode (and ``--bench`` more), then write the
    output file."""
    t0 = time.perf_counter()
    frames = decode()
    dt = time.perf_counter() - t0
    print(f"decoded {len(frames)} frames in {dt * 1e3:.1f} ms "
          f"({len(frames) / dt:.1f} fps incl. first-use compilation)")

    if args.bench:
        t0 = time.perf_counter()
        for _ in range(args.bench):
            frames = decode()
        dt = time.perf_counter() - t0
        total = len(frames) * args.bench
        print(f"bench: {total} frames in {dt:.3f} s = {total / dt:.1f} fps")

    if args.output:
        with open(args.output, "wb") as f:
            for fr in frames:
                f.write(fr.tobytes())
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
