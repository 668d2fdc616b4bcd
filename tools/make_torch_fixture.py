"""Write the 16-picture 1080p 4:2:0 stream fixture that the PyTorch port
decodes on the GPU (``chip_smoke.py``), with the hashes it is held to.

The machine with the GPU has no JAX, so it can neither generate the stream
(``tools/bench_stream.py`` imports the JAX package) nor decode a reference.
This tool does both here, once:

* ``tests/data/bench_1080p_420_16.m2v``: ``make_bench_stream(16)``, the
  stream ``bench.py`` times;
* ``tests/data/bench_1080p_420_16.json``: the stream's sha256 and the
  sha256, byte count and frame count of the YUV (display order, planes
  concatenated per frame) that the JAX package decodes from it on the CPU
  with ``gop_chunk=16``.

Run from the repository root:  ``python tools/make_torch_fixture.py``
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

N_PICTURES = 16
DATA_DIR = os.path.join(_REPO, "tests", "data")
STREAM_NAME = "bench_1080p_420_16.m2v"
META_NAME = "bench_1080p_420_16.json"


def make_stream() -> bytes:
    """The benchmark stream, generated from its fixed seed."""
    from bench_stream import make_bench_stream
    with tempfile.TemporaryDirectory() as tmp:
        return make_bench_stream(N_PICTURES, tmp)


def describe(data: bytes) -> dict:
    """Hashes of a stream and of the YUV the JAX package decodes from it."""
    from tiny_mp2v_dec_tpu import DecoderConfig, MP2VDecoder
    frames = MP2VDecoder(DecoderConfig(gop_chunk=N_PICTURES)).decode(data)
    yuv = hashlib.sha256()
    n_bytes = 0
    for f in frames:
        b = f.tobytes()
        yuv.update(b)
        n_bytes += len(b)
    return {
        "stream_sha256": hashlib.sha256(data).hexdigest(),
        "stream_bytes": len(data),
        "yuv_sha256": yuv.hexdigest(),
        "yuv_bytes": n_bytes,
        "frames": len(frames),
        "decoded_by": "tiny_mp2v_dec_tpu MP2VDecoder(gop_chunk=16), JAX CPU",
    }


def main() -> int:
    data = make_stream()
    meta = describe(data)
    os.makedirs(DATA_DIR, exist_ok=True)
    with open(os.path.join(DATA_DIR, STREAM_NAME), "wb") as f:
        f.write(data)
    with open(os.path.join(DATA_DIR, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
