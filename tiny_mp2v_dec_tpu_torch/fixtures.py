"""The committed stream fixtures and the hashes they are held to.

A machine with the GPU has no JAX, so it can neither make a test stream
(the encoder imports the JAX package) nor decode a reference.  The streams
it decodes are committed under ``tests/data/``: each ``NAME.m2v`` with a
``NAME.json`` beside it, both written by ``tools/make_torch_fixture.py``,
holding the stream's sha256 and the sha256, byte count and frame count of
the YUV that the JAX package decodes from it (display order, each frame's
planes concatenated, as ``LazyFrame.tobytes`` gives them).

Standard library only: ``chip_smoke.py`` loads this file by path, also
beside checkouts of the port that lack it.
"""
from __future__ import annotations

import hashlib
import json
import os

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "data")
# the start codes repeat_stream cuts at: the first GOP header, and the
# sequence end code, which closes a stream (the decoders stop there)
GROUP_START = b"\x00\x00\x01\xb8"
SEQUENCE_END = b"\x00\x00\x01\xb7"


def stream_path(name: str) -> str:
    """The ``.m2v`` of a committed fixture by its name
    (``bench_1080p_420_64``), or ``name`` itself when it is a path to a
    ``.m2v`` (its record is the ``.json`` beside it)."""
    if name.endswith(".m2v"):
        return name
    return os.path.join(DATA, name + ".m2v")


def load(name: str) -> tuple:
    """``(stream bytes, record)`` of a fixture (:func:`stream_path`).
    Raises ``ValueError`` when the stream's sha256 is not the recorded
    one."""
    path = stream_path(name)
    with open(path, "rb") as f:
        data = f.read()
    with open(path[:-len(".m2v")] + ".json") as f:
        meta = json.load(f)
    got = hashlib.sha256(data).hexdigest()
    if got != meta["stream_sha256"]:
        raise ValueError(f"{path}: stream sha256 {got} is not the recorded "
                         f"{meta['stream_sha256']}")
    return data, meta


def repeat_stream(data: bytes, times: int) -> bytes:
    """``data``, one sequence (its header, then GOPs, then the sequence end
    code), ``times`` times over as one sequence: every copy but the first
    starts at its first GOP header, and every copy but the last loses its
    end code.  Where each picture carries its own quant matrix extension,
    as in the 1080-line fixtures, it decodes to ``data``'s frames ``times``
    times over.  A later copy keeps no sequence header because the
    decoders (the JAX package's, its golden model and the port) decode the
    picture before a sequence header with that header's state, its
    downloaded matrices reset (ROADMAP Queue 3)."""
    gop = data.find(GROUP_START)
    if not data.endswith(SEQUENCE_END) or gop < 0:
        raise ValueError("the stream does not end with a sequence end code "
                         "or has no GOP header")
    if times == 1:
        return data
    end = len(data) - len(SEQUENCE_END)
    return data[:end] + data[gop:end] * (times - 2) + data[gop:]


def yuv_sha256(frames) -> tuple:
    """``(sha256 hex digest, byte count)`` of ``frames``' YUV, in order."""
    h = hashlib.sha256()
    n = 0
    for f in frames:
        b = f.tobytes()
        h.update(b)
        n += len(b)
    return h.hexdigest(), n


def check_frames(frames, meta: dict, times: int = 1) -> str:
    """Hold ``frames``, the decode of a fixture ``times`` times over
    (:func:`repeat_stream`), to its record: the frame and byte counts, and
    each copy's YUV sha256.  Returns the digest of all the frames; raises
    ``ValueError`` on a mismatch."""
    digest, n_bytes = yuv_sha256(frames)
    per = meta["frames"]
    if len(frames) != per * times or n_bytes != meta["yuv_bytes"] * times:
        raise ValueError(f"decoded {len(frames)} frames / {n_bytes} bytes, "
                         f"expected {per * times} / "
                         f"{meta['yuv_bytes'] * times}")
    groups = ([yuv_sha256(frames[i * per:(i + 1) * per])[0]
               for i in range(times)] if times > 1 else [digest])
    if any(g != meta["yuv_sha256"] for g in groups):
        raise ValueError(f"YUV sha256 {groups} is not the JAX package's "
                         f"{meta['yuv_sha256']}")
    return digest
