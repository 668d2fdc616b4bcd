"""Seeded MPEG-2 elementary streams for the benchmark's configurations.

One generator for every configuration: the configuration's file gives the
geometry, chroma format, picture types, prediction options and sequence
header fields, and ``--seed`` gives the content.  Each picture draws from
its own generator, ``numpy.random.default_rng([seed, index])``, so the
pictures are made on several worker processes at once and the stream is
the same whatever their number.  The pictures are those of
``tools/bench_stream.py``'s ``make_bench_stream`` (random but valid
macroblocks through the frozen encoder, every picture loading all four
quant matrices) and, with ``frame_pred_frame_dct`` 0 and field motion
allowed, those of ``tools/make_torch_fixture.py``'s
``make_interlaced_stream``.

Imports numpy and the frozen encoder and reference headers only: the
workers import no torch.
"""
from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from ..ref import headers as H
from ..ref.utils.bits import BitWriter
from . import encoder as E

PICTURE_TYPES = {"I": H.PCT_I, "P": H.PCT_P, "B": H.PCT_B}
# the start codes a stream is cut at
GROUP_START = bytes((0, 0, 1, H.GROUP_START_CODE))
SEQUENCE_END = bytes((0, 0, 1, H.SEQUENCE_END_CODE))


def seed_words(seed: int) -> list:
    """``seed`` as the non-negative words ``numpy`` seeds from: any whole
    number, negative or past 64 bits, maps to one fixed list."""
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def picture_types(config: dict) -> list:
    """The coding type of each distinct picture in decode order: the
    configuration's ``first_picture``, then its ``cycle`` repeated."""
    n = config["distinct_pictures"]
    cycle = config["cycle"]
    kinds = config["first_picture"] + cycle * n
    return [PICTURE_TYPES[k] for k in kinds[:n]]


def _full_qmext(rng) -> H.QuantMatrixExtension:
    """A quant-matrix extension loading all four matrices at random, drawn
    as ``tools/bench_stream.py`` draws them."""
    def mat():
        return rng.integers(1, 256, 64).astype(np.uint8)
    return H.QuantMatrixExtension(
        load_intra_quantiser_matrix=1, intra_quantiser_matrix=mat(),
        load_non_intra_quantiser_matrix=1, non_intra_quantiser_matrix=mat(),
        load_chroma_intra_quantiser_matrix=1,
        chroma_intra_quantiser_matrix=mat(),
        load_chroma_non_intra_quantiser_matrix=1,
        chroma_non_intra_quantiser_matrix=mat())


def mb_size(config: dict) -> tuple:
    return (config["width"] + 15) // 16, (config["height"] + 15) // 16


def picture_bytes(config: dict, seed: int, index: int, pct: int) -> bytes:
    """Picture ``index`` of the stream: its header, coding extension, quant
    matrices and slices, byte-aligned."""
    rng = np.random.default_rng(seed_words(seed) + [index])
    mbw, mbh = mb_size(config)
    pic = E.random_picture(
        rng, mbw, mbh, config["chroma_format"], pct,
        f_code_max=config["f_code_max"],
        fpfd=bool(config["frame_pred_frame_dct"]),
        allow_field_motion=bool(config["allow_field_motion"]))
    pic.temporal_reference = index
    if config["quant_matrices_each_picture"]:
        pic.qmext = _full_qmext(rng)
    w = BitWriter()
    E.encode_picture(w, pic, mbw, config["chroma_format"], config["height"])
    w.align()
    return w.getvalue()


def sequence_start(config: dict) -> bytes:
    """The sequence header, its extension and the first GOP header."""
    w = BitWriter()
    H.SequenceHeader(
        horizontal_size_value=config["width"],
        vertical_size_value=config["height"],
        frame_rate_code=config["frame_rate_code"],
        bit_rate_value=config["bit_rate_value"]).write(w)
    H.SequenceExtension(
        chroma_format=config["chroma_format"],
        profile_and_level_indication=config[
            "profile_and_level_indication"]).write(w)
    H.GroupOfPicturesHeader().write(w)
    w.align()
    return w.getvalue()


def _picture_job(args) -> bytes:
    return picture_bytes(*args)


def worker_pool(workers: int, initializer=None,
                initargs=()) -> ProcessPoolExecutor:
    """Spawned worker processes (the caller's process may hold a CUDA
    context, which a forked child must not inherit)."""
    return ProcessPoolExecutor(max_workers=workers,
                               mp_context=get_context("spawn"),
                               initializer=initializer, initargs=initargs)


def make_stream(config: dict, seed: int, pool=None) -> bytes:
    """The configuration's stream of ``distinct_pictures`` pictures from
    ``seed``: sequence start, the pictures, the sequence end code.  With
    ``pool`` (:func:`worker_pool`) the pictures are made on its workers."""
    jobs = [(config, seed, i, pct)
            for i, pct in enumerate(picture_types(config))]
    pics = (pool.map(_picture_job, jobs) if pool is not None
            else map(_picture_job, jobs))
    return sequence_start(config) + b"".join(pics) + SEQUENCE_END


def repeat_stream(data: bytes, times: int) -> bytes:
    """``data`` ``times`` times over as one sequence, as
    ``tiny_mp2v_dec_tpu_torch/fixtures.py``'s ``repeat_stream`` makes it:
    every copy but the first starts at its GOP header, every copy but the
    last loses its end code.  Each picture loads its own quant matrices,
    so every copy decodes to ``data``'s frames."""
    if times == 1:
        return data
    gop = data.index(GROUP_START)
    end = len(data) - len(SEQUENCE_END)
    return data[:end] + data[gop:end] * (times - 2) + data[gop:]


def picture_units(data: bytes) -> list:
    """``data`` cut into one unit per picture, as a live source hands
    them over: the first unit carries the sequence and GOP headers, every
    unit runs to the next picture's start code, and the sequence end code
    is left out.  ``b"".join(units) + SEQUENCE_END == data``."""
    b = np.frombuffer(data, np.uint8)
    hits = np.nonzero((b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1)
                      & (b[3:] == H.PICTURE_START_CODE))[0]
    cuts = [0] + [int(h) for h in hits[1:]] + [len(data) - len(SEQUENCE_END)]
    return [data[a:b_] for a, b_ in zip(cuts[:-1], cuts[1:])]


def cycle_units(units: list) -> list:
    """The units of a source that runs the pictures again after the last:
    the first picture once more, from the GOP header on (no sequence
    header), then the others as they are."""
    first = units[0]
    return [first[first.index(GROUP_START):]] + units[1:]
