"""The plain reference: the frozen golden model (``ref/``) decoding a
stream on several worker processes.

Each stream is walked as the golden decoder walks it
(``GoldenDecoder.decode``); each picture's slices are tokenized by the
frozen Python tokenizer on the workers at once, then the pictures are
reconstructed by the frozen numpy reconstruction, each I or P picture as
soon as its reference is, the B pictures beside them.  Several streams (a
configuration's channels) share one pool of workers.  The arithmetic is
the golden model's alone; only the order in which independent pictures
run differs.  Imports numpy and ``ref/`` only, never the port: the workers
import no torch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ref import headers as H
from .ref.golden import recon as golden_recon
from .ref.golden.decoder import GoldenDecoder, crop_frame
from .ref.tokenizer.python_tok import tokenize_slice
from .ref.tokenizer.types import PictureTokens
from .streams.generate import worker_pool

# the streams the workers tokenize (set by _init in each worker)
_DATA = []


def _init(streams: list, idct=None) -> None:
    global _DATA
    _DATA = streams
    if idct is not None:
        # the control's reconstruction (control.py): another IDCT
        golden_recon.idct_blocks = idct


class _Pictures(GoldenDecoder):
    """Walks a stream as the golden decoder does and keeps, for each
    picture, what tokenizing it needs, in decode order."""

    def __init__(self):
        super().__init__(reordering=False)
        self.jobs = []

    def _decode_picture(self, data: bytes, cur) -> None:
        geom, params = self.picture_params(cur)
        self.jobs.append((geom, params, cur["header"], list(cur["slices"])))


def _tokenize(args) -> PictureTokens:
    channel, (geom, params, _, slices) = args
    tokens = PictureTokens.empty(geom)
    for bit_pos, code in slices:
        tokenize_slice(_DATA[channel], bit_pos, code, params, geom, tokens)
    # only the coded rows travel back
    k = tokens.n_coded_blocks
    tokens.cblk = tokens.cblk[:k].copy()
    tokens.cblk_idx = tokens.cblk_idx[:k].copy()
    return tokens


def _reconstruct(args):
    tokens, ref0, ref1 = args
    return golden_recon.reconstruct_picture(tokens, ref0=ref0, ref1=ref1)


@dataclass
class Reference:
    """A stream's golden decode: ``frames`` ``(n, frame bytes)`` uint8 in
    decode order (each frame's Y, U and V planes, cropped, one after
    another, as the port's ``LazyFrame.tobytes`` gives them), each
    picture's coding type and tokens."""
    frames: np.ndarray
    pcts: list
    tokens: list

    def display(self) -> np.ndarray:
        """The frames in display order (:func:`display_order`)."""
        return self.frames[display_order(self.pcts)]


def display_order(pcts) -> list:
    """Decode indices in display order: an I or P picture waits until the
    next I or P picture, a B picture goes out at once (the golden
    decoder's reordering)."""
    out, slot = [], None
    for i, pct in enumerate(pcts):
        if pct in (H.PCT_I, H.PCT_P):
            if slot is not None:
                out.append(slot)
            slot = i
        else:
            out.append(i)
    if slot is not None:
        out.append(slot)
    return out


def decode(data: bytes, workers: int, idct=None) -> Reference:
    """The golden decode of ``data`` on ``workers`` processes;
    ``idct``, a picklable replacement for the golden IDCT, makes the
    control's decode instead."""
    return decode_all([data], workers, idct)[0]


def decode_all(streams: list, workers: int, idct=None) -> list:
    """The golden decode of each of ``streams`` (:func:`decode`), all on
    one pool of ``workers`` processes."""
    jobs = []
    for data in streams:
        walker = _Pictures()
        walker.decode(data)
        jobs.append(walker.jobs)
    with worker_pool(workers, _init, (streams, idct)) as pool:
        futures = [[pool.submit(_tokenize, (c, job)) for job in js]
                   for c, js in enumerate(jobs)]
        tokens = [[f.result() for f in fs] for fs in futures]
        # each channel's pictures in decode order, the channels in turn:
        # a picture waits for its own channel's references only
        refs = [[None, None] for _ in streams]   # futures of the planes
        futures = [[] for _ in streams]
        for i in range(max(map(len, jobs), default=0)):
            for c, js in enumerate(jobs):
                if i >= len(js):
                    continue
                tok, ph = tokens[c][i], js[i][2]
                r = refs[c]
                if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
                    r0 = r[1].result() if r[1] is not None else None
                    fut = pool.submit(_reconstruct, (tok, r0, None))
                    refs[c] = [r[1], fut]
                else:
                    fut = pool.submit(_reconstruct, (
                        tok, *(f.result() if f is not None else None
                               for f in r)))
                futures[c].append(fut)
        frames = [[crop_frame(f.result(), job[0], job[2]).tobytes()
                   for f, job in zip(fs, js)]
                  for fs, js in zip(futures, jobs)]
    return [Reference(
        frames=np.stack([np.frombuffer(f, np.uint8) for f in fr]),
        pcts=[job[2].picture_coding_type for job in js],
        tokens=tok)
        for fr, js, tok in zip(frames, jobs, tokens)]
