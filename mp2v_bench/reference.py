"""The plain reference: the frozen golden model (``ref/``) decoding a
stream on several worker processes.

The stream is walked as the golden decoder walks it
(``GoldenDecoder.decode``); each picture's slices are tokenized by the
frozen Python tokenizer on the workers at once, then the pictures are
reconstructed by the frozen numpy reconstruction, each I or P picture as
soon as its reference is, the B pictures beside them.  The arithmetic is the
golden model's alone; only the order in which independent pictures run
differs.  Imports numpy and ``ref/`` only, never the port: the workers
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

# the stream the workers tokenize (set by _init in each worker)
_DATA = b""


def _init(data: bytes, idct=None) -> None:
    global _DATA
    _DATA = data
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


def _tokenize(job) -> PictureTokens:
    geom, params, _, slices = job
    tokens = PictureTokens.empty(geom)
    for bit_pos, code in slices:
        tokenize_slice(_DATA, bit_pos, code, params, geom, tokens)
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
    walker = _Pictures()
    walker.decode(data)
    jobs = walker.jobs
    with worker_pool(workers, _init, (data, idct)) as pool:
        tokens = list(pool.map(_tokenize, jobs))
        refs = [None, None]       # futures of the reference planes
        futures = []
        for tok, (_, _, ph, _) in zip(tokens, jobs):
            if ph.picture_coding_type in (H.PCT_I, H.PCT_P):
                r0 = refs[1].result() if refs[1] is not None else None
                fut = pool.submit(_reconstruct, (tok, r0, None))
                refs = [refs[1], fut]
            else:
                fut = pool.submit(_reconstruct, (
                    tok, *(r.result() if r is not None else None
                           for r in refs)))
            futures.append(fut)
        frames = [crop_frame(f.result(), job[0], job[2]).tobytes()
                  for f, job in zip(futures, jobs)]
    return Reference(
        frames=np.stack([np.frombuffer(f, np.uint8) for f in frames]),
        pcts=[job[2].picture_coding_type for job in jobs],
        tokens=tokens)
