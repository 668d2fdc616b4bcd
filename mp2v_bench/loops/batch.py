"""The batch loop: the serving path, every channel in one call.  Each
call is a ``reset()`` and a ``decode_batch`` of every channel's stream
(its configuration's pictures ``repeat`` times over as one sequence, as
``loops/closed.py`` repeats its one stream), ended by a synchronize.  The
window ends at the synchronize of the call that crosses its length.

The frames of a sample of the window's calls (``sample_decodes``), drawn
from the seed, are kept for the comparison with each channel's reference;
the others are dropped as a consumer would drop them.  ``decode_batch``
delivers each frame as its padded ``(y, u, v)`` device planes; the
comparison crops and packs them on the device into one buffer a frame,
the layout of the reference's rows.
"""
from __future__ import annotations

import time

from .. import check
from ..drive import Reservoir, Runner, Window, add_stats
from ..ref.tokenizer.types import CHROMA_INFO
from ..streams import generate


class Cropped:
    """A frame's padded device planes cropped to the picture and packed
    into one buffer: Y, then U, then V, each row by row."""

    def __init__(self, frame, config: dict):
        self.frame = frame
        self.config = config

    def device_buffer(self):
        import torch
        w, h = self.config["width"], self.config["height"]
        xs, ys, _ = CHROMA_INFO[self.config["chroma_format"]]
        cw = (w + (1 << xs) - 1) >> xs
        ch = (h + (1 << ys) - 1) >> ys
        y, u, v = self.frame.device_buffer()
        return torch.cat([y[:h, :w].reshape(-1), u[:ch, :cw].reshape(-1),
                          v[:ch, :cw].reshape(-1)])


class Loop(Runner):
    SAMPLED = "decode_batch calls"

    def prepare(self) -> None:
        self.n_distinct = [c["distinct_pictures"] for c in self.configs]
        self.data = [generate.repeat_stream(d, self.traffic["repeat"])
                     for d in self.streams]
        self.kept = Reservoir(self.traffic["sample_decodes"], self.seed)

    def warm_up(self) -> None:
        """``warmup`` whole calls, each ended by a synchronize."""
        for _ in range(self.traffic["warmup"]):
            self.dec.reset()
            self.dec.decode_batch(self.data)
            self.sync()

    def window(self, w: Window, seconds: float) -> None:
        repeat = self.traffic["repeat"]
        t0 = time.perf_counter()
        w.start_ns = time.time_ns()
        while True:
            a = time.time_ns()
            self.dec.reset()
            out = self.dec.decode_batch(self.data)
            b = time.time_ns()
            self.sync()
            c = time.time_ns()
            w.phases += [(a, b, "host: decode_batch() call"),
                         (b, c, "host: synchronize after decode_batch")]
            add_stats(w.stats, self.dec.stats)
            w.decode_s.append((c - a) / 1e9)
            self.kept.offer(out)
            w.frames += sum(map(len, out))
            for ch, n in enumerate(self.n_distinct):
                for i in range(repeat * n):
                    w.decoded[ch, i % n] += 1
            done = self._elapsed(t0) >= seconds
            self._trace_point(w, t0, done)
            if done:
                break
        w.seconds = self._elapsed(t0)

    def compare(self, refs: list, device) -> check.Comparison:
        """Channel ``c`` of each sampled call is ``repeat`` times channel
        ``c``'s reference frames in display order."""
        import torch
        comp = check.Comparison(*(torch.from_numpy(r.display()).to(device)
                                  for r in refs))
        repeat = self.traffic["repeat"]
        for _, out in sorted(self.kept.kept.items()):
            for c, (frames, config, ref) in enumerate(
                    zip(out, self.configs, refs)):
                n = len(ref.pcts)
                comp.frames_against([Cropped(f, config) for f in frames],
                                    [j % n for j in range(repeat * n)], c)
        return comp
