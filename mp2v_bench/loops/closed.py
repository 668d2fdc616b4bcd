"""The closed loop: whole decodes back to back, each a ``reset()`` and a
``decode`` of the stream (the configuration's pictures ``repeat`` times
over as one sequence) ended by a synchronize.  The window ends at the
synchronize of the decode that crosses its length.

The frames of a sample of the window's decodes (``sample_decodes``),
drawn from the seed, are kept for the comparison with the reference; the
others are dropped as a consumer would drop them.  One channel.
"""
from __future__ import annotations

import time

from .. import check
from ..drive import Reservoir, Runner, Window, add_stats
from ..streams import generate


class Loop(Runner):
    SAMPLED = "decodes"

    def prepare(self) -> None:
        self.config, data = self.one_channel()
        self.n_distinct = self.config["distinct_pictures"]
        self.data = generate.repeat_stream(data, self.traffic["repeat"])
        self.kept = Reservoir(self.traffic["sample_decodes"], self.seed)

    def warm_up(self) -> None:
        """``warmup`` whole decodes, each ended by a synchronize."""
        for _ in range(self.traffic["warmup"]):
            self.dec.reset()
            self.dec.decode(self.data)
            self.sync()

    def window(self, w: Window, seconds: float) -> None:
        per = self.traffic["repeat"] * self.n_distinct
        t0 = time.perf_counter()
        w.start_ns = time.time_ns()
        while True:
            a = time.time_ns()
            self.dec.reset()
            frames = self.dec.decode(self.data)
            b = time.time_ns()
            self.sync()
            c = time.time_ns()
            w.phases += [(a, b, "host: decode() call"),
                         (b, c, "host: synchronize after decode")]
            add_stats(w.stats, self.dec.stats)
            w.decode_s.append((c - a) / 1e9)
            self.kept.offer(frames)
            w.frames += len(frames)
            for i in range(per):
                w.decoded[0, i % self.n_distinct] += 1
            done = self._elapsed(t0) >= seconds
            self._trace_point(w, t0, done)
            if done:
                break
        w.seconds = self._elapsed(t0)

    def compare(self, refs: list, device) -> check.Comparison:
        """Each sampled decode is ``repeat`` times the reference's frames
        in display order."""
        ref, = refs
        per = self.traffic["repeat"] * len(ref.pcts)
        return check.closed_loop(self.kept.kept, ref.display(), per, device)
