"""The open loop: one picture a ``decode`` call, fed at its due time
``t0 + i / frame rate`` (the configuration's), the pictures cycling; the
decoder's renderer synchronizes each frame as it is delivered.  Every
picture due in the window is waited for.

The frames of a sample of the window's pictures (``sample_pictures``),
drawn from the seed, are kept for the comparison with the reference; the
others are dropped as a consumer would drop them.  One channel.
"""
from __future__ import annotations

import time

from .. import check
from ..drive import Reservoir, Runner, Window, stats_since
from ..streams import generate

# the feeder spins through the last this many seconds before a picture
# is due
SPIN_S = 0.002


class Loop(Runner):
    SAMPLED = "pictures"

    def prepare(self) -> None:
        self.config, data = self.one_channel()
        self.n_distinct = self.config["distinct_pictures"]
        self.units = generate.picture_units(data)
        self.cycle = generate.cycle_units(self.units)
        self.fed = 0
        # of each picture offered: (its decode index, its frames)
        self.kept = Reservoir(self.traffic["sample_pictures"], self.seed)
        self.dec.renderer = self._rendered

    def warm_up(self) -> None:
        """``warmup`` cycles of the pictures fed back to back, each ended
        by a synchronize."""
        for _ in range(self.traffic["warmup"]):
            for _ in range(self.n_distinct):
                self._feed()
            self.sync()

    def _feed(self) -> list:
        """Hand the decoder the next picture's unit; returns its frames."""
        units = self.units if self.fed < self.n_distinct else self.cycle
        frames = self.dec.decode(units[self.fed % self.n_distinct])
        self.fed += 1
        return frames

    def _rendered(self, frame) -> None:
        self.sync()

    def window(self, w: Window, seconds: float) -> None:
        num, den = self.config["frame_rate"]
        period = den / num
        due_n = int(seconds / period) + 1
        before = dict(self.dec.stats)
        t0 = time.perf_counter()
        w.start_ns = time.time_ns()
        for i in range(due_n):
            # a pause (the profiler's stop) moves the schedule with it
            due = t0 + self._paused + i * period
            wait = due - time.perf_counter()
            if wait > 0:
                a = time.time_ns()
                # sleep to within SPIN_S of the due time, then spin: a
                # sleep alone wakes up late by a share of a millisecond
                if wait > SPIN_S:
                    time.sleep(wait - SPIN_S)
                while time.perf_counter() < due:
                    pass
                w.phases.append((a, time.time_ns(),
                                 "host: waiting for the next picture"))
            fed = time.perf_counter()
            fed_ns = time.time_ns()
            index = self.fed % self.n_distinct
            # the renderer synchronizes the frame before decode returns
            frames = self._feed()
            done = time.perf_counter()
            w.phases.append((fed_ns, time.time_ns(),
                             "host: decode() call of one picture"))
            w.feed_late_s.append(fed - due)
            w.latencies_s.append(done - due)
            self.kept.offer((index, frames))
            w.frames += len(frames)
            w.decoded[0, index] += 1
            self._trace_point(w, t0, i == due_n - 1)
        w.seconds = self._elapsed(t0)
        w.stats = stats_since(before, self.dec.stats)

    def compare(self, refs: list, device) -> check.Comparison:
        """Each sampled picture is the reference's picture of its decode
        index."""
        ref, = refs
        return check.open_loop(self.kept.kept, ref.frames, device)
