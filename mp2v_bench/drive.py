"""The one traffic runner: it builds the port's decoder from a traffic
mix's parameters (``traffic/<name>.json``), warms it up, and drives the
measured window, in a closed or an open loop.

* ``"loop": "closed"``: whole decodes back to back, each a ``reset()`` and
  a ``decode`` of the stream (the configuration's pictures ``repeat``
  times over as one sequence) ended by a synchronize.  The window ends at
  the synchronize of the decode that crosses its length.
* ``"loop": "open"``: one picture a ``decode`` call, fed at its due time
  ``t0 + i / frame rate`` (the configuration's), the pictures cycling; the
  decoder's renderer synchronizes each frame as it is delivered.  Every
  picture due in the window is waited for.

The frames of a sample of the window's decodes (closed loop) or pictures
(open loop), drawn from the seed (:class:`Reservoir`), are kept for the
comparison with the reference (``check.py``); the others are dropped as a
consumer would drop them.
"""
from __future__ import annotations

import os
import random
import time
from collections import Counter
from dataclasses import dataclass, field

from .streams import generate

# the decoder's host-time counters (MP2VDecoder.stats) the window sums
STATS = ("pictures", "tokenize_s", "fill_s", "device_s", "output_s")
# the open loop's feeder spins through the last this many seconds before a
# picture is due
SPIN_S = 0.002


@dataclass
class Window:
    """What one measured window did, for the metric readers."""
    frames: int = 0                 # frames delivered in the window
    seconds: float = 0.0            # its length on the host clock
    start_ns: int = 0               # its start on the wall clock (time_ns)
    stats: dict = field(default_factory=dict)   # sums of STATS
    latencies_s: list = field(default_factory=list)  # open loop: due->done
    feed_late_s: list = field(default_factory=list)  # open loop: due->fed
    decode_s: list = field(default_factory=list)     # closed loop: each decode
    # distinct picture (decode index) -> times decoded in the window
    decoded: Counter = field(default_factory=Counter)
    # host phases on the wall clock: (start_ns, end_ns, name)
    phases: list = field(default_factory=list)
    setup_s: float = 0.0
    # the traced part of the window: its device events (trace.py's
    # tuples) and their trace.Trace, its end, length, frames and pictures
    # decoded, and the seconds the profiler's stop took (left out of the
    # window)
    trace_events: list = None
    trace: object = None
    trace_end_ns: int = 0
    trace_seconds: float = 0.0
    trace_frames: int = 0
    trace_decoded: Counter = field(default_factory=Counter)
    trace_read_s: float = 0.0
    bytes_needed: float = 0.0       # roofline.window_bytes, traced part
    peak_bytes_per_s: float = 0.0   # the card's memory rate (roofline)


class Reservoir:
    """A uniform sample of ``size`` of the items offered (a decode's or a
    picture's frames), drawn from the seed (reservoir sampling): at most
    ``size`` are held at a time, however many the window runs."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: dict = {}        # index of the item offered -> item
        self.offered = 0

    def offer(self, frames) -> None:
        i = self.offered
        self.offered += 1
        if i < self.size:
            self.kept[i] = frames
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = frames


def _sum_stats(total: dict, stats: dict) -> None:
    for k in STATS:
        total[k] = total.get(k, 0) + stats[k]


class Runner:
    """The port's decoder for one cell, on ``device`` (``"cuda"`` in a
    run; the tests drive ``"cpu"``).  ``decoder_cls`` and
    ``config_cls`` are the port's ``MP2VDecoder`` and
    ``DecoderConfig``."""

    def __init__(self, config: dict, traffic: dict, data: bytes, seed: int,
                 device: str, decoder_cls, config_cls, sync):
        self.config = config
        self.traffic = traffic
        self.sync = sync
        self.n_distinct = config["distinct_pictures"]
        # the MC implementation is read when the decoder builds a recon
        os.environ["MP2V_MC_IMPL"] = traffic["mc_impl"]
        self.dec = decoder_cls(config_cls(device=device, **traffic["decoder"]))
        if traffic["loop"] == "closed":
            self.data = generate.repeat_stream(data, traffic["repeat"])
            self.kept = Reservoir(traffic["sample_decodes"], seed)
        else:
            self.units = generate.picture_units(data)
            self.cycle = generate.cycle_units(self.units)
            self.fed = 0
            # of each picture offered: (its decode index, its frames)
            self.kept = Reservoir(traffic["sample_pictures"], seed)
            self.dec.renderer = self._rendered

    # -- warm-up -------------------------------------------------------
    def warm_up(self) -> None:
        """Every shape the window uses: ``warmup`` whole decodes (closed
        loop) or ``warmup`` cycles of the pictures fed back to back (open
        loop), each ended by a synchronize."""
        for _ in range(self.traffic["warmup"]):
            if self.traffic["loop"] == "closed":
                self.dec.reset()
                self.dec.decode(self.data)
            else:
                for _ in range(self.n_distinct):
                    self._feed()
            self.sync()

    # -- the window ----------------------------------------------------
    def run(self, seconds: float, profiler=None,
            trace_s: float = 0.0) -> Window:
        """The measured window, ``seconds`` long.  With ``profiler``, its
        first ``trace_s`` seconds (whole decodes or pictures) are traced;
        stopping the profiler, which reads the trace, happens while the
        decoder is idle and is left out of the window's time."""
        w = Window()
        self._profiler, self._trace_s = profiler, trace_s
        self._paused = 0.0
        if profiler is not None:
            profiler.start()
        if self.traffic["loop"] == "closed":
            self._closed(w, seconds)
        else:
            self._open(w, seconds)
        return w

    def _elapsed(self, t0: float) -> float:
        """Seconds of the window since ``t0``, pauses left out."""
        return time.perf_counter() - t0 - self._paused

    def _trace_point(self, w: Window, t0: float, last: bool) -> None:
        """After a decode or a picture: stop the profiler once the traced
        part is over (or the window is), and note what that part did."""
        if self._profiler is None or (
                not last and self._elapsed(t0) < self._trace_s):
            return
        w.trace_end_ns = time.time_ns()
        w.trace_seconds = self._elapsed(t0)
        w.trace_frames = w.frames
        w.trace_decoded = Counter(w.decoded)
        a = time.perf_counter()
        w.trace_events = self._profiler.stop()
        w.trace_read_s = time.perf_counter() - a
        self._paused += w.trace_read_s
        self._profiler = None

    def _closed(self, w: Window, seconds: float) -> None:
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
            _sum_stats(w.stats, self.dec.stats)
            w.decode_s.append((c - a) / 1e9)
            self.kept.offer(frames)
            w.frames += len(frames)
            for i in range(per):
                w.decoded[i % self.n_distinct] += 1
            done = self._elapsed(t0) >= seconds
            self._trace_point(w, t0, done)
            if done:
                break
        w.seconds = self._elapsed(t0)

    def _feed(self) -> list:
        """Hand the decoder the next picture's unit; returns its frames."""
        units = self.units if self.fed < self.n_distinct else self.cycle
        frames = self.dec.decode(units[self.fed % self.n_distinct])
        self.fed += 1
        return frames

    def _rendered(self, frame) -> None:
        self.sync()

    def _open(self, w: Window, seconds: float) -> None:
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
            w.decoded[index] += 1
            self._trace_point(w, t0, i == due_n - 1)
        w.seconds = self._elapsed(t0)
        w.stats = {k: self.dec.stats[k] - before[k] for k in STATS}
