"""What every traffic loop shares: the port's decoder built from a traffic
mix's parameters (``traffic/<name>.json``), the measured window's record
(:class:`Window`), the sample of what it produced (:class:`Reservoir`),
and the traced part's start and end with the pause its reading takes.

The loops themselves are modules ``loops/<name>.py``, found by the
traffic mix's ``"loop"`` (``spec.loop``).  Each holds a class ``Loop``,
a :class:`Runner`, that supplies

* ``prepare()``: its own state, once the decoder is built (the streams
  it feeds, its sample);
* ``warm_up()``: every shape its window uses, each ended by a
  synchronize;
* ``window(w, seconds)``: the measured window, filling ``w``; after each
  decode or picture it calls :meth:`Runner._trace_point`;
* ``compare(refs, device)``: what its sample kept, held against the
  references (``reference.Reference``, one a channel), as a
  ``check.Comparison``.

``loops/closed.py`` (whole decodes back to back) and ``loops/open.py``
(one picture a call at its due time) drive one channel.  A loop over
several channels, or any other, is a new file and a traffic mix naming
it: nothing here changes.

A window's ``stats`` carries every numeric counter of the decoder's
``stats`` (:func:`add_stats`, :func:`stats_since`), so a new counter of the
program is read by a new metric file alone.  A traffic mix with
``"spans": true`` has the decoder's spans recorded over the traced part
(``Window.spans``: ``runtime/spans.py``'s records).

So a cell with a new loop, a new generator (``streams/<name>.py``, named
by the configuration's ``"generator"``), a channel list (the
configuration's ``"channels"``) or a new counter is new files and entries
alone (``spec.py`` lists them); its name is appended to the ``workloads``
list of each end-to-end metric it reports, the benchmark's schema.
"""
from __future__ import annotations

import os
import random
import time
from collections import Counter
from dataclasses import dataclass, field


@dataclass
class Window:
    """What one measured window did, for the metric readers."""
    frames: int = 0                 # frames delivered in the window
    seconds: float = 0.0            # its length on the host clock
    start_ns: int = 0               # its start on the wall clock (time_ns)
    # every numeric counter of the decoder's stats over the window
    stats: dict = field(default_factory=dict)
    latencies_s: list = field(default_factory=list)  # open loop: due->done
    feed_late_s: list = field(default_factory=list)  # open loop: due->fed
    decode_s: list = field(default_factory=list)     # closed loop: each decode
    # (channel, distinct picture by decode index) -> times decoded
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
    # the decoder's span records over the traced part ("spans": true)
    spans: list = None
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


def _numeric(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def add_stats(total: dict, stats: dict) -> None:
    """Add every numeric counter of ``stats`` into ``total``."""
    for k, v in stats.items():
        if _numeric(v):
            total[k] = total.get(k, 0) + v


def stats_since(before: dict, after: dict) -> dict:
    """Every numeric counter's growth from ``before`` to ``after``."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if _numeric(v)}


class Runner:
    """The port's decoder for one cell, on ``device`` (``"cuda"`` in a
    run; the tests drive ``"cpu"``), and the window's bookkeeping that
    every loop shares.  ``configs`` and ``streams`` hold each channel's
    configuration and stream (``spec.channels``); ``decoder_cls`` and
    ``config_cls`` are the port's ``MP2VDecoder`` and ``DecoderConfig``.
    A loop subclasses it (module doc)."""

    # what the loop's sample (``self.kept``, a Reservoir) is made of, for
    # the run's log
    SAMPLED = "items"

    def __init__(self, configs: list, traffic: dict, streams: list,
                 seed: int, device: str, decoder_cls, config_cls, sync):
        self.configs = configs
        self.traffic = traffic
        self.streams = streams
        self.seed = seed
        self.sync = sync
        # the MC implementation is read when the decoder builds a recon
        os.environ["MP2V_MC_IMPL"] = traffic["mc_impl"]
        self.dec = decoder_cls(config_cls(device=device, **traffic["decoder"]))
        self.prepare()

    def one_channel(self) -> tuple:
        """The configuration and stream of a loop that drives one
        channel; a configuration of several channels needs another."""
        if len(self.configs) != 1:
            raise ValueError(
                f"the {self.traffic['loop']!r} loop drives one channel; the "
                f"configuration has {len(self.configs)}")
        return self.configs[0], self.streams[0]

    def prepare(self) -> None:
        raise NotImplementedError

    def warm_up(self) -> None:
        raise NotImplementedError

    def window(self, w: Window, seconds: float) -> None:
        raise NotImplementedError

    def compare(self, refs: list, device):
        raise NotImplementedError

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
            if self.traffic.get("spans"):
                self.dec.spans.start()
        self.window(w, seconds)
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
        if self.traffic.get("spans"):
            w.spans = self.dec.spans.stop()
        w.trace_seconds = self._elapsed(t0)
        w.trace_frames = w.frames
        w.trace_decoded = Counter(w.decoded)
        a = time.perf_counter()
        w.trace_events = self._profiler.stop()
        w.trace_read_s = time.perf_counter() - a
        self._paused += w.trace_read_s
        self._profiler = None
