"""The device trace of a window: ``torch.profiler`` with CUDA activity only
(no host-side operator events, so the host's work is not slowed by them)
over the window's first :data:`TRACE_S` seconds, reduced to what the
metric readers and the result's ``breakdown`` take.  Reading a trace takes
about a second for every 25,000 device events, so a whole 40-second window
of the interlaced cell (about a million) would take longer than the run
may.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

# seconds of the window that are traced (whole decodes or pictures)
TRACE_S = 5.0
# longest names kept in the breakdown, and the parts of a kernel's name
# that say nothing of it
NAME_CHARS = 120
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::")


def short(name: str) -> str:
    for noise in NOISE:
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


@dataclass
class Trace:
    """The device side of a traced window."""
    kernels: int = 0                # kernel launches that ran
    kernel_s: float = 0.0           # their summed durations
    busy_s: float = 0.0             # union of kernel, copy and set intervals
    window_s: float = 0.0           # the traced window (host clock)
    by_name: Counter = field(default_factory=Counter)  # name -> seconds
    # the longest idle gaps: (seconds, name of what the host was doing)
    gaps: list = field(default_factory=list)


def device_events(prof) -> list:
    """``(start_ns, end_ns, name, is_kernel)`` of every device event of a
    finished ``torch.profiler.profile``, by start."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        start = e.start_ns()
        kernel = not name.startswith(("Memcpy", "Memset"))
        out.append((start, start + e.duration_ns(), name, kernel))
    out.sort()
    return out


def union(events, lo: int, hi: int) -> list:
    """The union of the events' intervals inside ``[lo, hi]``, as sorted
    disjoint ``[start, end]`` lists."""
    merged = []
    for a, b, _, _ in events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _phase(phases, t: int) -> str:
    for a, b, name in phases:
        if a <= t < b:
            return name
    return "host: harness between calls"


def reduce(events, lo: int, hi: int, window_s: float, phases,
           n_gaps: int = 10) -> Trace:
    """The :class:`Trace` of the device events between the wall-clock
    times ``lo`` and ``hi`` (ns) of a window of ``window_s`` seconds; each
    of the ``n_gaps`` longest idle gaps named by the host phase (of
    ``phases``, ``(start_ns, end_ns, name)``) at its middle and by the
    device operation that ends it."""
    t = Trace(window_s=window_s)
    inside = [e for e in events if e[1] > lo and e[0] < hi]
    by_name = Counter()
    for a, b, name, kernel in inside:
        by_name[name] += b - a
        if kernel:
            t.kernels += 1
            t.kernel_s += (b - a) / 1e9
    for name, ns in by_name.items():
        t.by_name[short(name)] += ns / 1e9
    busy = union(inside, lo, hi)
    t.busy_s = sum(b - a for a, b in busy) / 1e9
    edges = [lo] + [x for seg in busy for x in seg] + [hi]
    starts = {a: name for a, _, name, _ in inside}
    gaps = []
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b > a:
            nxt = starts.get(b, "the window's end")
            gaps.append(((b - a) / 1e9,
                         f"{_phase(phases, (a + b) // 2)}; device idle until "
                         f"{short(nxt)}"))
    gaps.sort(reverse=True)
    t.gaps = gaps[:n_gaps]
    return t


class Profiler:
    """Starts and stops ``torch.profiler`` (CUDA activity) around a
    window, each end behind a synchronize; :meth:`stop` returns the
    device events."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.start()

    def stop(self) -> list:
        import warnings

        import torch
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            # one profiling cycle: that its events are cleared at its end
            # is no news
            warnings.simplefilter("ignore", UserWarning)
            self.prof.stop()
        return device_events(self.prof)
