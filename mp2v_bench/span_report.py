"""The decoder's own spans (``MP2VDecoder.spans``) over a cell's window,
beside the device trace of its first ``trace.TRACE_S`` seconds:

    python3 -m mp2v_bench.span_report --workload NAME --seeds N [N ...]
        [--seconds S] [--cost] [--out DIR]

from the repository root, on the card.  For each seed it makes the
cell's stream, builds and warms the decoder as ``run.py`` does, and runs
one traced window with the spans recording throughout.  It prints one
JSON line a seed: the per-layer quantities the spans give
(:func:`quantities`); the clock check, each pinned upload copy of the
trace against its ``upload`` span; and, with the trace moved onto the
spans' clock by those pairs, the ten longest idle gaps of the traced
part named by the innermost span open on each thread at the gap's
middle and split by span.  With ``--out``, each seed's records, upload
spans and copies go to ``DIR/<workload>_<seed>.json``.  With ``--cost``
it then times untraced windows of the last seed's decoder with the spans
off, on, on, off, and one span's begin and end on the host, off and on.

Nothing here is part of the benchmark's run (``run.py``): it compares no
frames and reports no metric of ``BENCHMARK.json``.  Needs a CUDA card and
a decoder with ``spans``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import statistics
import sys
import time
from collections import defaultdict

from . import trace as tracing

# how a thread's name is shortened in a gap's name
THREADS = (("mp2v-dispatch", "disp"), ("mp2v-fill", "fill"))
# the host-to-device copy of an uploaded staging slot
PINNED_HTOD = "Memcpy HtoD (Pinned -> Device)"


def _p95(values) -> float | None:
    """The 95th percentile, nearest rank."""
    xs = sorted(values)
    return xs[math.ceil(0.95 * len(xs)) - 1] if xs else None


def _short_thread(name: str) -> str:
    for prefix, short in THREADS:
        if name.startswith(prefix):
            return short
    return "main"


def index(records) -> dict:
    """Span name -> its records, by start."""
    by = defaultdict(list)
    for r in records:
        by[r[0]].append(r)
    for rs in by.values():
        rs.sort(key=lambda r: r[3])
    return by


def _within(rs, a: int, b: int) -> list:
    """The records of ``rs`` (by start) that start in ``[a, b)``."""
    i = bisect.bisect_left(rs, a, key=lambda r: r[3])
    j = bisect.bisect_left(rs, b, key=lambda r: r[3])
    return rs[i:j]


def innermost(records, t: int) -> str:
    """The innermost span open at ``t`` on each thread, compactly
    (``disp:fill_wait fill:slot_wait main:tokenize``), threads in that
    order; threads with no span open are left out."""
    best = {}
    for r in records:
        if r[3] <= t < r[4]:
            th = _short_thread(r[1])
            if th not in best or r[3] >= best[th][3]:
                best[th] = r
    order = ("disp", "fill", "main")
    return " ".join(f"{th}:{best[th][0]}" for th in order if th in best)


def gaps(events, lo: int, hi: int, phases, records, n: int = 10) -> list:
    """The ``n`` longest device-idle gaps between ``lo`` and ``hi`` (ns),
    longest first: ``(start_ns, end_ns, name)``, the name being the spans
    open at the gap's middle (:func:`innermost`), then ``trace.reduce``'s
    name of the gap."""
    inside = [e for e in events if e[1] > lo and e[0] < hi]
    busy = tracing.union(inside, lo, hi)
    edges = [lo] + [x for seg in busy for x in seg] + [hi]
    starts = {a: name for a, _, name, _ in inside}
    out = []
    for k in range(0, len(edges), 2):
        a, b = edges[k], edges[k + 1]
        if b > a:
            mid = (a + b) // 2
            spans = innermost(records, mid)
            nxt = tracing.short(starts.get(b, "the window's end"))
            out.append((a, b, (f"{spans} | " if spans else "")
                        + f"{tracing._phase(phases, mid)}; device idle "
                          f"until {nxt}"))
    out.sort(key=lambda g: g[0] - g[1])
    return out[:n]


def ramp(by: dict, decode) -> dict | None:
    """A decode's ramp, from its start to its first ``upload``, in ms,
    cut by spans into parts that add up to it: the walk to the first
    picture, chunk 0's tokenize calls and the caller's work between them,
    the hand-over to the fill thread, chunk 0's ``prepare`` (its
    ``slot_wait`` apart), the hand-over to the dispatch thread, and the
    dispatch up to the upload.  ``by``: :func:`index` of the records.
    ``None`` without chunk 0's prepare, dispatch and upload in the
    decode."""
    a, b = decode[3], decode[4]

    def first(name):
        return next((r for r in _within(by[name], a, b) if r[2] == 0), None)

    up, prep, disp = first("upload"), first("prepare"), first("dispatch")
    if up is None or prep is None or disp is None:
        return None
    toks = [r for r in _within(by["tokenize"], a, prep[3])
            if r[4] <= prep[3]]
    tok_s = sum(r[4] - r[3] for r in toks)
    slot = sum(r[4] - r[3] for r in _within(by["slot_wait"], prep[3], prep[4])
               if r[4] <= prep[4])
    parts = {
        "walk": toks[0][3] - a if toks else 0,
        "tokenize": tok_s,
        "between_tokenize": (toks[-1][4] - toks[0][3] - tok_s) if toks else 0,
        "to_fill": prep[3] - (toks[-1][4] if toks else a),
        "prepare_less_slot_wait": prep[4] - prep[3] - slot,
        "slot_wait": slot,
        "to_dispatch": disp[3] - prep[4],
        "dispatch_to_upload": up[3] - disp[3],
    }
    out = {k: v / 1e6 for k, v in parts.items()}
    out["ramp"] = (up[3] - a) / 1e6
    out["pictures"] = len(toks)
    return out


def split_gap(by: dict, a: int, b: int) -> dict:
    """An idle gap ``[a, b]`` (ns) that holds a decode's ramp, in ms: the
    time before that decode started (the last decode's end, the
    harness's synchronize and ``reset()``), the ramp's parts, and the
    time from the first upload's span to the gap's end (the copy's
    start).  ``by``: :func:`index` of the records."""
    dec = next(iter(_within(by["decode"], a, b)), None)
    if dec is None:
        return {}
    parts = ramp(by, dec)
    if parts is None:
        return {}
    parts["before_decode"] = (dec[3] - a) / 1e6
    parts["upload_to_copy"] = (b - dec[3]) / 1e6 - parts["ramp"]
    parts["gap"] = (b - a) / 1e6
    return parts


def upload_pairs(events, records, lo: int, hi: int) -> tuple:
    """The starts of the ``upload`` spans in ``[lo, hi]`` (the traced
    part) and of the trace's pinned upload copies, each in order: one
    copy an upload.  The copies are not cut at ``[lo, hi]``, whose clock
    they may not share."""
    ups = sorted(r[3] for r in records if r[0] == "upload" and lo <= r[3] < hi)
    copies = sorted(e[0] for e in events if e[2] == PINNED_HTOD)
    return ups, copies


def clock_check(pairs) -> dict:
    """Each pinned copy's start less its ``upload`` span's start (ms),
    over ``(upload, copy)`` pairs: the median, least and largest, and
    the copies that start before their span, which no copy can when the
    clocks agree."""
    offs = [(c - u) / 1e6 for u, c in pairs]
    return {"pairs": len(offs),
            "median_ms": statistics.median(offs) if offs else None,
            "min_ms": min(offs) if offs else None,
            "max_ms": max(offs) if offs else None,
            "copies_before_their_upload": sum(x < 0 for x in offs)}


def _line(us, d) -> list:
    """Each point's residual about Theil and Sen's line through
    ``(us, d)`` (the median of the pairs' slopes)."""
    slope = statistics.median(
        (d[j] - d[i]) / (us[j] - us[i])
        for i in range(len(us)) for j in range(i + 1, len(us))
        if us[j] > us[i])
    return [di - slope * (u - us[0]) for u, di in zip(us, d)]


def clock_pairs(ups, copies, shifts: int = 3) -> tuple:
    """``(shift, pairs)``: the i-th upload span's start paired with copy
    ``i - shift`` (a trace that starts late has lost its first copies),
    for the shift in ``[-shifts, shifts]`` whose clock differences
    (copy less upload) lie closest to a line, the smallest shift winning
    a tie; ``(None, [])`` with fewer than two pairs."""
    best = (None, None, [])
    for k in sorted(range(-shifts, shifts + 1), key=abs):
        pairs = [(u, copies[i - k]) for i, u in enumerate(ups)
                 if 0 <= i - k < len(copies)]
        if len(pairs) < 2:
            continue
        res = _line([u for u, _ in pairs], [c - u for u, c in pairs])
        mid = statistics.median(res)
        spread = statistics.median(abs(r - mid) for r in res)
        if best[0] is None or spread < best[0]:
            best = (spread, k, pairs)
    return best[1], best[2]


def aligned(events, pairs) -> list:
    """``events`` moved onto the spans' clock: each time less the clock
    difference (copy less upload) of the ``(upload, copy)`` pairs around
    it, interpolated on the trace's clock and held past the ends.  A
    copy then starts at its upload span's start: the copy's own
    latency, a tenth of a millisecond or two where the clocks agree, is
    given up to follow a trace clock that drifts and jumps."""
    cs = [c for _, c in pairs]
    ds = [c - u for u, c in pairs]

    def move(t):
        i = bisect.bisect_left(cs, t)
        if i == 0:
            return t - ds[0]
        if i == len(cs):
            return t - ds[-1]
        d0, d1 = ds[i - 1], ds[i]
        return t - d0 - round((d1 - d0) * (t - cs[i - 1]) / (cs[i] - cs[i - 1]))

    return [(move(a), move(b), name, k) for a, b, name, k in events]


def per_picture(records) -> dict:
    """Picture unit -> span name -> summed ms, of the picture-numbered
    spans and, on the latency path (a chunk a picture), the chunk's."""
    out = defaultdict(lambda: defaultdict(float))
    for r in records:
        out[r[2]][r[0]] += (r[4] - r[3]) / 1e6
    return out


def quantities(records, frames: int) -> dict:
    """What the spans say per frame and per decode over the window (ms):
    the waits (``chunk_wait``, ``slot_wait``, ``fill_wait``), the ramp,
    the dispatch thread's time off the processor, and for the latency
    path the 95th percentiles of a picture's host stages and its
    delivery."""
    def per_frame(name):
        total = sum(r[4] - r[3] for r in records if r[0] == name)
        return total / 1e6 / frames if frames else None

    q = {f"{n}_ms_per_frame": per_frame(n)
         for n in ("chunk_wait", "slot_wait", "fill_wait")}
    by = index(records)
    ramps = [x["ramp"] for x in (ramp(by, d) for d in by["decode"])
             if x is not None]
    q["ramp_ms_per_decode"] = statistics.fmean(ramps) if ramps else None
    off = sum(r[4] - r[3] - r[5] for r in records if r[0] == "dispatch")
    q["dispatch_offcpu_ms_per_frame"] = off / 1e6 / frames if frames else None
    pics = per_picture(records)
    chunked = any(r[0] == "fill_wait" for r in records)
    host = [p["tokenize"] + p["prepare"] + p["dispatch"]
            for p in pics.values() if "tokenize" in p and "dispatch" in p]
    q["picture_host_ms_p95"] = None if chunked else _p95(host)
    q["deliver_wait_ms_p95"] = None if chunked else _p95(
        (r[4] - r[3]) / 1e6 for r in records if r[0] == "deliver")
    return q


def live_tail(records, w, kinds=None) -> dict:
    """The open loop's pictures at or past the latency p95, each split
    into its feed's lateness and its spans (mean ms over those
    pictures); the window's i-th latency is its i-th decode.  With
    ``kinds``, the coding type of each distinct picture in feed order,
    the count of each type among those pictures (a decode's number
    counts the pictures fed since the decoder was made)."""
    decs = index(records)["decode"]
    lat = w.latencies_s
    if not decs or len(decs) != len(lat):
        return {}
    cut = _p95(lat)
    pics = per_picture(records)
    rows, types = [], defaultdict(int)
    for d, late, total in zip(decs, w.feed_late_s, lat):
        if total >= cut:
            if kinds:
                types["IPB"[kinds[d[2] % len(kinds)] - 1]] += 1
            p = pics[d[2]]
            parts = {k: p.get(k, 0.0) for k in (
                "tokenize", "prepare", "slot_wait", "dispatch", "upload",
                "recon", "deliver")}
            parts["feed_late"] = late * 1e3
            parts["decode"] = (d[4] - d[3]) / 1e6
            parts["latency"] = total * 1e3
            rows.append(parts)
    return {"pictures": len(rows), "types": dict(types),
            "latency_p95_ms": cut * 1e3,
            "feed_late_p95_ms": _p95(w.feed_late_s) * 1e3,
            "mean": {k: statistics.fmean(r[k] for r in rows)
                     for k in rows[0]} if rows else {}}


def span_cost(n: int = 200_000) -> dict:
    """µs of one span's begin and end on this host, recording off and on;
    and the thread CPU clock the spans read: its resolution as the system
    states it, and its reading (ms) over a half-second busy loop and a
    half-second sleep."""
    from tiny_mp2v_dec_tpu_torch.runtime.spans import Spans
    out = {"thread_clock_res_ns":
           time.clock_getres(time.CLOCK_THREAD_CPUTIME_ID) * 1e9}
    for kind in ("busy", "sleep"):
        c, t = time.thread_time_ns(), time.perf_counter()
        if kind == "sleep":
            time.sleep(0.5)
        while time.perf_counter() - t < 0.5:
            pass
        out[f"thread_ms_{kind}_500ms"] = (time.thread_time_ns() - c) / 1e6
    for state in ("off", "on"):
        s = Spans()
        if state == "on":
            s.start()
        t = time.perf_counter()
        for _ in range(n):
            s.end(s.begin(), "x", 0)
        out[f"us_per_span_{state}"] = (time.perf_counter() - t) / n * 1e6
        s.stop()
    return out


def run_seed(cell, seed: int, seconds: float, cost: bool,
             out_dir: str | None = None) -> dict:
    import torch

    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)

    from . import spec
    from .run import MAX_WORKERS, card_line
    from .streams import generate

    workers = max(1, min(MAX_WORKERS, os.cpu_count() or 1))
    with generate.worker_pool(workers) as pool:
        streams = spec.channel_streams(cell.config, seed, pool, cell.root)
    runner = cell.loop(spec.channels(cell.config), cell.traffic, streams,
                       seed, "cuda", MP2VDecoder, DecoderConfig,
                       torch.cuda.synchronize)
    runner.warm_up()
    runner.dec.spans.start()
    w = runner.run(seconds, tracing.Profiler(), tracing.TRACE_S)
    records = runner.dec.spans.stop()
    events, w.trace_events = w.trace_events, None
    w.trace = tracing.reduce(events, w.start_ns, w.trace_end_ns,
                             w.trace_seconds, w.phases)
    lo, hi = w.start_ns, w.trace_end_ns
    traced = [r for r in records if r[3] < hi]
    ups, copies = upload_pairs(events, records, lo, hi)
    shift, pairs = clock_pairs(ups, copies)
    out = {"workload": cell.name, "seed": seed, "card": card_line(),
           "frames_per_s": w.frames / w.seconds, "spans": len(records),
           "metrics": {}, "uploads": len(ups), "copies": len(copies),
           "shift": shift, "clock": clock_check(pairs)}
    if pairs:
        events = aligned(events, pairs)
    for m in cell.per_layer:
        value = spec.reader(m["name"], cell.root)(w)
        if value is not None:
            out["metrics"][m["name"]] = value
    out["spans_say"] = quantities(records, w.frames)
    by = index(traced)
    out["idle_gaps"] = [
        {"ms": (b - a) / 1e6, "name": name[:120],
         "split": split_gap(by, a, b)}
        for a, b, name in gaps(events, lo, hi, w.phases, traced)]
    if w.latencies_s:
        out["live_tail"] = live_tail(records, w,
                                     cell.generator.picture_types(
                                         cell.config))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{cell.name}_{seed}.json")
        with open(path, "w") as f:
            json.dump({"result": out, "records": records, "uploads": ups,
                       "copies": copies, "start_ns": lo,
                       "trace_end_ns": hi}, f)
    if cost:
        runs = []
        for on in (False, True, True, False):
            if on:
                runner.dec.spans.start()
            cw = runner.run(seconds)
            n = len(runner.dec.spans.stop())
            p95 = _p95(cw.latencies_s)
            runs.append({"spans": on, "records": n,
                         "frames_per_s": cw.frames / cw.seconds,
                         "latency_p95_ms": p95 and p95 * 1e3})
        out["cost"] = {"windows": runs, **span_cost()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mp2v_bench.span_report",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--out", help="directory for each seed's records")
    args = ap.parse_args(argv)

    import torch

    from . import spec
    if not torch.cuda.is_available():
        print("# span_report: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        out = run_seed(cell, seed, args.seconds,
                       args.cost and i == len(args.seeds) - 1, args.out)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
