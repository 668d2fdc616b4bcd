"""Run one cell of ``BENCHMARK.json`` on the card:

    python3 -m mp2v_bench.run --workload NAME --seed N --seconds S --trace 0|1

from the repository root.  The run makes each channel's stream of the
cell's configuration from the seed (``spec.channel_streams``: the
generator the configuration names, ``streams/<name>.py``), builds
``tiny_mp2v_dec_tpu_torch``'s decoder as the cell's traffic mix says and
warms it up through the traffic's loop (``loops/<name>.py``; the
set-up), drives it for ``--seconds`` (the window's first
``trace.TRACE_S`` seconds under ``torch.profiler`` with ``--trace 1``, and
in every run of a cell with an end-to-end metric whose ``source`` is
``device_trace``), then decodes
every channel's stream with the plain reference (``reference.py``) and
has the loop compare the frames its window kept with them (``check.py``).
Standard error carries each channel's stream (pictures, bytes, a hash),
the seconds spent apart from the set-up, the card, and last each compared
number beside its limit; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py``), ``device``, with a trace ``breakdown``, and last
``checks``.

Nothing here names a cell, a loop, a generator or a metric: a new cell is
new files and entries (``spec.py`` says which), its name appended to the
``workloads`` list of each end-to-end metric it reports.

Without a CUDA card, or with fewer than the cell asks for, the run exits 2
and prints no result.  It exits 3, with no result, when JAX or the JAX
package is loaded once the window has closed.
"""
import time

# the start of the set-up: before anything heavy is imported
T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "tiny_mp2v_dec_tpu")
# worker processes that make the stream and run the reference
MAX_WORKERS = 8


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(BANNED))


def spread(seconds: list) -> str:
    """Quantiles of a list of seconds, in ms."""
    xs = sorted(seconds)
    q = {p: xs[min(len(xs) - 1, int(p / 100 * len(xs)))] * 1e3
         for p in (0, 25, 50, 75, 95, 99)}
    return (", ".join(f"p{p} {v:.4f}" for p, v in q.items())
            + f", max {xs[-1] * 1e3:.4f}")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi not read: {e}"
    return f"card: {out}; host {os.cpu_count()} CPUs"


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> dict:
    """One run of ``cell`` (``spec.Cell``); returns the result object.
    ``device="cpu"`` drives the port's plain versions (the tests)."""
    import hashlib

    import torch

    from tiny_mp2v_dec_tpu_torch.runtime.decoder import (DecoderConfig,
                                                          MP2VDecoder)

    from . import check, reference, roofline, spec
    from . import trace as tracing
    from .streams import generate

    cuda = device == "cuda"
    workers = max(1, min(MAX_WORKERS, os.cpu_count() or 1))
    configs = spec.channels(cell.config)
    t = time.perf_counter()
    with generate.worker_pool(workers) as pool:
        streams = spec.channel_streams(cell.config, seed, pool, cell.root)
    gen_s = time.perf_counter() - t
    for c, (config, data) in enumerate(zip(configs, streams)):
        log(f"stream of channel {c}: {config['distinct_pictures']} "
            f"pictures, {len(data)} bytes, sha256 "
            f"{hashlib.sha256(data).hexdigest()[:16]}")
    log(f"streams: {len(streams)} made in {gen_s:.3f} s on {workers} "
        f"processes (not set-up)")

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runner = cell.loop(configs, cell.traffic, streams, seed, device,
                       MP2VDecoder, DecoderConfig, sync)
    runner.warm_up()
    setup_s = time.perf_counter() - t_start - gen_s
    log(f"set-up: {setup_s:.3f} s, of which {t - t_start:.3f} s before "
        f"the stream (imports), {time.perf_counter() - t - gen_s:.3f} s "
        f"the decoder and its warm-up (CUDA context, kernel libraries "
        f"built or loaded)")
    # a run traces the window's first seconds with --trace 1, and on the
    # card also where an end-to-end metric is read from the device trace;
    # the profiler is the benchmark's, not the program's set-up
    profiled = trace or (cuda and any(m["source"] == "device_trace"
                                      for m in cell.end_to_end))
    profiler = None
    if profiled:
        t = time.perf_counter()
        profiler = tracing.Profiler()
        log(f"profiler made in {time.perf_counter() - t:.3f} s (not set-up)")
    w = runner.run(seconds, profiler, tracing.TRACE_S)
    w.setup_s = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if w.feed_late_s:
        log(f"feed: {len(w.feed_late_s)} pictures due; fed late by ms "
            f"{spread(w.feed_late_s)}; latency ms {spread(w.latencies_s)}")
    if w.decode_s:
        log(f"decodes: {len(w.decode_s)} in {w.seconds:.4f} s, "
            f"{w.frames / w.seconds:.4f} frames/s; each, ms "
            f"{spread(w.decode_s)}")
    # the program's state goes before the reference runs; the frames the
    # window kept stay for the comparison
    runner.dec = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    refs = reference.decode_all(streams, workers)
    ref_s = time.perf_counter() - t
    comp = runner.compare(refs, device)
    kept, runner.kept = runner.kept, None
    log(f"reference: {'+'.join(str(len(r.pcts)) for r in refs)} pictures "
        f"in {ref_s:.3f} s on {workers} processes (not set-up); compared "
        f"{comp.frames} frames of {len(kept.kept)} of the window's "
        f"{kept.offered} {runner.SAMPLED}, drawn from the seed; "
        f"{comp.missing} missing")
    if len(refs) > 1:
        log("mismatched bytes by channel: " + ", ".join(
            f"{c}: {comp.bad_by_channel[c]}" for c in range(len(refs))))
    numbers = comp.numbers()
    del kept

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": check.correct(numbers), "attempted": w.frames,
              "failed": comp.failed, "metrics": {}, "device": dev}
    if profiled and w.trace_events is not None:
        events, w.trace_events = w.trace_events, None
        t = time.perf_counter()
        w.trace = tracing.reduce(events, w.start_ns, w.trace_end_ns,
                                 w.trace_seconds, w.phases)
        if events:
            log(f"trace: the window's first {w.trace_seconds:.4f} s, "
                f"{w.trace_frames} frames, {len(events)} device events, the "
                f"first {(events[0][0] - w.start_ns) / 1e6:.3f} ms after "
                f"its start, the last ending "
                f"{(w.trace_end_ns - max(e[1] for e in events)) / 1e6:.3f} "
                f"ms before its end; read in {w.trace_read_s:.3f} s (left "
                f"out of the window), reduced in "
                f"{time.perf_counter() - t:.3f} s")
        w.bytes_needed = roofline.window_bytes(w.trace_decoded, refs)
        w.peak_bytes_per_s = roofline.PEAK_BYTES_PER_S.get(dev["kind"], 0)
    if trace and w.trace is not None:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in
                           w.trace.by_name.most_common(10)],
            "idle_gaps": [[n, s] for s, n in w.trace.gaps]}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(w)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m mp2v_bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec
    try:
        cell = spec.cell(args.workload)
    except KeyError as e:
        log(f"FAILED: {e}")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("FAILED: torch finds no CUDA device; this benchmark measures "
            "the card and has no CPU fallback")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"FAILED: {args.workload} needs {cell.chips} CUDA devices, "
            f"torch finds {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        log(f"FAILED: the run loaded {', '.join(found)}")
        return 3
    log(card_line())
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
