"""Timing on an NVIDIA GPU: the port's counterpart of the JAX package's
``tools/tbench.py`` (``chain_time`` / ``report``).

The JAX version chained a salted op through a ``fori_loop`` so that a
remote TPU could not return early.  On a local card the host's per-call
work is what hides the device: :func:`cuda_ms` queues the calls behind a
GPU sleep that outlasts their enqueue, then reads CUDA events around them.
:func:`step_ms` is the other measure, a whole step on the host's clock,
for work that the host bounds.  Both need a CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import torch

TIMED_RUNS = 20


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

_CYCLES_PER_MS = []


def _sleep_cycles_per_ms() -> float:
    """GPU clock cycles per millisecond of ``torch.cuda._sleep``, timed once
    with CUDA events."""
    if not _CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: ``runs`` calls back to back
    between two CUDA events, queued behind a GPU sleep that outlasts the
    host's enqueue of all of them, so that the host's per-call work (the
    wrapper's checks, ``ctypes``, allocation) does not show as device
    time; the mean over the runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # generous: the sleep ends before the start event, so it costs no time
    torch.cuda._sleep(int((4 * enqueue_ms + 10) * _sleep_cycles_per_ms()))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def step_ms(fn, runs: int = 5, warmup: int = 1) -> float:
    """Host milliseconds per call of ``fn``, each call ended by
    ``torch.cuda.synchronize()``: the median over ``runs``.  For a step
    whose host work (launches, glue) bounds it, where device time alone
    would leave the host out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def report(name: str, fn, runs: int = TIMED_RUNS) -> float:
    """Print and return :func:`cuda_ms` of ``fn``."""
    ms = cuda_ms(fn, runs)
    print(f"{name:52s} {ms:9.4f} ms")
    return ms
