"""Spans: the decoder's own work on each of its threads, as named
intervals on the wall clock.

An :class:`MP2VDecoder` owns one :class:`Spans`, off until ``start()``;
the decoder hands it to every :class:`~..ops.recon.GopRecon` it builds.
A record is ``(name, thread, unit, start_ns, end_ns, cpu_ns)``:

* ``name``: the span (the table below);
* ``thread``: the name of the thread that ran it: the caller's,
  ``mp2v-fill_0`` or ``mp2v-dispatch_0`` (``mp2v-tokenize_*`` in
  ``decode_batch``);
* ``unit``: what it worked on, counted since the decoder's ``reset()``:
  the picture's number (decode order) for ``tokenize``, ``deliver`` and
  ``pool_wait`` (the frame waited for), the decode's for ``decode``, and
  the chunk's for the others (on the latency path a chunk
  is one picture, and its number the picture's; in ``decode_batch`` the
  step's, and for ``batch_tokenize`` the call's), so that one chunk's
  spans join across the threads;
* ``start_ns``, ``end_ns``: ``time.time_ns()``, the clock of
  ``torch.profiler``'s events;
* ``cpu_ns``: the thread's CPU time in the span (``time.thread_time_ns``):
  wall less CPU is time off the processor, waiting for the interpreter
  lock, a lock, an event or the scheduler.

Spans nest on their thread; a span's parent is the one that encloses it:

==================  =====================================  ======================
span                thread, inside                         counter (``stats``)
==================  =====================================  ======================
``decode``          caller: ``MP2VDecoder.decode``         --
``batch_tokenize``  caller: ``decode_batch``'s tokenize    ``batch_tokenize_s``
                    of every stream
``tokenize``        caller (``decode``);                   ``tokenize_s``
                    ``mp2v-tokenize_*`` in ``decode_batch``
``chunk_wait``      caller: the oldest chunk in flight     ``chunk_wait_s``
``prepare``         fill; caller at ``gop_chunk=0`` and    ``fill_s``
                    in ``decode_batch``
``slot_wait``       ``prepare``: a free slot, its upload   ``slot_wait_s``
``fill_wait``       dispatch: the chunk's ``prepare``      ``fill_wait_s``
``dispatch``        dispatch; caller at ``gop_chunk=0``    ``device_s``
                    and in ``decode_batch``
``upload``          ``dispatch``                           --
``recon``           ``dispatch``: glue and kernel enqueue  --
``route``           after ``dispatch``; caller in flush    --
``pool_wait``       ``route``: the oldest frame's event    --
``deliver``         ``route``: host fetch and renderer     (``output_s``: fetch)
==================  =====================================  ======================

``decode_batch`` also counts, with no span, its device steps
(``batch_steps``), the no-op pictures that pad them (``noop_pictures``)
and the bytes its output stack and reference picks write on the device
(``batch_copy_bytes``).  Every path counts, with no span, the MC kernel
launches its pictures took (``mc_launches``, inside ``recon`` on the
chunk paths and inside ``dispatch`` in ``decode_batch`` and the row
bands): under ``mxu`` one a group of pictures that read no output of one
another, so that ``pictures / mc_launches`` is the pictures a launch.

A span and its counter come from the same two clock readings.  Off, a
span costs one test of the log in :meth:`Spans.begin` and one of its
result in :meth:`Spans.end`; the counters' clock readings are taken
either way.
"""
from __future__ import annotations

import threading
import time


class Spans:
    """The span log of one decoder.  Threads record into it at once:
    a list's ``append`` needs no lock."""

    __slots__ = ("log",)

    def __init__(self):
        self.log = None             # a list while recording

    def start(self) -> None:
        """Clear the log and record from now on."""
        self.log = []

    def stop(self) -> list:
        """Stop recording; the records since :meth:`start`, in the order
        their spans ended."""
        log, self.log = self.log, None
        return log if log is not None else []

    def begin(self, t0: int | None = None):
        """Open a span on this thread at ``t0`` (``time.time_ns()``, read
        now when not given): ``None`` when not recording, which
        :meth:`end` passes over."""
        log = self.log
        if log is None:
            return None
        return (log, time.time_ns() if t0 is None else t0,
                time.thread_time_ns())

    def end(self, span, name: str, unit: int, t1: int | None = None) -> None:
        """Close ``span`` (from :meth:`begin` on this thread) at ``t1``
        (read now when not given) and record it, unless recording stopped
        or started anew since it opened."""
        if span is None:
            return
        log, t0, cpu0 = span
        if log is self.log:
            log.append((name, threading.current_thread().name, unit, t0,
                        time.time_ns() if t1 is None else t1,
                        time.thread_time_ns() - cpu0))
