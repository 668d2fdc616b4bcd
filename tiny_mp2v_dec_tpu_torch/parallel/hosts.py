"""Multi-host scale-out: closed-GOP distribution over worker processes.

Counterpart of ``tiny_mp2v_dec_tpu/parallel/hosts.py``.  MPEG-2's own
random-access unit is the GOP: a sequence header may repeat, and a GOP whose
``closed_gop`` bit is set references nothing before it (ISO 13818-2
6.3.8).  The reference decoder schedules *pictures* over shared-memory
worker threads with a dependency DAG (reference:
src/core/threads.cpp:100-159); across machines the same DAG factors into
independent closed GOPs, decoded apart, with display order restored by
concatenating per-GOP display-order output.

:class:`MultiHostDecoder` simulates N hosts as N worker processes, each
with its own interpreter, CUDA context and :class:`MP2VDecoder` on
``device`` (the card by default; ``"cpu"`` runs the kernels' plain
versions).  Work is distributed GOP-round-robin and results merged in
stream order.  :func:`split_gops` closes a chunk at every
``sequence_end_code``, so a stream of sequences joined with their end codes
decodes whole here, where one decoder stops at the first end code.
"""
from __future__ import annotations

import collections
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

from .. import headers as H
from ..golden.decoder import scan_start_codes


@dataclass
class GopChunk:
    """One independently decodable unit: prefix (latest sequence header +
    extensions bytes) + the GOP's own bytes."""
    data: bytes
    n_pictures: int
    index: int


def split_gops(data: bytes) -> List[GopChunk]:
    """Split an elementary stream into independently decodable GOP chunks.

    A cut is legal at a sequence header or GOP header only when the access
    unit that begins there is *closed*: its first GOP header (if any,
    before the first picture) has closed_gop=1.  An open GOP's leading B
    pictures reference the previous GOP's anchor (ISO 13818-2 6.3.8), so
    open GOPs stay attached to their predecessor chunk.  Each chunk is
    prefixed with the most recent sequence header bytes so a worker can
    decode it standalone (sequence headers legally repeat mid-stream;
    reference re-parses them, decoder.cpp:291).
    """
    offs = [int(o) for o in scan_start_codes(data)]
    offs.append(len(data))
    n_ev = len(offs) - 1

    def closed_at(i: int) -> bool:
        """Is the access unit whose headers begin at event i closed?
        The first GOP header before the first picture decides.  When a
        picture start code appears before any GOP header (e.g. a repeated
        sequence header directly preceding a P/B picture), closedness
        cannot be established — return False so the unit stays attached to
        its predecessor (cutting there would decode P/B pictures without
        their reference anchor)."""
        for j in range(i, n_ev):
            code = data[offs[j] + 3]
            if code == H.GROUP_START_CODE:
                r = H.BitReader(data, (offs[j] + 4) * 8)
                return bool(H.GroupOfPicturesHeader.parse(r).closed_gop)
            if code == H.PICTURE_START_CODE:
                return False
        return False

    seq_hdr: Optional[bytes] = None   # latest seq header + following exts
    chunks: List[GopChunk] = []
    cur_start = None      # byte offset where the current chunk begins
    cur_prefix = b""
    cur_pics = 0
    # A picture-level quant matrix extension legally persists across GOP
    # boundaries until the next sequence header (6.3.11); a chunk prefix
    # replays only the sequence header, which would reset the matrices, so
    # no cut is legal while a downloaded matrix is live.
    qm_live = False

    def close(end_off):
        nonlocal cur_start, cur_pics
        if cur_start is not None and cur_pics > 0:
            chunks.append(GopChunk(cur_prefix + data[cur_start:end_off],
                                   cur_pics, len(chunks)))
            cur_start, cur_pics = None, 0

    for i in range(n_ev):
        off = offs[i]
        code = data[off + 3]
        if code == H.SEQUENCE_HEADER_CODE:
            # A cut at a sequence header is legal even while a downloaded
            # quant matrix is live: the new chunk's first event is this
            # very header, which resets the matrices anyway (6.3.11) —
            # only GOP-header cuts need the qm_live guard below.
            if cur_pics > 0 and closed_at(i):
                close(off)
            qm_live = False   # 6.3.11: sequence header resets matrices
            j = i + 1
            while j < n_ev and data[offs[j] + 3] in (
                    H.EXTENSION_START_CODE, H.USER_DATA_START_CODE):
                j += 1
            seq_hdr = data[off:offs[j]]
            if cur_start is None:
                cur_start, cur_prefix = off, b""
        elif code == H.EXTENSION_START_CODE:
            if H.BitReader(data, (off + 4) * 8).read(4) == \
                    H.QUANT_MATRIX_EXTENSION_ID:
                qm_live = True
        elif code == H.GROUP_START_CODE:
            if cur_pics > 0 and not qm_live and closed_at(i):
                close(off)
            if cur_start is None:
                cur_start = off
                cur_prefix = seq_hdr or b""
        elif code == H.PICTURE_START_CODE:
            if cur_start is None:   # pictures with no GOP header at all
                cur_start = off
                cur_prefix = seq_hdr or b""
            cur_pics += 1
        elif code in (H.SEQUENCE_END_CODE, H.SEQUENCE_ERROR_CODE):
            close(off)
    close(len(data))
    return chunks


# ----------------------------------------------------------------------
# Worker process side
_WORKER_DEC = None


def _claim_core(counter_path: str) -> int:
    """Atomically claim a distinct worker index via a lock-protected
    counter file (ProcessPoolExecutor initializers get no worker index)."""
    import fcntl
    with open(counter_path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        txt = f.read().strip()
        idx = int(txt) if txt else 0
        f.seek(0)
        f.truncate()
        f.write(str(idx + 1))
        fcntl.flock(f, fcntl.LOCK_UN)
    return idx


def _worker_init(counter_path: Optional[str] = None,
                 cores_per_host: int = 0):
    if counter_path is not None and cores_per_host > 0 and hasattr(
            os, "sched_setaffinity"):
        # Simulated-host resource isolation: pin each worker to its own
        # core slice BEFORE torch creates its thread pool, so that the
        # pool is sized to the slice (one "host's" CPUs, not the machine's)
        idx = _claim_core(counter_path)
        n = os.cpu_count() or 1
        cores = {(idx * cores_per_host + c) % n for c in range(cores_per_host)}
        os.sched_setaffinity(0, cores)
    import torch
    if cores_per_host > 0:
        torch.set_num_threads(cores_per_host)


def _worker_decode(payload):
    """Decode one GOP chunk; returns (index, [frame YUV bytes...], the
    kernel launches of the decode as a Counter)."""
    global _WORKER_DEC
    idx, data, cfg_kw = payload
    from ..ops import _build
    from ..runtime.decoder import DecoderConfig, MP2VDecoder
    if _WORKER_DEC is None:
        _WORKER_DEC = MP2VDecoder(DecoderConfig(**cfg_kw))
    dec = _WORKER_DEC
    dec.reset()
    before = collections.Counter(_build.LAUNCHES)
    frames = [f.tobytes() for f in dec.decode(data)]
    return idx, frames, collections.Counter(_build.LAUNCHES) - before


class MultiHostDecoder:
    """GOP-granular work distribution across N simulated hosts.

    ``decode`` returns per-frame YUV bytes in display order.  The pool is
    persistent: workers keep their decoder (its built kernels, staging and
    token arrays) across calls, so repeated decodes measure scheduling +
    decode, not process startup — the measurement discipline of the
    reference's threads_test (fake 100 us tasks isolate the scheduler,
    test/gtest/threads/threads_test_common.hpp:3-11).

    Every worker decodes on ``device``: ``"cuda"`` (the default) raises
    from ``warmup``/``decode`` where a worker finds no CUDA device; nothing
    falls back to the CPU.  ``config_kwargs`` are the other
    :class:`DecoderConfig` fields; a ``"device"`` among them is refused as
    ambiguous.  :attr:`launches` sums the workers' kernel launches over
    the chunks that ``decode`` gave them (``ops._build.LAUNCHES`` in each).
    """

    def __init__(self, n_hosts: int, device: str = "cuda",
                 config_kwargs: Optional[dict] = None,
                 cores_per_host: int = 0):
        import multiprocessing as mp
        import tempfile
        self.n_hosts = n_hosts
        self.config_kwargs = dict(config_kwargs or {})
        if "device" in self.config_kwargs:
            raise ValueError("pass the device as MultiHostDecoder(device=...)"
                             ", not in config_kwargs")
        self.config_kwargs.setdefault("reordering", True)
        self.config_kwargs["device"] = device
        self.launches: collections.Counter = collections.Counter()
        counter = None
        if cores_per_host > 0:
            fd, counter = tempfile.mkstemp(prefix="mp2v_hosts_")
            os.close(fd)
        # spawn: forking a process that holds a CUDA context is unsafe
        # (inherited locks and threads)
        self._pool = ProcessPoolExecutor(
            max_workers=n_hosts, mp_context=mp.get_context("spawn"),
            initializer=_worker_init, initargs=(counter, cores_per_host))

    def warmup(self, data: bytes) -> None:
        """Start every worker and build its decoder on this stream's
        first chunks (a worker's first decode loads the kernels)."""
        chunks = split_gops(data)
        if not chunks:
            return
        payloads = [(i, chunks[min(i, len(chunks) - 1)].data,
                     self.config_kwargs) for i in range(self.n_hosts)]
        list(self._pool.map(_worker_decode, payloads))

    def decode(self, data: bytes) -> List[bytes]:
        chunks = split_gops(data)
        payloads = [(c.index, c.data, self.config_kwargs) for c in chunks]
        results = {}
        for idx, frames, launches in self._pool.map(_worker_decode,
                                                     payloads):
            results[idx] = frames
            self.launches += launches
        out: List[bytes] = []
        for c in chunks:
            out.extend(results[c.index])
        return out

    def close(self):
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
