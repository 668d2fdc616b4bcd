"""Production decoder: host parse/tokenize -> device reconstruction.

Counterpart of ``tiny_mp2v_dec_tpu/runtime/decoder.py`` (itself modelled on
the reference's ``mp2v_decoder_c``, reference: src/core/decoder.h:82-131,
decoder.cpp:278-329): the host walks start codes, keeps sequence/picture
state and the two-slot reference list, tokenizes each picture's slices with
the native tokenizer, and reconstructs pictures on the device through
:class:`~..ops.recon.GopRecon` — in chunks of ``gop_chunk`` pictures, or one
picture at a time (``gop_chunk=0``).  Reference planes stay on the device
between pictures; display reordering matches decoder.cpp:346-379.

With ``gop_chunk > 0`` a chunk runs through three threads, as in the JAX
package's ``_flush_chunk``: the caller's thread parses and tokenizes chunk
N+2, a fill thread packs chunk N+1 into a staging slot
(:meth:`GopRecon.prepare`), and a dispatch thread uploads chunk N, launches
its kernels on the device's default stream, owns the reference list and
routes and delivers its frames (the renderer runs there).  At most two
chunks are in flight; a worker's exception is raised from ``decode`` or
``flush``.  The latency path (``gop_chunk=0``) runs every step on the
caller's thread.

Two multi-device paths run on the caller's thread too, as in the JAX
package: ``mesh="rows"`` reconstructs each picture in bands of MB rows
(:class:`~..parallel.mesh.RowShardedRecon`), and
:meth:`MP2VDecoder.decode_batch` decodes several streams, a picture of
each per step (:class:`~..parallel.mesh.StreamBatchRecon`).  Their frames
are :class:`PlanesFrame` objects.
"""
from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import headers as H
from ..golden.decoder import scan_start_codes
from ..ops.recon import GopRecon, resolve_mc_impl
from ..parallel.mesh import RowShardedRecon, StreamBatchRecon, make_mesh
from ..tokenizer import get_tokenizer
from ..tokenizer.types import (CHROMA_INFO, PictureGeometry, PictureParams,
                               PictureTokens)
from .spans import Spans


@dataclass
class DecoderConfig:
    """The JAX package's DecoderConfig (modelled on the reference's
    decoder_config_t, decoder.h:25-32) plus the device."""
    width: int = 0                # 0 = take from the sequence header
    height: int = 0
    chroma_format: int = 0
    # max undelivered pictures in flight (0 = unbounded): once exceeded,
    # routing a frame waits for the oldest frame's chunk to finish on the
    # device — never for the chunk being routed, so a chunk larger than the
    # pool does not serialize the host against its own work
    pictures_pool_size: int = 10
    num_threads: int = 0          # 0 = auto (native tokenizer threads)
    reordering: bool = True
    # >0: reconstruct pictures in chunks of this size from one upload;
    # 0: picture-at-a-time (min latency)
    gop_chunk: int = 0
    # False: deliver frames as device-resident LazyFrame objects (planes
    # pulled to host only on attribute access)
    output_host: bool = True
    # JAX-only options, kept so configurations carry over; the port has no
    # Pallas path and refuses them
    use_pallas: Optional[bool] = None
    pallas_interpret: bool = False
    # "rows": reconstruct each picture in mesh_devices bands of MB rows
    # (RowShardedRecon; it takes precedence over gop_chunk)
    mesh: Optional[str] = None
    # devices of the row mesh and of decode_batch's stream shards (0 = the
    # visible devices of the decoder's type); more than there are repeat
    # them (parallel.mesh.make_mesh).  A row count that does not divide
    # mb_height pads the geometry, and windows then clamp to the padded
    # height, as in the JAX mesh (ROADMAP Queue 3)
    mesh_devices: int = 0
    # "raise": abort on the first malformed slice; "drop_slice": keep the
    # bad slice's parsed prefix, decode everything else, count the drops in
    # stats["bad_slices"]
    on_error: str = "raise"
    # torch device of the reconstruction: "cuda" runs the CUDA kernels and
    # raises when there is no GPU; "cpu" runs their plain versions
    device: str = "cuda"

    def __post_init__(self):
        if self.mesh not in (None, "rows"):
            raise ValueError(f"mesh={self.mesh!r}: None or 'rows'")
        if self.mesh_devices < 0:
            raise ValueError(f"mesh_devices={self.mesh_devices}")
        if self.use_pallas not in (None, False) or self.pallas_interpret:
            raise NotImplementedError("use_pallas / pallas_interpret select "
                                      "the JAX package's Pallas kernels")


class ChunkHost:
    """The host copy of one chunk's ``(t, frame_bytes)`` uint8 tensor,
    shared by the chunk's frames: one transfer a chunk.  With ``copied``
    (host output on ``cuda``), the copy into the pinned tensor ``pinned``
    was started when the chunk's kernels were queued, and reading waits on
    that event; without, the first read pulls the tensor with a blocking
    copy (the counterpart of the JAX package's ``copy_to_host_async`` and
    ``_fetch_concurrent``)."""

    def __init__(self, packed: torch.Tensor, pinned=None, copied=None):
        self._packed = packed
        self._pinned = pinned
        self._copied = copied
        self._array = None

    def array(self) -> np.ndarray:
        if self._array is None:
            if self._copied is not None:
                self._copied.synchronize()
                self._array = self._pinned.numpy()
            else:
                self._array = self._packed.cpu().numpy()
        return self._array


def host_copy(t: torch.Tensor) -> ChunkHost:
    """A :class:`ChunkHost` of ``t``: on ``cuda`` its copy to pinned host
    memory is queued now, behind the kernels that write ``t``; on the CPU
    the first read takes the tensor."""
    if not t.is_cuda:
        return ChunkHost(t)
    # the caching host allocator reuses this block only after the copy
    # recorded on it has completed
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return ChunkHost(t, pinned, copied)


class LazyFrame:
    """A decoded frame: row ``index`` of a chunk's ``(t, frame_bytes)``
    uint8 tensor, read on the host on first plane access through the
    chunk's :class:`ChunkHost`.  ``picture``: its number in decode order
    since the decoder's ``reset()``."""

    def __init__(self, packed: torch.Tensor, index: int,
                 geom: PictureGeometry, temporal_reference: int,
                 picture_coding_type: int, shared: ChunkHost, event=None,
                 picture: int = 0):
        self._packed = packed
        self._index = index
        self._geom = geom
        self._host = None
        self._shared = shared
        self.event = event          # CUDA event recorded after the chunk
        self.picture = picture
        self.temporal_reference = temporal_reference
        self.picture_coding_type = picture_coding_type

    def device_buffer(self) -> torch.Tensor:
        return self._packed[self._index]

    def _flat(self) -> np.ndarray:
        if self._host is None:
            self._host = self._shared.array()[self._index]
        return self._host

    @property
    def y(self):
        g = self._geom
        return self._flat()[:g.height * g.width].reshape(g.height, g.width)

    def _chroma(self, second):
        g = self._geom
        xs, ys, _ = CHROMA_INFO[g.chroma_format]
        cw = (g.width + (1 << xs) - 1) >> xs
        ch = (g.height + (1 << ys) - 1) >> ys
        ny = g.height * g.width
        nc = ch * cw
        off = ny + (nc if second else 0)
        return self._flat()[off:off + nc].reshape(ch, cw)

    @property
    def u(self):
        return self._chroma(False)

    @property
    def v(self):
        return self._chroma(True)

    def tobytes(self) -> bytes:
        return self._flat().tobytes()


class PlanesFrame:
    """A decoded frame backed by its padded ``(y, u, v)`` device planes,
    as the multi-device paths deliver it (the JAX package's
    ``PlanesFrame``).  Read on the host on first plane access: through
    ``shared``, a stream batch step's :class:`ChunkHost` per plane of its
    stacked planes, row ``index``; or, without, by pulling the planes.
    ``picture``: its number in its stream's decode order."""

    def __init__(self, planes, geom: PictureGeometry,
                 temporal_reference: int, picture_coding_type: int,
                 shared=None, index: int = 0, picture: int = 0):
        self._planes = planes
        self._geom = geom
        self._shared = shared
        self._index = index
        self._host = None
        self.event = None
        self.picture = picture
        self.temporal_reference = temporal_reference
        self.picture_coding_type = picture_coding_type

    def device_buffer(self):
        return self._planes

    def _fetch(self):
        if self._host is None:
            if self._shared is not None:
                self._host = tuple(h.array()[self._index]
                                   for h in self._shared)
            else:
                self._host = tuple(p.cpu().numpy() for p in self._planes)
        return self._host

    _flat = _fetch  # what MP2VDecoder._drain reads

    @property
    def y(self):
        g = self._geom
        return self._fetch()[0][:g.height, :g.width]

    def _chroma(self, i):
        g = self._geom
        xs, ys, _ = CHROMA_INFO[g.chroma_format]
        cw = (g.width + (1 << xs) - 1) >> xs
        ch = (g.height + (1 << ys) - 1) >> ys
        return self._fetch()[i][:ch, :cw]

    @property
    def u(self):
        return self._chroma(1)

    @property
    def v(self):
        return self._chroma(2)

    def tobytes(self) -> bytes:
        return self.y.tobytes() + self.u.tobytes() + self.v.tobytes()


class MP2VDecoder:
    """Decode MPEG-2 elementary streams to YUV frames on a torch device.

    Frames are delivered to ``renderer`` (if given) and returned from
    ``decode`` in display order (or decode order with reordering off).
    """

    def __init__(self, config: Optional[DecoderConfig] = None,
                 renderer: Optional[Callable[[LazyFrame], None]] = None):
        self.config = config if config is not None else DecoderConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"DecoderConfig.device={self.config.device!r} but "
                    f"torch finds no CUDA device")
            if self.device.index is None:
                # the worker threads are set to this device (_worker_pool)
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.renderer = renderer
        self.tokenize_picture = get_tokenizer(self.config.num_threads,
                                              self.config.on_error)
        self._recons = {}
        # the row-sharded and stream-batch recons
        self._mesh_recons = {}
        # the fill and dispatch threads, made on the first chunk; they
        # live across reset()
        self._fill_pool = self._disp_pool = None
        self._chunk_jobs = []
        # tokens whose chunk is prepared, for the next pictures to reuse
        # (the fill thread appends, this thread pops): allocating each
        # picture's 6-8 MB of 1080-line token arrays afresh while other
        # chunks' are freed slows the tokenizer, whose threads fault the
        # new pages in (PERF.md).  While this thread tokenizes a chunk, the
        # fill thread hands back at most the two chunks before it, so two
        # chunks' worth are kept (older sets are dropped); they outlive
        # reset(), for the next stream
        self._spare_tokens = deque(
            maxlen=2 * max(self.config.gop_chunk, 1))
        # off until spans.start(); kept across reset() (runtime/spans.py)
        self.spans = Spans()
        self.reset()

    def reset(self) -> None:
        # the jobs of an abandoned stream run to their end first (its
        # decode() has raised already); their outcome is dropped with it
        wait(self._chunk_jobs)
        self._chunk_jobs = []
        self.seq: Optional[H.SequenceHeader] = None
        self.sext = H.SequenceExtension()
        self.sscal = None
        self.gop = None
        self.qmext = None
        self._refs = [None, None]      # device plane tuples, decode order
        self._reorder_slot = None
        self._out_fifo = []            # decoded, not yet delivered frames
        self._routing_event = None     # event of the chunk being routed
        self.user_data: List[bytes] = []  # reference: decoder.cpp:194-200
        self._chunk: List[tuple] = []  # (tokens, geom, ph) awaiting batch
        self._frames: List[LazyFrame] = []
        # decode() calls, chunks handed on and decode_batch() calls since
        # reset(): the units of the decode, chunk and batch_tokenize spans
        # (a picture's is stats["pictures"])
        self._n_decodes = 0
        self._n_chunks = 0
        self._n_batches = 0
        # Summed since reset(), host seconds on time.time_ns() unless
        # said; each timed interval is also the span named beside it
        # (runtime/spans.py) while self.spans records:
        # - pictures, bad_slices: pictures tokenized, slices dropped
        #   (on_error="drop_slice");
        # - tokenize_s: the tokenizer's call (span tokenize, caller);
        # - fill_s: GopRecon.prepare, its waits for a slot included (span
        #   prepare: the fill thread, or the caller at gop_chunk=0);
        # - slot_wait_s: the part of fill_s spent waiting for a free
        #   staging slot and for the slot's last upload (spans slot_wait);
        # - fill_wait_s: the dispatch thread waiting for its chunk's
        #   prepare, i.e. dispatch starved (span fill_wait);
        # - chunk_wait_s: the caller waiting for the oldest of the chunks
        #   in flight, past two and at the flush (spans chunk_wait);
        # - device_s: the upload and the kernels' enqueue, then the host
        #   copy's, on the host clock with no synchronize: host time of
        #   the dispatch, not device time (span dispatch; its children
        #   upload and recon);
        # - output_s: host output's fetch of delivered frames
        #   (perf_counter; inside the deliver spans);
        # - mc_launches: the MC kernel launches its pictures took (on the
        #   CPU, the plain versions' calls in their place), every path:
        #   under mxu one a group of pictures that read no output of one
        #   another (ops/recon.py mc_groups; a decode_batch step's streams;
        #   one picture live and a band in mesh="rows"), so that pictures
        #   over mc_launches is the pictures a launch;
        # - coded_blocks: the coded 8x8 blocks the tokenizer found (each
        #   picture's n_coded_blocks), every path;
        # - coded_bytes: the bytes of the slices the tokenizer walked, each
        #   from its start code to the next start code, every path.
        # decode_batch alone (0 on the other paths):
        # - batch_tokenize_s: its tokenize-every-stream phase, the device
        #   idle (span batch_tokenize, caller);
        # - batch_steps, noop_pictures: its device steps, and the no-op
        #   pictures that padded them;
        # - batch_copy_bytes: the bytes its steps' output stack and
        #   reference picks write on the device, reckoned on the host
        #   (StreamBatchRecon.copy_bytes).
        self.stats = {"pictures": 0, "tokenize_s": 0.0, "fill_s": 0.0,
                      "device_s": 0.0, "output_s": 0.0, "bad_slices": 0,
                      "slot_wait_s": 0.0, "fill_wait_s": 0.0,
                      "chunk_wait_s": 0.0, "batch_tokenize_s": 0.0,
                      "batch_steps": 0, "noop_pictures": 0,
                      "batch_copy_bytes": 0, "mc_launches": 0,
                      "coded_blocks": 0, "coded_bytes": 0}

    # ------------------------------------------------------------------
    def _gop_recon_for(self, geom: PictureGeometry, field_support: bool,
                       size: int) -> GopRecon:
        """The recon of one geometry, metadata form, chunk size and MC
        implementation (``MP2V_MC_IMPL``, resolved as the JAX package
        resolves it: :func:`~..ops.recon.resolve_mc_impl`).  Recons of one
        geometry share the reference planes: all are ``(y, u, v)`` tuples
        of the padded sizes."""
        impl = resolve_mc_impl(None, field_support)
        key = (geom, field_support, size, impl)
        if key not in self._recons:
            recon = GopRecon(geom, size, self.device, field_support, impl)
            recon.spans = self.spans
            self._recons[key] = recon
        return self._recons[key]

    def _mesh_devices(self) -> list:
        """The devices of a row mesh or of stream shards: ``mesh_devices``
        of them, or every visible device of the decoder's type."""
        return make_mesh(self.config.mesh_devices or None,
                         device=self.device)

    def _mesh_recon_for(self, geom: PictureGeometry,
                        field_support: bool) -> RowShardedRecon:
        impl = resolve_mc_impl(None, field_support)
        key = ("rows", geom, field_support, impl)
        if key not in self._mesh_recons:
            self._mesh_recons[key] = RowShardedRecon(
                geom, self._mesh_devices(), field_support, impl)
        return self._mesh_recons[key]

    def _batch_recon_for(self, geom: PictureGeometry, field_support: bool,
                         n_streams: int, devices: list) -> StreamBatchRecon:
        impl = resolve_mc_impl(None, field_support)
        key = ("streams", geom, field_support, n_streams, len(devices), impl)
        if key not in self._mesh_recons:
            self._mesh_recons[key] = StreamBatchRecon(
                geom, devices, field_support, n_streams, impl)
        return self._mesh_recons[key]

    def _emit(self, pending: LazyFrame) -> None:
        """Queue a decoded picture for delivery.  ``pictures_pool_size``
        bounds the undelivered pictures in flight — the back-pressure the
        reference applies by blocking ``create_task`` until a ring slot
        recycles (reference: threads.cpp:161-169).  The wait is on the
        oldest frame's CUDA event, and skipped while that frame belongs to
        the chunk being routed: waiting for our own chunk would only stall
        the host behind work it has just queued."""
        self._out_fifo.append(pending)
        pool = self.config.pictures_pool_size
        if pool > 0 and len(self._out_fifo) > pool:
            oldest = self._out_fifo[0]
            ev = oldest.event
            if ev is not None and ev is not self._routing_event:
                span = self.spans.begin()
                ev.synchronize()
                self.spans.end(span, "pool_wait", oldest.picture)

    def _drain(self, keep_last: bool) -> None:
        keep = 1 if keep_last else 0
        while len(self._out_fifo) > keep:
            frame = self._out_fifo.pop(0)
            span = self.spans.begin()
            if self.config.output_host:
                t0 = time.perf_counter()
                frame._flat()
                self.stats["output_s"] += time.perf_counter() - t0
            if self.renderer is not None:
                self.renderer(frame)
            self.spans.end(span, "deliver", frame.picture)
            self._frames.append(frame)

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> List[LazyFrame]:
        span = self.spans.begin()
        self._frames = []
        self._walk(data, self._decode_picture)
        self.flush()
        self.spans.end(span, "decode", self._n_decodes)
        self._n_decodes += 1
        return self._frames

    def decode_batch(self, streams: List[bytes]) -> List[list]:
        """Decode independent streams together, a picture of each per
        device step (:class:`~..parallel.mesh.StreamBatchRecon`): the
        serving path.  Streams may differ in GOP structure and length
        (each picture type is a host flag; a shorter stream is padded with
        no-op pictures, all-uncoded B pictures that leave its references
        alone) and in geometry (one batch per geometry, in the order of
        first appearance).  Every stream is tokenized first, on at most
        ``os.cpu_count()`` threads, each stream by a tokenizer-only shell
        decoder whose fill and dispatch threads never start, with
        ``num_threads`` (by default the CPUs shared out among the streams
        tokenized at once).  Returns each stream's frames in display
        order (decode order with ``reordering=False``).

        Counted in :attr:`stats` (and recorded as spans while
        :attr:`spans` records): the tokenize phase's wall time, in which
        the device idles, as ``batch_tokenize_s`` (span
        ``batch_tokenize``, unit the call's number since ``reset()``), the
        shells' tokenizer calls as ``tokenize_s``; then each step's
        ``GopRecon.prepare`` of a picture of every stream as ``fill_s``
        (span ``prepare``, unit the step), its upload and kernel enqueue
        as ``device_s`` (span ``dispatch``); ``batch_steps`` and
        ``noop_pictures``, the steps and the no-op pictures in them; and
        ``batch_copy_bytes``, what the steps' output stack and reference
        picks write on the device."""
        if not streams:
            raise ValueError("decode_batch: no streams")
        cpus = os.cpu_count() or 1
        workers = min(len(streams), cpus)
        shell_cfg = replace(self.config, mesh=None, num_threads=(
            self.config.num_threads or max(1, cpus // workers)))

        def tokenize_one(data):
            # header state is per stream: one shell decoder each, which
            # records its tokenize spans into this decoder's
            shell = MP2VDecoder(shell_cfg)
            shell.spans = self.spans
            return shell.tokenize_stream(data), shell.stats

        t0 = time.time_ns()
        span = self.spans.begin(t0)
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="mp2v-tokenize") as ex:
            done = list(ex.map(tokenize_one, streams))
        t1 = time.time_ns()
        self.stats["batch_tokenize_s"] += (t1 - t0) / 1e9
        self.spans.end(span, "batch_tokenize", self._n_batches, t1)
        self._n_batches += 1
        seqs = [q for q, _ in done]
        for _, st in done:
            for k in ("pictures", "tokenize_s", "bad_slices",
                      "coded_blocks", "coded_bytes"):
                self.stats[k] += st[k]
        by_geom: dict = {}
        for i, q in enumerate(seqs):
            if not q:
                raise ValueError(f"decode_batch: stream {i} has no pictures")
            by_geom.setdefault(q[0][1], []).append(i)
        out: List[list] = [[] for _ in streams]
        for geom, idxs in by_geom.items():
            for i, frames in zip(idxs, self._decode_batch_group(
                    geom, [seqs[i] for i in idxs])):
                out[i] = frames
        return out

    def _decode_batch_group(self, geom: PictureGeometry, seqs) -> list:
        """One geometry's streams, a picture of each per step.  The
        streams split into ``min(S, devices)`` shards; where S does not
        divide, no-op streams pad the batch (the JAX package takes the
        largest divisor of S instead).  With host output each step's
        planes start their copy to the host as soon as its kernels are
        queued, and are read one step later."""
        field = any(bool(t.field_pred.any()) for q in seqs for t, _, _ in q)
        S = len(seqs)
        devices = self._mesh_devices()
        n = min(S, len(devices))
        n_pad = -(-S // n) * n
        sb = self._batch_recon_for(geom, field, n_pad, devices[:n])
        noop = PictureTokens.empty(geom)
        refs0 = refs1 = None
        out: List[list] = [[] for _ in range(S)]
        reorder: List[Optional[PlanesFrame]] = [None] * S
        # frames emitted and, with host output, not read yet
        emitted: List[PlanesFrame] = []

        def emit(i, frame):
            out[i].append(frame)
            emitted.append(frame)

        for step in range(max(len(q) for q in seqs)):
            toks, phs = [], []
            for i in range(n_pad):
                if i < S and step < len(seqs[i]):
                    t, _, ph = seqs[i][step]
                    toks.append(t)
                    phs.append(ph)
                else:
                    toks.append(noop)
                    phs.append(None)
            is_b = [ph is None or ph.picture_coding_type == H.PCT_B
                    for ph in phs]
            is_ip = [not b for b in is_b]
            t0 = time.time_ns()
            span = self.spans.begin(t0)
            staged = sb.transport.prepare(
                toks, [H.PCT_B if b else H.PCT_P for b in is_b], step)
            t1 = time.time_ns()
            self.stats["fill_s"] += (t1 - t0) / 1e9
            self.stats["slot_wait_s"] += sb.transport.slot_wait_ns / 1e9
            self.spans.end(span, "prepare", step, t1)
            span = self.spans.begin(t1)
            launched = sb.mc_launches
            refs0, refs1, planes = sb.dispatch(staged, is_b, is_ip, refs0,
                                               refs1)
            self.stats["mc_launches"] += sb.mc_launches - launched
            shared = (tuple(host_copy(p) for p in planes)
                      if self.config.output_host else None)
            t2 = time.time_ns()
            self.stats["device_s"] += (t2 - t1) / 1e9
            self.spans.end(span, "dispatch", step, t2)
            self.stats["batch_steps"] += 1
            self.stats["noop_pictures"] += sum(ph is None for ph in phs)
            self.stats["batch_copy_bytes"] += sb.copy_bytes(is_ip)
            if self.config.output_host:
                # earlier steps' frames, whose copies ran while this step
                # was queued
                for frame in emitted:
                    frame._fetch()
            emitted = []
            for i, ph in enumerate(phs[:S]):
                if ph is None:
                    continue
                frame = PlanesFrame(tuple(p[i] for p in planes), geom,
                                    ph.temporal_reference,
                                    ph.picture_coding_type, shared, i, step)
                if not is_b[i] and self.config.reordering:
                    if reorder[i] is not None:
                        emit(i, reorder[i])
                    reorder[i] = frame
                else:
                    emit(i, frame)
        for i, frame in enumerate(reorder):
            if frame is not None:
                emit(i, frame)
        if self.config.output_host:
            for frame in emitted:
                frame._fetch()
        return out

    def _walk(self, data: bytes, on_picture) -> None:
        """Start-code dispatch loop (reference: decoder.cpp:278-329);
        ``on_picture(data, cur)`` fires once per complete picture."""
        cur = None
        offs = [int(o) for o in scan_start_codes(data)]
        for i, off in enumerate(offs):
            code = data[off + 3]
            r_pos = (off + 4) * 8
            if code == H.USER_DATA_START_CODE:
                # capture user data verbatim (reference: decoder.cpp:194-200)
                end = offs[i + 1] if i + 1 < len(offs) else len(data)
                self.user_data.append(data[off + 4:end])
                continue
            if code == H.SEQUENCE_HEADER_CODE:
                self.seq = H.SequenceHeader.parse(H.BitReader(data, r_pos))
                # spec 6.3.11: sequence header resets downloaded matrices
                self.qmext = None
            elif code == H.EXTENSION_START_CODE:
                r = H.BitReader(data, r_pos)
                ext_id = r.read(4)
                if ext_id == H.SEQUENCE_EXTENSION_ID:
                    self.sext = H.SequenceExtension.parse(r)
                elif ext_id == H.SEQUENCE_SCALABLE_EXTENSION_ID:
                    self.sscal = H.SequenceScalableExtension.parse(r)
                elif ext_id == H.PICTURE_CODING_EXTENSION_ID and cur is not None:
                    cur["pcext"] = H.PictureCodingExtension.parse(r)
                elif ext_id == H.QUANT_MATRIX_EXTENSION_ID:
                    # persists across pictures until the next sequence header
                    self.qmext = H.QuantMatrixExtension.parse(r)
            elif code == H.GROUP_START_CODE:
                self.gop = H.GroupOfPicturesHeader.parse(H.BitReader(data, r_pos))
            elif code == H.PICTURE_START_CODE:
                if cur is not None:
                    on_picture(data, cur)
                ph = H.PictureHeader.parse(H.BitReader(data, r_pos))
                cur = {"header": ph,
                       "pcext": H.PictureCodingExtension(
                           f_code=((ph.forward_f_code,) * 2,
                                   (ph.backward_f_code,) * 2)),
                       "slices": [], "slice_bytes": 0}
            elif code in (H.SEQUENCE_END_CODE, H.SEQUENCE_ERROR_CODE):
                if cur is not None:
                    on_picture(data, cur)
                    cur = None
                break
            elif H.SLICE_START_CODE_MIN <= code <= H.SLICE_START_CODE_MAX:
                if cur is not None:
                    cur["slices"].append((r_pos, code))
                    end = offs[i + 1] if i + 1 < len(offs) else len(data)
                    cur["slice_bytes"] += end - off
        if cur is not None:
            on_picture(data, cur)

    def flush(self) -> None:
        self._flush_chunk()
        self._join_chunks()
        span = self.spans.begin()
        if self._reorder_slot is not None:
            self._emit(self._reorder_slot)
            self._reorder_slot = None
        self._drain(keep_last=False)
        self.spans.end(span, "route", self._n_chunks - 1)

    def tokenize_stream(self, data: bytes):
        """Host-only pass: parse + tokenize every picture of a stream.
        Returns [(PictureTokens, PictureGeometry, PictureHeader), ...]."""
        out = []
        self._walk(data, lambda d, cur: out.append(self._picture_tokens(d, cur)))
        return out

    def _route_frame(self, pending: LazyFrame, pct: int) -> None:
        """Display reordering (reference: decoder.cpp:346-379)."""
        if pct in (H.PCT_I, H.PCT_P) and self.config.reordering:
            if self._reorder_slot is not None:
                self._emit(self._reorder_slot)
            self._reorder_slot = pending
        else:
            self._emit(pending)

    def _recon_of(self, batch) -> GopRecon:
        """The recon of ``batch`` = [(tokens, geom, header), ...].  A chunk
        with any field-predicted MB takes the field recon (K4, or K8 under
        ``MP2V_MC_IMPL=swar``), as the JAX package's ``_flush_chunk``
        chooses; the latency path decides per picture."""
        field = any(bool(t.field_pred.any()) for t, _, _ in batch)
        return self._gop_recon_for(batch[0][1], field,
                                   self.config.gop_chunk or 1)

    def _fill_job(self, recon: GopRecon, batch, unit: int):
        """Fill-thread body: pack chunk ``unit`` into a staging slot, then
        hand its tokens back for reuse (nothing reads them after
        ``prepare``)."""
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        staged = recon.prepare([b[0] for b in batch],
                               [ph.picture_coding_type for _, _, ph in batch],
                               unit)
        self._spare_tokens.extend(t for t, _, _ in batch)
        t1 = time.time_ns()
        self.stats["fill_s"] += (t1 - t0) / 1e9
        self.stats["slot_wait_s"] += recon.slot_wait_ns / 1e9
        self.spans.end(span, "prepare", unit, t1)
        return staged

    def _disp_job(self, recon: GopRecon, fill_f, batch, unit: int,
                  first: int) -> None:
        """Dispatch-thread body: one executor thread, so chunks dispatch in
        order; it alone touches the reference list while chunks are in
        flight."""
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        staged = fill_f.result()
        t1 = time.time_ns()
        self.stats["fill_wait_s"] += (t1 - t0) / 1e9
        self.spans.end(span, "fill_wait", unit, t1)
        self._dispatch_chunk(recon, staged, batch, unit, first)

    def _dispatch_chunk(self, recon: GopRecon, staged, batch, unit: int,
                        first: int) -> None:
        """Upload and reconstruct prepared chunk ``unit``, whose first
        picture is number ``first``, then route its frames.  With host
        output on ``cuda``, the chunk's frames start their copy to pinned
        host memory as soon as its kernels are queued."""
        geom = batch[0][1]
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        # B-free chunks run the forward-only kernels
        launched = recon.mc_launches
        r0, r1, packs = recon.dispatch(
            staged, self._refs[0], self._refs[1],
            bidir=any(ph.picture_coding_type == H.PCT_B
                      for _, _, ph in batch), unit=unit)
        self.stats["mc_launches"] += recon.mc_launches - launched
        self._refs = [r0, r1]
        event = None
        if packs.is_cuda:
            event = torch.cuda.Event()
            event.record()
        host = host_copy(packs) if self.config.output_host else ChunkHost(
            packs)
        t1 = time.time_ns()
        self.stats["device_s"] += (t1 - t0) / 1e9
        self.spans.end(span, "dispatch", unit, t1)
        span = self.spans.begin()
        self._routing_event = event
        for i, (_, _, ph) in enumerate(batch):
            self._route_frame(
                LazyFrame(packs, i, geom, ph.temporal_reference,
                          ph.picture_coding_type, host, event, first + i),
                ph.picture_coding_type)
        self._routing_event = None
        # deliver everything but the newest frame
        self._drain(keep_last=True)
        self.spans.end(span, "route", unit)

    def _worker_pool(self, name: str) -> ThreadPoolExecutor:
        """One worker thread, set to the decoder's CUDA device: the kernels
        launch on their thread's current device, which a new thread does
        not inherit from the caller."""
        cuda = self.device.type == "cuda"
        return ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=name,
            initializer=torch.cuda.set_device if cuda else None,
            initargs=(self.device,) if cuda else ())

    def _flush_chunk(self) -> None:
        """Hand the collected chunk to the pipeline: the fill thread packs
        it while the dispatch thread uploads and runs the chunk before, and
        this thread goes on to tokenize the next."""
        if not self._chunk:
            return
        batch, self._chunk = self._chunk, []
        if self._fill_pool is None:
            self._fill_pool = self._worker_pool("mp2v-fill")
            self._disp_pool = self._worker_pool("mp2v-dispatch")
        recon = self._recon_of(batch)
        unit = self._n_chunks
        self._n_chunks += 1
        first = self.stats["pictures"] - len(batch)
        fill_f = self._fill_pool.submit(self._fill_job, recon, batch, unit)
        self._chunk_jobs.append(self._disp_pool.submit(
            self._disp_job, recon, fill_f, batch, unit, first))
        # at most 2 chunks in flight
        while len(self._chunk_jobs) > 2:
            self._wait_chunk()

    def _join_chunks(self) -> None:
        while self._chunk_jobs:
            self._wait_chunk()

    def _wait_chunk(self) -> None:
        """Wait for the oldest chunk in flight; a worker's exception
        surfaces here."""
        unit = self._n_chunks - len(self._chunk_jobs)
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        self._chunk_jobs.pop(0).result()
        t1 = time.time_ns()
        self.stats["chunk_wait_s"] += (t1 - t0) / 1e9
        self.spans.end(span, "chunk_wait", unit, t1)

    # ------------------------------------------------------------------
    def _picture_tokens(self, data: bytes, cur):
        """Header state + slice tokenization for one picture (everything
        host-side, no device work)."""
        if self.seq is None:
            raise ValueError("picture before sequence header")
        ph: H.PictureHeader = cur["header"]
        pcext: H.PictureCodingExtension = cur["pcext"]
        geom = PictureGeometry(
            width=self.config.width or (self.seq.horizontal_size_value
                                        | (self.sext.horizontal_size_extension << 12)),
            height=self.config.height or (self.seq.vertical_size_value
                                          | (self.sext.vertical_size_extension << 12)),
            chroma_format=self.config.chroma_format or self.sext.chroma_format,
        )
        params = PictureParams(
            picture_coding_type=ph.picture_coding_type,
            f_code=pcext.f_code,
            intra_dc_precision=pcext.intra_dc_precision,
            picture_structure=pcext.picture_structure,
            frame_pred_frame_dct=pcext.frame_pred_frame_dct,
            concealment_motion_vectors=pcext.concealment_motion_vectors,
            q_scale_type=pcext.q_scale_type,
            intra_vlc_format=pcext.intra_vlc_format,
            alternate_scan=pcext.alternate_scan,
            chroma_format=geom.chroma_format,
            vertical_size=geom.height,
            quant_matrices=H.build_quant_matrices(self.seq, self.qmext),
        )
        out = None
        while self._spare_tokens and out is None:
            out = self._spare_tokens.pop()
            if out.geom != geom:
                out = None
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        tokens = self.tokenize_picture(data, cur["slices"], params, geom,
                                       out=out)
        t1 = time.time_ns()
        unit = self.stats["pictures"]
        self.stats["pictures"] += 1
        self.stats["bad_slices"] += tokens.bad_slices
        self.stats["tokenize_s"] += (t1 - t0) / 1e9
        self.stats["coded_blocks"] += tokens.n_coded_blocks
        self.stats["coded_bytes"] += cur["slice_bytes"]
        self.spans.end(span, "tokenize", unit, t1)
        return tokens, geom, ph

    def _decode_picture(self, data: bytes, cur) -> None:
        tokens, geom, ph = self._picture_tokens(data, cur)
        if self.config.mesh == "rows":
            self._decode_picture_mesh(tokens, geom, ph)
            return
        if self.config.gop_chunk > 0:
            if self._chunk and self._chunk[0][1] != geom:
                self._flush_chunk()
            self._chunk.append((tokens, geom, ph))
            if len(self._chunk) >= self.config.gop_chunk:
                self._flush_chunk()
            return
        # latency path: one picture per chunk (GopRecon with chunk=1), on
        # this thread
        batch = [(tokens, geom, ph)]
        recon = self._recon_of(batch)
        unit = self._n_chunks
        self._n_chunks += 1
        self._dispatch_chunk(recon, self._fill_job(recon, batch, unit),
                             batch, unit, self.stats["pictures"] - 1)

    def _decode_picture_mesh(self, tokens, geom: PictureGeometry,
                             ph: H.PictureHeader) -> None:
        """Row-sharded reconstruction of one picture on the caller's
        thread: its MB rows in bands across the mesh, the joined planes the
        next picture's references.  A picture with field-predicted MBs
        takes the field recon."""
        unit = self._n_chunks
        self._n_chunks += 1
        t0 = time.time_ns()
        span = self.spans.begin(t0)
        recon = self._mesh_recon_for(geom, bool(tokens.field_pred.any()))
        pct = ph.picture_coding_type
        ip = pct in (H.PCT_I, H.PCT_P)
        ref0, ref1 = (self._refs[1], None) if ip else self._refs
        launched = recon.mc_launches
        planes = recon(tokens, ref0, ref1)
        self.stats["mc_launches"] += recon.mc_launches - launched
        if ip:
            self._refs = [self._refs[1], planes]
        t1 = time.time_ns()
        self.stats["device_s"] += (t1 - t0) / 1e9
        self.spans.end(span, "dispatch", unit, t1)
        span = self.spans.begin()
        self._route_frame(PlanesFrame(planes, geom, ph.temporal_reference,
                                      pct, picture=self.stats["pictures"] - 1),
                          pct)
        self._drain(keep_last=True)
        self.spans.end(span, "route", unit)
