"""Production decoder: host parse/tokenize -> device reconstruction.

Counterpart of ``tiny_mp2v_dec_tpu/runtime/decoder.py`` (itself modelled on
the reference's ``mp2v_decoder_c``, reference: src/core/decoder.h:82-131,
decoder.cpp:278-329): the host walks start codes, keeps sequence/picture
state and the two-slot reference list, tokenizes each picture's slices with
the native tokenizer, and reconstructs pictures on the device through
:class:`~..ops.recon.GopRecon` — in chunks of ``gop_chunk`` pictures, or one
picture at a time (``gop_chunk=0``).  Reference planes stay on the device
between pictures; display reordering matches decoder.cpp:346-379.

Everything runs on the calling thread: prepare and dispatch of a chunk are
synchronous, and the kernels run asynchronously on the current CUDA stream.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import headers as H
from ..ops.recon import GopRecon
from ..tokenizer import get_tokenizer
from ..tokenizer.types import CHROMA_INFO, PictureGeometry, PictureParams


def scan_start_codes(data: bytes) -> np.ndarray:
    """Byte offsets of every 00 00 01 prefix (vectorized equivalent of the
    reference's SIMD scanner, src/core/start_codes_search.hpp:7-39)."""
    b = np.frombuffer(data, np.uint8)
    if len(b) < 4:
        return np.empty(0, np.int64)
    hits = (b[:-3] == 0) & (b[1:-2] == 0) & (b[2:-1] == 1)
    return np.nonzero(hits)[0]


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
    # Pallas path and no mesh, and refuses them
    use_pallas: Optional[bool] = None
    pallas_interpret: bool = False
    mesh: Optional[str] = None
    mesh_devices: int = 0
    # "raise": abort on the first malformed slice; "drop_slice": keep the
    # bad slice's parsed prefix, decode everything else, count the drops in
    # stats["bad_slices"]
    on_error: str = "raise"
    # torch device of the reconstruction: "cuda" runs the CUDA kernels and
    # raises when there is no GPU; "cpu" runs their plain versions
    device: str = "cuda"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError("mesh: multi-device decode is not "
                                      "ported yet")
        if self.use_pallas not in (None, False) or self.pallas_interpret:
            raise NotImplementedError("use_pallas / pallas_interpret select "
                                      "the JAX package's Pallas kernels")


class LazyFrame:
    """A decoded frame: row ``index`` of a chunk's ``(t, frame_bytes)``
    uint8 tensor, pulled to the host on first plane access (one transfer
    shared by the frames of a chunk)."""

    def __init__(self, packed: torch.Tensor, index: int,
                 geom: PictureGeometry, temporal_reference: int,
                 picture_coding_type: int, shared: list, event=None):
        self._packed = packed
        self._index = index
        self._geom = geom
        self._host = None
        self._shared = shared
        self.event = event          # CUDA event recorded after the chunk
        self.temporal_reference = temporal_reference
        self.picture_coding_type = picture_coding_type

    def device_buffer(self) -> torch.Tensor:
        return self._packed[self._index]

    def _flat(self) -> np.ndarray:
        if self._host is None:
            if self._shared[0] is None:
                self._shared[0] = self._packed.cpu().numpy()
            self._host = self._shared[0][self._index]
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


class MP2VDecoder:
    """Decode MPEG-2 elementary streams to YUV frames on a torch device.

    Frames are delivered to ``renderer`` (if given) and returned from
    ``decode`` in display order (or decode order with reordering off).
    """

    def __init__(self, config: Optional[DecoderConfig] = None,
                 renderer: Optional[Callable[[LazyFrame], None]] = None):
        self.config = config if config is not None else DecoderConfig()
        self.device = torch.device(self.config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DecoderConfig.device={self.config.device!r}"
                               f" but torch finds no CUDA device")
        self.renderer = renderer
        self.tokenize_picture = get_tokenizer(self.config.num_threads,
                                              self.config.on_error)
        self._recons = {}
        self.reset()

    def reset(self) -> None:
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
        self.stats = {"pictures": 0, "tokenize_s": 0.0, "fill_s": 0.0,
                      "device_s": 0.0, "output_s": 0.0, "bad_slices": 0}

    # ------------------------------------------------------------------
    def _gop_recon_for(self, geom: PictureGeometry, size: int) -> GopRecon:
        key = (geom, size)
        if key not in self._recons:
            self._recons[key] = GopRecon(geom, size, self.device)
        return self._recons[key]

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
            ev = self._out_fifo[0].event
            if ev is not None and ev is not self._routing_event:
                ev.synchronize()

    def _drain(self, keep_last: bool) -> None:
        keep = 1 if keep_last else 0
        while len(self._out_fifo) > keep:
            frame = self._out_fifo.pop(0)
            if self.config.output_host:
                t0 = time.perf_counter()
                frame._flat()
                self.stats["output_s"] += time.perf_counter() - t0
            if self.renderer is not None:
                self.renderer(frame)
            self._frames.append(frame)

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> List[LazyFrame]:
        self._frames = []
        self._walk(data, self._decode_picture)
        self.flush()
        return self._frames

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
                       "slices": []}
            elif code in (H.SEQUENCE_END_CODE, H.SEQUENCE_ERROR_CODE):
                if cur is not None:
                    on_picture(data, cur)
                    cur = None
                break
            elif H.SLICE_START_CODE_MIN <= code <= H.SLICE_START_CODE_MAX:
                if cur is not None:
                    cur["slices"].append((r_pos, code))
        if cur is not None:
            on_picture(data, cur)

    def flush(self) -> None:
        self._flush_chunk()
        if self._reorder_slot is not None:
            self._emit(self._reorder_slot)
            self._reorder_slot = None
        self._drain(keep_last=False)

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

    def _run_chunk(self, batch) -> None:
        """Prepare, upload and reconstruct one chunk of ``batch`` =
        [(tokens, geom, header), ...], then route its frames."""
        geom = batch[0][1]
        pcts = [ph.picture_coding_type for _, _, ph in batch]
        size = self.config.gop_chunk or 1
        recon = self._gop_recon_for(geom, size)
        t0 = time.perf_counter()
        staged = recon.prepare([b[0] for b in batch], pcts)
        t1 = time.perf_counter()
        # B-free chunks run the forward-only kernels
        r0, r1, packs = recon.dispatch(staged, self._refs[0], self._refs[1],
                                       bidir=H.PCT_B in pcts)
        self._refs = [r0, r1]
        event = None
        if packs.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self.stats["fill_s"] += t1 - t0
        self.stats["device_s"] += time.perf_counter() - t1
        shared: list = [None]
        self._routing_event = event
        for i, (_, _, ph) in enumerate(batch):
            self._route_frame(
                LazyFrame(packs, i, geom, ph.temporal_reference,
                          ph.picture_coding_type, shared, event),
                ph.picture_coding_type)
        self._routing_event = None
        # deliver everything but the newest frame
        self._drain(keep_last=True)

    def _flush_chunk(self) -> None:
        if self._chunk:
            batch, self._chunk = self._chunk, []
            self._run_chunk(batch)

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
        t0 = time.perf_counter()
        tokens = self.tokenize_picture(data, cur["slices"], params, geom)
        self.stats["pictures"] += 1
        self.stats["bad_slices"] += tokens.bad_slices
        self.stats["tokenize_s"] += time.perf_counter() - t0
        return tokens, geom, ph

    def _decode_picture(self, data: bytes, cur) -> None:
        tokens, geom, ph = self._picture_tokens(data, cur)
        if self.config.gop_chunk > 0:
            if self._chunk and self._chunk[0][1] != geom:
                self._flush_chunk()
            self._chunk.append((tokens, geom, ph))
            if len(self._chunk) >= self.config.gop_chunk:
                self._flush_chunk()
            return
        # latency path: one picture per chunk (GopRecon with chunk=1)
        self._run_chunk([(tokens, geom, ph)])
