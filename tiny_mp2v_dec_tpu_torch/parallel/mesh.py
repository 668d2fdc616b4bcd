"""Multi-device reconstruction: device lists, row bands and stream batches.

Counterpart of ``tiny_mp2v_dec_tpu/parallel/mesh.py``.  Two ways to spread
the reconstruction over devices, both on the decoder's own kernels:

* :class:`RowShardedRecon` (latency): the MB rows of one picture split
  into equal bands, one band per device.  The reference planes are whole
  on every device, since motion vectors reach anywhere in them; the bands'
  rows are joined into whole planes on the first device, which become the
  next picture's references.
* :class:`StreamBatchRecon` (serving): N independent streams advance one
  picture per step, their stream axis split across the devices; each
  device reconstructs its streams together (under ``mxu`` one MC launch
  a step).

Both carry the tokens as the chunk path's blob (``GopRecon.prepare``, the
picture or the stream in place of the chunk's picture index), upload it
once and decode it (pairs to rows, IDCT and residual grid: the chunk
transport's three launches) once per distinct device.  Reference lists are updated on the host, which knows the picture
types.

A mesh here is a list of ``torch.device`` (:func:`make_mesh`).  Where the
JAX package's mesh takes at most the devices it has, this one repeats
them, so that n bands or n stream shards run in turn on one card or on the
CPU; the output is bit-identical either way, as every band and stream runs
the same integer kernels on the same inputs.  The JAX package's AOT
warm-up of sharded programs (``_shard_map``, ``_plane_sds``,
``compile_hook``) has no counterpart: nothing is compiled per shape here.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..ops.recon import DeviceRecon, GopRecon, on_device
from ..tokenizer.types import PictureGeometry, PictureTokens


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """``n_devices`` devices of ``device``'s type (all that are visible by
    default), taken in turn from ``device``'s index on and repeated when
    ``n_devices`` exceeds them: the one axis of a row mesh or of stream
    shards.  ``cuda`` raises when torch finds no CUDA device: no CPU
    fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: torch finds no CUDA device")
        first = dev.index or 0
        avail = [torch.device("cuda", (first + i) % count)
                 for i in range(count)]
    elif dev.type == "cpu":
        avail = [dev]
    else:
        raise ValueError(f"make_mesh: no kernels for device {dev}")
    n = len(avail) if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"make_mesh: {n} devices")
    return [avail[i % len(avail)] for i in range(n)]


def pad_geometry_rows(geom: PictureGeometry, n_shards: int) -> PictureGeometry:
    """Round the MB-row count up so that rows split evenly across
    shards."""
    mbh = -(-geom.mb_height // n_shards) * n_shards
    return PictureGeometry(width=geom.width, height=mbh * 16,
                           chroma_format=geom.chroma_format)


def pad_tokens_rows(tokens: PictureTokens,
                    geom_padded: PictureGeometry) -> PictureTokens:
    """Zero-extend the per-MB vectors to the row-padded geometry (the added
    MBs are uncoded and reconstruct to zero).  The coefficient rows stay as
    they are: block indices are ``mb * blocks_per_mb + slot`` and the added
    MBs come after the last."""
    n_old = tokens.geom.n_mb
    n_new = geom_padded.n_mb
    if n_new == n_old:
        return replace(tokens, geom=geom_padded)

    def ext(a):
        out = np.zeros((n_new,) + a.shape[1:], a.dtype)
        out[:n_old] = a
        return out

    return PictureTokens(
        geom=geom_padded, cblk=tokens.cblk, cblk_idx=tokens.cblk_idx,
        intra=ext(tokens.intra), fwd=ext(tokens.fwd), bwd=ext(tokens.bwd),
        field_pred=ext(tokens.field_pred), dct_type=ext(tokens.dct_type),
        mv=ext(tokens.mv), mvfs=ext(tokens.mvfs), coded=ext(tokens.coded),
        row_nnz=tokens.row_nnz, n_coded_blocks=tokens.n_coded_blocks)


class _Sharded:
    """What both sharded recons share: the devices, the transport (a
    :class:`GopRecon` of ``chunk`` pictures on the first device, whose
    inner recon is that device's reconstructor) and a reconstructor on
    each further distinct device."""

    def __init__(self, geom, devices, chunk, field_support, mc_impl,
                 use_kernels):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices")
        self.geom = geom
        self.transport = GopRecon(geom, chunk, self.devices[0],
                                  field_support, mc_impl, use_kernels)
        self.inner = self.transport.inner
        self._recons = {self.devices[0]: self.inner}
        for d in self.devices:
            if d not in self._recons:
                self._recons[d] = DeviceRecon(geom, d, field_support,
                                              self.inner.mc_impl, use_kernels)

    @property
    def mc_launches(self) -> int:
        """The MC kernel calls of every device's reconstructor."""
        return sum(r.mc_launches for r in self._recons.values())


class RowShardedRecon(_Sharded):
    """One picture reconstructed in ``len(devices)`` bands of MB rows, band
    k on ``devices[k]`` with the production kernels (window starts and
    clamps stay in whole-reference coordinates; each kernel's grid covers
    its band).  The geometry is padded to a whole number of rows per band
    as the JAX package pads it (:func:`pad_geometry_rows`), which moves the
    clamp height with it.  ``mc_impl`` and ``use_kernels`` as
    :class:`GopRecon`."""

    def __init__(self, geom: PictureGeometry, devices,
                 field_support: bool = False, mc_impl: str | None = None,
                 use_kernels: bool = True):
        n = len(devices)
        self.n_shards = n
        self.geom_in = geom
        padded = pad_geometry_rows(geom, n)
        self.mbh_local = padded.mb_height // n
        super().__init__(padded, devices, 1, field_support, mc_impl,
                         use_kernels)

    def __call__(self, tokens: PictureTokens, ref0=None, ref1=None):
        """``tokens`` predicted forward from ``ref0`` and backward from
        ``ref1`` (padded ``(y, u, v)`` planes, zero when ``None``): the
        whole padded (y, u, v) planes on the first device."""
        g = self.geom
        zero = self.inner.zero_planes()
        ref0 = zero if ref0 is None else tuple(ref0)
        ref1 = zero if ref1 is None else tuple(ref1)
        staged = self.transport.prepare([pad_tokens_rows(tokens, g)], [2])
        decoded = self.transport.upload_decode(staged, self.devices)
        # the whole references on every device (the JAX mesh's all-gather)
        refs = {d: tuple(p.to(d) for p in (*ref0, *ref1)) for d in decoded}
        n_loc = self.mbh_local * g.mb_width
        bpm = g.blocks_per_mb
        bands = []
        for k, dev in enumerate(self.devices):
            dense, meta, _ = decoded[dev]
            mb0 = k * n_loc
            with on_device(dev):
                bands.append(self._recons[dev]._recon_from_residual(
                    dense[0, mb0 * bpm:(mb0 + n_loc) * bpm],
                    meta[0, mb0:mb0 + n_loc], *refs[dev],
                    band=(k * self.mbh_local, self.mbh_local)))
        if len(bands) == 1:
            return bands[0]
        dev0 = self.devices[0]
        return tuple(torch.cat([b[c].to(dev0) for b in bands])
                     for c in range(3))


class StreamBatchRecon(_Sharded):
    """``n_streams`` independent streams (by default one per device)
    reconstructed one picture per step: stream i of shard k =
    ``i // (n_streams / len(devices))`` on ``devices[k]``.  The transport
    is a :class:`GopRecon` of ``n_streams`` pictures, the stream index in
    place of the picture index.  Reference planes are stacked
    ``(n_streams, H, W)`` uint8 tensors on the first device.  Streams with
    different GOP structures batch together: each picture type is the
    host's flag."""

    def __init__(self, geom: PictureGeometry, devices,
                 field_support: bool = False, n_streams: int = 0,
                 mc_impl: str | None = None, use_kernels: bool = True):
        n_sh = len(devices)
        self.n_streams = n_streams or n_sh
        if self.n_streams % n_sh:
            raise ValueError(f"{self.n_streams} streams do not divide "
                             f"across {n_sh} shards")
        self.s_local = self.n_streams // n_sh
        super().__init__(geom, devices, self.n_streams, field_support,
                         mc_impl, use_kernels)

    def _zero_refs(self):
        g = self.geom
        return tuple(torch.zeros((self.n_streams,) + s, dtype=torch.uint8,
                                 device=self.devices[0])
                     for s in (g.luma_padded, g.chroma_padded,
                               g.chroma_padded))

    def step(self, tokens_list, is_b, is_ip, refs0=None, refs1=None):
        """One picture of every stream.  ``is_b[i]``: stream i's picture is
        B (predicted from ``refs0[i]`` and ``refs1[i]``, its references
        untouched); ``is_ip[i]``, its complement: an I or P picture,
        predicted from ``refs1[i]``, which becomes the newest reference.
        Returns ``(refs0, refs1, (y, u, v))``, all stacked."""
        if len(tokens_list) != self.n_streams:
            raise ValueError(f"{len(tokens_list)} pictures for "
                             f"{self.n_streams} streams")
        if any(bool(b) == bool(p) for b, p in zip(is_b, is_ip)):
            raise ValueError("is_ip must be the complement of is_b")
        staged = self.transport.prepare(tokens_list,
                                        [3 if b else 2 for b in is_b])
        return self.dispatch(staged, is_b, is_ip, refs0, refs1)

    def dispatch(self, staged, is_b, is_ip, refs0=None, refs1=None):
        """The device half of :meth:`step` for a staged step: upload,
        decode the blob once per distinct device, then each device's
        streams, which read no output of one another, as one group
        (``DeviceRecon._recon_group``: one launch a device with the
        production kernels)."""
        refs0 = self._zero_refs() if refs0 is None else tuple(refs0)
        refs1 = self._zero_refs() if refs1 is None else tuple(refs1)
        decoded = self.transport.upload_decode(staged, self.devices)
        dev0 = self.devices[0]
        outs = []
        for k, dev in enumerate(self.devices):
            dense, meta, _ = decoded[dev]
            with on_device(dev):
                pictures = []
                for i in range(k * self.s_local, (k + 1) * self.s_local):
                    r0 = tuple(p[i].to(dev) for p in refs0)
                    r1 = tuple(p[i].to(dev) for p in refs1)
                    pictures.append((r0 if is_b[i] else r1, r1, dense[i],
                                     meta[i], True))
                outs += [tuple(o.to(dev0) for o in out) for out in
                         self._recons[dev]._recon_group(pictures)]
        planes = tuple(torch.stack([o[c] for o in outs]) for c in range(3))
        # the reference-list update, picked on the host
        # (reference: decoder.cpp:299-304)
        return (_pick(is_ip, refs0, refs1), _pick(is_ip, refs1, planes),
                planes)

    def copy_bytes(self, is_ip) -> int:
        """The bytes that :meth:`dispatch` of a step with these flags
        writes on the device beyond the kernels' own planes, reckoned from
        the plane shapes and the flags without reading the device: the
        stacked output planes, and both reference lists restacked where
        ``_pick`` mixes I/P with B streams."""
        g = self.geom
        stack = self.n_streams * sum(
            h * w for h, w in (g.luma_padded, g.chroma_padded,
                               g.chroma_padded))
        mixed = any(is_ip) and not all(is_ip)
        return stack * (3 if mixed else 1)

    def __call__(self, tokens_list, refs0=None, refs1=None):
        """One picture of every stream, B-coded: forward prediction from
        ``refs0``, backward from ``refs1``; the reference lists are not
        advanced.  Returns the stacked (y, u, v) planes."""
        n = len(tokens_list)
        return self.step(tokens_list, [True] * n, [False] * n, refs0,
                         refs1)[2]


def _pick(flags, a, b):
    """Stacked planes: stream i's from ``b`` where ``flags[i]``, else from
    ``a``."""
    if not any(flags):
        return a
    if all(flags):
        return b
    return tuple(torch.stack([y[i] if f else x[i]
                              for i, f in enumerate(flags)])
                 for x, y in zip(a, b))

