"""Multi-host backend: ``torch.distributed`` + a ('host', 'chip') grid.

Counterpart of ``tiny_mp2v_dec_tpu/parallel/distributed.py``.  Across hosts
the reference's picture-dependency DAG (reference:
src/core/threads.cpp:100-159) factors into independent closed GOPs
(:func:`.hosts.split_gops`), so no reference plane ever crosses hosts:
each rank decodes its assigned GOPs on its own devices and only
display-order bookkeeping is shared.  Inside a rank the decoder uses its
normal paths (GOP chunks, ``mesh="rows"``, ``decode_batch``).

The process group's backend is ``gloo`` by default: the decoder moves no
tensor between ranks (only chunk indices and frames cross, and those go
through the caller), and NCCL cannot put two ranks on one card, as the
smoke run and a simulation on one GPU do.

:class:`.hosts.MultiHostDecoder` stays the in-process simulation harness
(worker processes, core pinning); this module is the skeleton of a real
deployment: rank-derived GOP assignment and rank-local frame delivery.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .hosts import split_gops


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo") -> None:
    """Join this process to the ``torch.distributed`` world.

    Pass all three of ``coordinator_address`` (``"host0:port"``, rank 0's
    TCP store), ``num_processes`` (the world size) and ``process_id`` (this
    rank), or none: then the ``env://`` variables that ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) say them."""
    import torch.distributed as dist
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        dist.init_process_group(backend, init_method="env://")
        return
    if any(v is None for v in given):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together, or none of them")
    dist.init_process_group(backend,
                            init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)


@dataclass
class HostChipMesh:
    """The world's devices as a ``(world, per_host)`` numpy object array
    of ``torch.device`` (row r: rank r's local devices) and the names of
    its two axes."""
    devices: np.ndarray
    axis_names: Tuple[str, str]

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


def host_chip_mesh(axes=("host", "chip"), device: str = "cuda"
                   ) -> HostChipMesh:
    """The global ('host', 'chip') grid: rows are ranks, columns that
    rank's local devices of type ``device`` (every visible CUDA device, or
    the one CPU).  Each rank's count is gathered from all (a collective:
    every rank calls this), and all must be equal.  No
    ``torch.distributed.DeviceMesh``: on ``cuda`` it wants one NCCL rank
    per GPU."""
    import torch
    import torch.distributed as dist
    local = torch.cuda.device_count() if device == "cuda" else 1
    if local == 0:
        raise RuntimeError(f"host_chip_mesh(device={device!r}): torch "
                           f"finds no CUDA device")
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    if len(set(counts)) != 1:
        raise ValueError(f"ranks hold unequal device counts {counts}")
    grid = np.empty((len(counts), local), dtype=object)
    for r in range(len(counts)):
        for c in range(local):
            grid[r, c] = (torch.device("cuda", c) if device == "cuda"
                          else torch.device(device))
    return HostChipMesh(grid, tuple(axes))


class DistributedDecoder:
    """Rank r of a ``torch.distributed`` world decoding one elementary
    stream: GOP chunk i belongs to rank (i mod world).  ``decode`` returns
    this rank's frames as (chunk_index, [frame bytes...]) pairs — frames
    stay rank-local (the serving pattern: each host feeds its own
    downstream consumers); a display-order merge across ranks is a
    metadata-only exchange (chunk index -> rank is deterministic, so every
    rank already knows the global order).  The default config is
    ``DecoderConfig()``, on the card."""

    def __init__(self, config=None, decoder_cls=None):
        import torch.distributed as dist
        from ..runtime.decoder import DecoderConfig, MP2VDecoder
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        cls = decoder_cls or MP2VDecoder
        self.dec = cls(config or DecoderConfig())

    def my_chunks(self, data: bytes):
        return [c for c in split_gops(data) if c.index % self.world == self.rank]

    def decode(self, data: bytes) -> List[tuple]:
        out = []
        for c in self.my_chunks(data):
            self.dec.reset()
            frames = self.dec.decode(c.data)
            out.append((c.index, [f.tobytes() for f in frames]))
        return out


def merge_display_order(per_host_results: List[List[tuple]]) -> List[bytes]:
    """Deterministic display-order merge of every host's (chunk_index,
    frames) pairs (chunk indices are globally unique and ordered)."""
    by_index = {}
    for host in per_host_results:
        for idx, frames in host:
            by_index[idx] = frames
    out: List[bytes] = []
    for idx in sorted(by_index):
        out.extend(by_index[idx])
    return out
