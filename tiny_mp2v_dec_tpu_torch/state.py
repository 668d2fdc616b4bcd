"""Carrying decoder state into the port.

This system has no weights: its only device state is the pair of reference
pictures ``[r0, r1]`` (older, newer) a decode carries from one picture or
chunk to the next.  Each is ``None`` (no reference yet) or a ``(y, u, v)``
tuple of uint8 planes of the geometry's padded sizes, in the same layout in
both packages.  So a decode started elsewhere — for example by the JAX
package, whose ``MP2VDecoder._refs`` planes convert with ``np.asarray`` —
can be handed over mid-stream.
"""
from __future__ import annotations

import numpy as np
import torch


def refs_from_numpy(refs, device):
    """``[r0, r1]`` reference pictures as numpy planes -> the port's list of
    ``(y, u, v)`` tuples of contiguous uint8 tensors on ``device``
    (``None`` entries stay ``None``)."""
    return [None if planes is None else tuple(
        torch.from_numpy(np.array(p, dtype=np.uint8, order="C")).to(device)
        for p in planes) for planes in refs]
