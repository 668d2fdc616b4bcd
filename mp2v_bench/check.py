"""Whether the frames the window produced are the reference's, byte for
byte: the configuration's guarantee (output identical to a conforming
decode).  The frames are compared where they lie, on the device, with the
reference's frames copied there once the window has closed.

One number, with its limit: ``mismatched_bytes``, the bytes of the due
frames that differ from the reference's.  A frame that never came, or one
of the wrong size, counts whole, and so does a frame that should not have
come.  The comparison is exact: the limit is 0.
"""
from __future__ import annotations

from collections import Counter

LIMITS = {"mismatched_bytes": 0}


class Comparison:
    """Frames held against reference rows, one set of rows a channel."""

    def __init__(self, *refs):
        self.refs = refs                # (n, frame bytes) uint8 tensors
        self.bad = 0
        self.frames = 0
        self.failed = 0                 # frames missing or not equal
        self.missing = 0
        self.bad_by_channel = Counter()

    def frames_against(self, frames, rows, channel: int = 0) -> None:
        """Hold ``frames`` (the port's frames, each with its
        ``device_buffer()``) against rows ``rows`` of ``channel``'s
        reference, in order."""
        import torch
        ref = self.refs[channel]
        width = ref.shape[1]
        bad = 0
        missing = max(0, len(rows) - len(frames))
        self.missing += missing
        self.failed += missing
        bad += missing * width
        for k, frame in enumerate(frames):
            buf = frame.device_buffer().reshape(-1)
            self.frames += 1
            if k >= len(rows) or buf.numel() != width:
                bad += max(buf.numel(), width)
                self.failed += 1
                continue
            diff = int(torch.count_nonzero(buf != ref[rows[k]]))
            bad += diff
            self.failed += int(diff > 0)
        self.bad += bad
        self.bad_by_channel[channel] += bad

    def numbers(self) -> dict:
        return {"mismatched_bytes": self.bad}


def closed_loop(kept, ref_display, per_decode: int, device) -> Comparison:
    """The sampled decodes of a closed loop (``drive.Reservoir.kept``):
    each is ``per_decode`` frames, the reference's frames in display order
    over and over."""
    import torch
    c = Comparison(torch.from_numpy(ref_display).to(device))
    n = len(ref_display)
    rows = [j % n for j in range(per_decode)]
    for _, frames in sorted(kept.items()):
        c.frames_against(frames, rows)
    return c


def open_loop(kept, ref_decode, device) -> Comparison:
    """The sampled pictures of an open loop (``drive.Reservoir.kept``:
    picture -> (decode index, its frames)): one frame each, the
    reference's picture of that index."""
    import torch
    c = Comparison(torch.from_numpy(ref_decode).to(device))
    for _, (index, frames) in sorted(kept.items()):
        c.frames_against(frames, [index])
    return c


def correct(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
