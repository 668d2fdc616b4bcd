"""kernel_us_per_frame (end to end, device trace): the summed device time
of every kernel that ran in the traced part of the window (hand-written
and PyTorch's alike; copies and memsets are left out) over the frames
decoded in that part: the card time one frame of the cell's stream costs
in kernels.  Nothing without a trace, a kernel or a frame."""


def read(w):
    if w.trace is None or not w.trace.kernel_s or not w.trace_frames:
        return None
    return 1e6 * w.trace.kernel_s / w.trace_frames
