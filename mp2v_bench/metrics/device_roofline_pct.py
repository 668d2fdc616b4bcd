"""device_roofline_pct (device trace): the least time the card needs for
the window's decode work (``roofline.py``: the bytes the work needs, from
the stream's tokens and geometry, over the card's memory rate) as a share
of the summed device time of every kernel in the trace.  Nothing without
a trace, a kernel or the card's rate."""


def read(w):
    if w.trace is None or not w.trace.kernel_s or not w.peak_bytes_per_s:
        return None
    return 100 * w.bytes_needed / w.peak_bytes_per_s / w.trace.kernel_s
