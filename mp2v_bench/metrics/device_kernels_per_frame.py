"""device_kernels_per_frame (device trace): kernel launches that ran on
the device in the traced part of the window, hand-written and PyTorch's
own alike, per frame decoded there."""


def read(w):
    if w.trace is None or not w.trace_frames:
        return None
    return w.trace.kernels / w.trace_frames
