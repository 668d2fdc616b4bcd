"""dispatch_ms_per_frame (program counter): the upload's and the kernel
enqueue's host seconds (``MP2VDecoder.stats["device_s"]``, timed on the
host with no synchronize: the dispatch layer's host time, not device
time) summed over the window, in ms per frame decoded."""


def read(w):
    if not w.frames or not w.stats.get("pictures"):
        return None
    return w.stats["device_s"] / w.frames * 1e3
