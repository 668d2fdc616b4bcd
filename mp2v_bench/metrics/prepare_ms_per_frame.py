"""prepare_ms_per_frame (program counter): ``GopRecon.prepare``'s host
seconds (``MP2VDecoder.stats["fill_s"]``) summed over the window, in ms
per frame decoded."""


def read(w):
    if not w.frames or not w.stats.get("pictures"):
        return None
    return w.stats["fill_s"] / w.frames * 1e3
