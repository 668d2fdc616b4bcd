"""batch_tokenize_ms_per_frame (program counter): the wall time of
``decode_batch``'s phase that tokenizes every stream before the first
device step, the device idle (``MP2VDecoder.stats["batch_tokenize_s"]``),
summed over the window, in ms per frame decoded.  Nothing where the
decoder has no such counter."""


def read(w):
    if not w.frames or "batch_tokenize_s" not in w.stats:
        return None
    return w.stats["batch_tokenize_s"] / w.frames * 1e3
