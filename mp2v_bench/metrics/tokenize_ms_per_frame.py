"""tokenize_ms_per_frame (program counter): the native tokenizer's host
seconds (``MP2VDecoder.stats["tokenize_s"]``) summed over the window, in
ms per frame decoded."""


def read(w):
    if not w.frames or not w.stats.get("pictures"):
        return None
    return w.stats["tokenize_s"] / w.frames * 1e3
