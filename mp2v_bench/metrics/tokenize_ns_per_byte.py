"""tokenize_ns_per_byte (program counter): the native tokenizer's host
seconds (``MP2VDecoder.stats["tokenize_s"]``) over the slice bytes it
walked (``stats["coded_bytes"]``), both summed over the window, in ns a
stream byte: the tokenizer's speed per input byte, which compares across
content.  Nothing where the decoder has no ``coded_bytes`` counter."""


def read(w):
    if not w.stats.get("coded_bytes"):
        return None
    return w.stats["tokenize_s"] / w.stats["coded_bytes"] * 1e9
