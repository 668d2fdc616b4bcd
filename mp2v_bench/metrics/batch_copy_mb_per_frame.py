"""batch_copy_mb_per_frame (program counter): the bytes that
``decode_batch``'s output stack and reference picks write on the device
(``MP2VDecoder.stats["batch_copy_bytes"]``, reckoned on the host from
the plane shapes and each step's picture types), summed over the window,
in MB (10**6 bytes) per frame decoded.  Nothing where the decoder has no
such counter."""


def read(w):
    if not w.frames or "batch_copy_bytes" not in w.stats:
        return None
    return w.stats["batch_copy_bytes"] / w.frames / 1e6
