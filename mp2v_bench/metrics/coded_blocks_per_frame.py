"""coded_blocks_per_frame (program counter): the coded 8x8 blocks the
tokenizer found (``MP2VDecoder.stats["coded_blocks"]``, the sum of each
picture's ``n_coded_blocks``) summed over the window, per frame decoded:
the chunk transport's transform load.  Nothing where the decoder has no
such counter."""


def read(w):
    if not w.frames or "coded_blocks" not in w.stats:
        return None
    return w.stats["coded_blocks"] / w.frames
