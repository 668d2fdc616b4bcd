"""Inputs of the chunk transport (``GopRecon._decode_blob``), shared by the
CPU tests and the card's tests: synthetic pictures' tokens (coded rows in
a random claim order, rows of every density, full rows at int16's ends,
pictures with no coded block) and the chunks they make; and a model of
what the transport kernel's three launches compute (``csrc/transport.cu``),
which the CPU tests hold against the plain version.  numpy and the port
only, so that the card's tests can import it."""
import numpy as np

from tiny_mp2v_dec_tpu_torch import headers as H
from tiny_mp2v_dec_tpu_torch.golden.idct import idct_blocks
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon
from tiny_mp2v_dec_tpu_torch.tokenizer.types import (PictureGeometry,
                                                     PictureTokens)

# int16 values at and next to the type's ends
ENDS = np.array([32767, -32768, 32766, -32767], np.int16)


def synthetic_tokens(rng, geom: PictureGeometry, coded_share: float = 0.2,
                     full_rows: int = 2) -> PictureTokens:
    """One picture's tokens: ``coded_share`` of its blocks coded, claimed
    in a random order (as slice threads claim rows), each row with a
    nonzero share of its own between 2% and 40% (at least one), values
    over the decoder's range; the first ``full_rows`` rows have all 64
    coefficients nonzero, drawn from int16's ends.  ``coded_share=0``
    gives a picture with no coded block.  Field-free metadata: the frame
    form's 5 columns."""
    tok = PictureTokens.empty(geom)
    n_rows = geom.n_mb * geom.blocks_per_mb
    k = int(n_rows * coded_share)
    tok.row_nnz = np.zeros(n_rows, np.uint8)
    tok.fwd[:] = rng.random(geom.n_mb) < 0.7
    tok.mv[:] = rng.integers(-64, 64, tok.mv.shape)
    if k == 0:
        return tok
    idx = rng.choice(n_rows, k, replace=False).astype(np.int32)
    keep = rng.random((k, 64)) < rng.uniform(0.02, 0.4, (k, 1))
    keep[np.arange(k), rng.integers(0, 64, k)] = True
    vals = rng.integers(1, 2048, (k, 64)) * rng.choice([-1, 1], (k, 64))
    rows = np.where(keep, vals, 0).astype(np.int16)
    full = min(full_rows, k)
    rows[:full] = rng.choice(ENDS, (full, 64))
    tok.cblk[:k] = rows
    tok.cblk_idx[:k] = idx
    tok.n_coded_blocks = k
    tok.row_nnz[:k] = (rows != 0).sum(1)
    tok.coded[np.unique(idx // geom.blocks_per_mb)] = True
    return tok


def synthetic_chunk(rng, geom: PictureGeometry, pictures: int,
                    empty=(), **kw):
    """``pictures`` tokens of :func:`synthetic_tokens` (those whose index
    is in ``empty`` with no coded block) and their coding types (I, then
    P and B in turn)."""
    toks = [synthetic_tokens(rng, geom,
                             **({"coded_share": 0.0} if i in empty else kw))
            for i in range(pictures)]
    pcts = [H.PCT_I] + [(H.PCT_P, H.PCT_B)[i % 2]
                        for i in range(pictures - 1)]
    return toks, pcts


def staged_blob(recon: GopRecon, tokens, pcts):
    """Prepare a chunk and take its blob out of the staging slot (the slot
    released at once): ``(blob copy, cap_pairs, cap_k)``."""
    (cap_pairs, cap_k), blob, _ = staged = recon.prepare(tokens, pcts)
    recon.mark_dispatched(staged, None)
    return blob.copy(), cap_pairs, cap_k


def transport_model(recon: GopRecon, blob: np.ndarray, cap_pairs: int,
                    cap_k: int, blkrow: np.ndarray):
    """What the transport kernel computes, launch by launch, in numpy:
    returns the grid ``(chunk, n_rows, 64)`` int16 and how many times each
    of its blocks was written.  ``blkrow``: the block -> row scratch as
    the kernel finds it (any values; the kernel never clears it).
    Launch 1: each row's block (its picture the number of pictures whose
    rows all precede it), rowblk, blkrow and each 32-row tile's nonzeros;
    launch 2: the tiles' exclusive running sum; launch 3: the CTAs of both
    kinds as the launch interleaves them, a transform CTA's rows their
    pairs gathered from the tile's first pair on, K1's transform and the
    store at the row's block, a zero CTA's blocks zeroed unless their
    blkrow entry is a row of this chunk that points back."""
    g = recon.geom
    chunk = recon.chunk
    n_rows = g.n_mb * g.blocks_per_mb
    span = chunk * n_rows
    o0, o1, o2, o3, o4 = recon._layout(cap_pairs, cap_k)[:5]
    pair_pos = blob[o0:o0 + cap_pairs].astype(np.int64)
    pair_val = blob[o1:o1 + cap_pairs * 2].view(np.int16)
    nnz = blob[o2:o2 + cap_k].astype(np.int64)
    r = np.arange(cap_k)
    # launch 1
    if recon._scat_u16:
        s = blob[o3:o3 + cap_k * 2].view(np.uint16).astype(np.int64)
        ends = np.cumsum(blob[o4:o4 + chunk * 4].view(np.int32))
        pic = np.searchsorted(ends, r, side="right")
        ok = (s != 0xFFFF) & (s < n_rows) & (pic < chunk)
        rowblk = np.where(ok, pic * n_rows + s, -1)
    else:
        s = blob[o3:o3 + cap_k * 4].view(np.int32).astype(np.int64)
        rowblk = np.where((s >= 0) & (s < span), s, -1)
    blkrow = blkrow.astype(np.int64).copy()
    live = rowblk >= 0
    blkrow[rowblk[live]] = r[live]
    n_tiles = -(-cap_k // 32)
    padded = np.zeros(n_tiles * 32, np.int64)
    padded[:cap_k] = nnz
    tiles = padded.reshape(n_tiles, 32).sum(1)
    # launch 2
    tile_off = np.cumsum(tiles) - tiles
    # launch 3: the CTAs' kinds, each tile and each zero run once
    n_zero = -(-span // 256)
    n_ctas = n_tiles + n_zero
    i = np.arange(n_ctas)
    c = i * n_tiles // n_ctas
    transform = (i + 1) * n_tiles // n_ctas > c
    assert np.array_equal(c[transform], np.arange(n_tiles))
    assert np.array_equal((i - c)[~transform], np.arange(n_zero))
    within = (np.cumsum(padded.reshape(n_tiles, 32), 1)
              - padded.reshape(n_tiles, 32)).reshape(-1)[:cap_k]
    first = tile_off[r // 32] + within
    owner = np.repeat(r, nnz)
    p = np.repeat(first, nnz) + (np.arange(len(owner))
                                 - np.repeat(np.cumsum(nnz) - nnz, nnz))
    use = (p < cap_pairs) & live[owner]
    owner, p = owner[use], p[use]
    use = pair_pos[p] < 64
    coef = np.zeros((cap_k, 64), np.int16)
    coef[owner[use], pair_pos[p[use]]] = pair_val[p[use]]
    grid = np.full((span, 64), 0x5A5A, np.int16)   # torch.empty's garbage
    writes = np.zeros(span, np.int64)
    res = idct_blocks(coef[live]).reshape(-1, 64)
    grid[rowblk[live]] = res
    np.add.at(writes, rowblk[live], 1)
    b = np.arange(span)
    back = blkrow[b]
    inr = (back >= 0) & (back < cap_k)
    coded = inr & (rowblk[np.where(inr, back, 0)] == b)
    grid[~coded] = 0
    writes[~coded] += 1
    return grid.reshape(chunk, n_rows, 64), writes
