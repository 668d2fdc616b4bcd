"""Inputs of the blocks form of the MC kernels
(``mc_fused.fused_mc_recon_blocks`` and ``fused_mc_recon_uv_blocks``),
shared by the CPU tests, the card's tests and ``chip_smoke.py``: a
picture's reference planes, its residual block grid and its metadata rows
as the chunk blob carries them (``ops/recon.pack_meta2``); and a model of
what the kernel's threads compute.  numpy and the port only, so that the
card's tests can import it."""
import numpy as np

from tiny_mp2v_dec_tpu_torch.tokenizer.types import CHROMA_INFO


def blocks_case(rng, cf, field, mbw, mbh, edge_share=0.25):
    """One picture of ``mbw`` x ``mbh`` MBs in chroma format ``cf``:
    ``(refs0, refs1, dense, meta)``, the references (Y, U, V) uint8 triples
    of the whole picture, ``dense`` its (n_mb * blocks_per_mb, 64) int16
    residual grid (values over the decoder's range, a few at int16's ends),
    ``meta`` its (n_mb, 5) int16 rows, or (n_mb, 9) with ``field`` (field
    prediction on about half the MBs, selects of both parities).  Flags
    drawn per MB: dct_type (about 40%), forward, backward, coded (about 85%:
    some MBs uncoded).  MVs are half-pel in [-64, 64), except on an
    ``edge_share`` of the MBs, whose components are drawn from far past
    every edge of the plane, so that their windows clamp at each of them."""
    xs, ys, n_cb = CHROMA_INFO[cf]
    n = mbw * mbh
    bpm = 4 + 2 * n_cb
    H, W = 16 * mbh, 16 * mbw

    def planes():
        return tuple(rng.integers(0, 256, s).astype(np.uint8)
                     for s in ((H, W), (H >> ys, W >> xs), (H >> ys, W >> xs)))

    refs0, refs1 = planes(), planes()
    dense = rng.integers(-300, 300, (n * bpm, 64)).astype(np.int16)
    ends = rng.random(dense.shape) < 0.002
    dense[ends] = rng.choice(np.array([-32768, 32767], np.int16),
                             int(ends.sum()))
    flags = ((rng.random(n) < 0.4).astype(np.int16)
             | (rng.random(n) < 0.75).astype(np.int16) << 1
             | (rng.random(n) < 0.55).astype(np.int16) << 2
             | (rng.random(n) < 0.85).astype(np.int16) << 4)
    cols = 9 if field else 5
    mv = rng.integers(-64, 64, (n, cols - 1)).astype(np.int16)
    far = rng.random(n) < edge_share
    mv[far] = rng.choice(np.array([-2048, -2 * H - 3, 2 * W + 1, 2047],
                                  np.int16), (int(far.sum()), cols - 1))
    if field:
        flags |= (rng.random(n) < 0.5).astype(np.int16) << 3
        flags |= (rng.integers(0, 16, n).astype(np.int16) << 5)
    meta = np.concatenate([flags[:, None], mv], axis=1)
    return refs0, refs1, dense, np.ascontiguousarray(meta)


def kernel_model(refs0, refs1, dense, meta, cf, mbw, mb0=0, bidir=True,
                 uv=False):
    """What the blocks form's threads compute (``csrc/mc_recon.cu``, the
    segment kernel behind ``BlockFront``), written out thread by thread in
    numpy: for each plane, tile row ``ty`` and 8-pixel segment ``seg``,
    vectorized over the MBs, the mode from the flags, the residual row
    from the block grid, and per direction the window the front end derives
    — position from the MB's index (plus ``mb0``), the MV shifted to the
    component, the clamped start and phase, or a field unit's — then the
    half-pel taps (0 past the plane), the bidir average, the residual add
    and clip, and 0 for uncoded MBs.  ``refs0``/``refs1``: one plane
    (luma) or the (U, V) pair with ``uv``; returns the output planes."""
    field = meta.shape[1] == 9
    xs, ys, n_cb = CHROMA_INFO[cf]
    if not uv:
        xs = ys = 0
    th, tw = (16 >> ys, 16 >> xs)
    segs, ncb = tw // 8, (th // 8) * (tw // 8)
    n = meta.shape[0]
    bpm = 4 + 2 * n_cb
    Hr, Wr = refs0[0].shape
    m = meta.astype(np.int64)
    flags = m[:, 0]
    mode = ((flags >> 1) & 3) | ((flags >> 2) & 4) | (flags & 8)
    i = np.arange(n)
    g = mb0 + i
    mby = g // mbw
    py, px = (mby * 16) >> ys, ((g - mby * mbw) * 16) >> xs
    inter = (th == 16) & ((flags & 1) != 0)

    def window(s, ty):
        mvx, mvy = m[:, 1 + 2 * s] >> xs, m[:, 2 + 2 * s] >> ys
        y = np.clip(py + (mvy >> 1), 0, Hr - th) + ty
        sx = np.clip(px + (mvx >> 1), 0, Wr - tw)
        ph = (mvx & 1) + 2 * (mvy & 1)
        vs = np.ones(n, np.int64)
        if field:
            r = ty & 1
            fx = m[:, 1 + 4 * r + 2 * s] >> xs
            fy = m[:, 2 + 4 * r + 2 * s] >> ys
            sel = (flags >> (5 + 2 * r + s)) & 1
            syf = np.clip((py >> 1) + (fy >> 1), 0, (Hr >> 1) - th // 2)
            fld = (mode & 8) != 0
            y = np.where(fld, 2 * syf + sel - r + ty, y)
            sx = np.where(fld, np.clip(px + (fx >> 1), 0, Wr - tw), sx)
            ph = np.where(fld, (fx & 1) + 2 * (fy & 1), ph)
            vs = np.where(fld, 2, vs)
        return y, sx, ph, vs

    def pred(ref, y, sx, ph, vs, seg):
        cols = sx[:, None] + seg * 8 + np.arange(9)

        def taps(rows):
            ok = (rows[:, None] < Hr) & (cols < Wr)
            return np.where(ok, ref[np.minimum(rows, Hr - 1)[:, None],
                                    np.minimum(cols, Wr - 1)], 0).astype(
                np.int64)

        top, bot = taps(y), taps(y + vs)
        a, b = top[:, :8], top[:, 1:]
        c, d = bot[:, :8], bot[:, 1:]
        hx, hy = (ph & 1)[:, None] != 0, (ph & 2)[:, None] != 0
        ab, cd = (a + b + 1) >> 1, (c + d + 1) >> 1
        return np.where(hx & hy, (ab + cd + 1) >> 1,
                        np.where(hx, ab, np.where(hy, (a + c + 1) >> 1, a)))

    outs = []
    for pl in range(len(refs0)):
        out = np.zeros((n // mbw * th, mbw * tw), np.uint8)
        base = 0 if not uv else (4 + ncb if pl else 4)
        for ty in range(th):
            for seg in range(segs):
                blk = base + np.where(inter, ty & 1, ty >> 3) * segs + seg
                row = np.where(inter, ty >> 1, ty & 7)
                res = dense.astype(np.int64).reshape(-1, 8, 8)[
                    i * bpm + blk, row]
                f = (mode & 1) != 0
                b = bidir & ((mode & 2) != 0)
                p = np.zeros((n, 8), np.int64)
                pf = pred(refs0[pl], *window(0, ty), seg)
                pb = pred(refs1[pl], *window(1, ty), seg)
                p = np.where(f[:, None], pf, p)
                p = np.where(b[:, None], np.where(f[:, None],
                                                  (pf + pb + 1) >> 1, pb), p)
                val = np.clip(p + res, 0, 255)
                val = np.where(((mode & 4) != 0)[:, None], val, 0)
                rows = (i // mbw) * th + ty
                cols = (i % mbw) * tw + seg * 8
                for k in range(8):
                    out[rows, cols + k] = val[:, k]
        outs.append(out)
    return outs


def group_model(pictures, cf, mbw, mb0=0):
    """What the grouped blocks form's grid computes (``mc_group_kernel``):
    picture after picture, its luma block range, then its U+V range, each
    the one-component launch's whole blocks; a block's picture and
    component from one division of its index; each range then what
    :func:`kernel_model` computes at the picture's own ``bidir``.  ``pictures``: ``(refs0, refs1, dense, meta, bidir)`` with
    (Y, U, V) reference triples, numpy; returns ``(y, u, v)`` a
    picture."""
    n = pictures[0][3].shape[0]
    xs, ys, _ = CHROMA_INFO[cf]

    def blocks(th, tw, planes):
        per_group = 2 if tw == 8 else 1
        threads = -(-n // per_group) * th * (tw // 8) * planes * per_group
        return -(-threads // 256)

    luma, uv = blocks(16, 16, 1), blocks(16 >> ys, 16 >> xs, 2)
    ranges = {}
    for b in range(len(pictures) * (luma + uv)):
        k, r = divmod(b, luma + uv)
        ranges.setdefault((k, r >= luma), []).append(r - luma * (r >= luma))
    out = []
    for k, (refs0, refs1, dense, meta, bidir) in enumerate(pictures):
        assert ranges[k, False] == list(range(luma))
        assert ranges[k, True] == list(range(uv))
        rest = (dense, meta, cf, mbw, mb0, bidir)
        out.append((*kernel_model(refs0[:1], refs1[:1], *rest),
                    *kernel_model(refs0[1:], refs1[1:], *rest, uv=True)))
    return out
