"""Natural-content MPEG-2 streams for the benchmark's configurations that
name ``"generator": "natural"``.

A frozen copy of ``tests/natural_m2v.py``'s encoder, over the frozen
reference (``..ref``) and encoder (``.encoder``), with these changes: its
``scipy`` DCT is an orthonormal 8x8 DCT-II as a float64 matrix product
(some coefficients round the other way, so its streams are its own and
not the test fixtures'); the configuration's file gives the geometry, the
picture types (``generate.picture_types``), the sequence header
(``generate.sequence_start``) and the content's knobs (``qscale_code``,
``pan`` in pixels a frame, ``noise_sigma``); each picture is made
apart, on a worker process where a pool is given; and two branches that
changed nothing are gone.

The content: textured pictures under one global pan plus sensor noise,
all drawn from the seed in the caller's process (so the stream is the
same whatever the number of workers), encoded open loop (residuals against
the source, not the reconstruction) with real transform, quantisation and
block-matching statistics.  Below, the source's own text.

The conformance/bench generator (m2v_encoder.random_picture) draws tokens
at random; this module instead *encodes* procedurally synthesized video
the way a real encoder does — float 8x8 DCT of actual pixel content,
quantization with the default matrices, block-matching motion search
against the reference frame (integer + half-pel candidate planes) — so
coefficient density, run/level distributions and motion-vector statistics
match real-encoder output.  Open-loop: decoded output need not match the
source; the stream is conformant and the golden decoder must decode it
bit-identically.

Imports numpy and the frozen encoder and reference headers only: the
workers import no torch.
"""
from __future__ import annotations

import numpy as np

from ..ref import headers as H
from ..ref.utils.bits import BitWriter
from . import encoder as E
# the coding type of each distinct picture in decode order, as every
# generator gives it
from .generate import (SEQUENCE_END, mb_size, picture_types, seed_words,
                       sequence_start)

# ISO 13818-2 default intra quantiser matrix, raster order (6.3.11)
DEFAULT_INTRA_RASTER = np.array([
    8, 16, 19, 22, 26, 27, 29, 34,
    16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38,
    22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48,
    26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69,
    27, 29, 35, 38, 46, 56, 69, 83], np.int32).reshape(8, 8)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II: ``C @ x`` transforms a column."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos(np.pi * (2 * n + 1) * k / 16) * np.sqrt(2 / 8)
    c[0] = np.sqrt(1 / 8)
    return c


DCT8 = _dct_matrix()


def display_positions(pcts) -> list:
    """The display index of each picture in decode order: an I or P
    picture shows after the B pictures that follow it in decode order."""
    pos, slot, n = [0] * len(pcts), None, 0
    for i, pct in enumerate(pcts):
        if pct == H.PCT_B:
            pos[i], n = n, n + 1
            continue
        if slot is not None:
            pos[slot], n = n, n + 1
        slot = i
    if slot is not None:
        pos[slot] = n
    return pos


def _octave_noise(rng, h, w, octaves=(32, 8, 2), amps=(90, 40, 12)):
    """Band-limited texture: bilinear-upsampled coarse noise octaves."""
    out = np.zeros((h, w), np.float32)
    for cell, amp in zip(octaves, amps):
        gh, gw = h // cell + 2, w // cell + 2
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = (np.arange(h) / cell)
        xs = (np.arange(w) / cell)
        y0 = ys.astype(np.int64)
        x0 = xs.astype(np.int64)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        a = g[y0][:, x0]
        b = g[y0][:, x0 + 1]
        c = g[y0 + 1][:, x0]
        d = g[y0 + 1][:, x0 + 1]
        out += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
    return out


def synth_frames(rng, W, Hh, n, vel=(3, 1), noise_sigma=2.0):
    """n frames of a panning textured scene + independent sensor noise.
    Returns (luma[n], u[n], v[n]) uint8 (4:2:0 chroma)."""
    mx = abs(vel[0]) * n + 32
    my = abs(vel[1]) * n + 32
    canvas = _octave_noise(rng, Hh + 2 * my, W + 2 * mx) + 128
    ys, us, vs = [], [], []
    for t in range(n):
        oy = my + vel[1] * t
        ox = mx + vel[0] * t
        y = canvas[oy:oy + Hh, ox:ox + W] + \
            rng.standard_normal((Hh, W)).astype(np.float32) * noise_sigma
        y8 = np.clip(y, 0, 255).astype(np.uint8)
        # chroma: slow field derived from the same canvas, 2x subsampled
        c = canvas[oy:oy + Hh:2, ox:ox + W:2]
        u8 = np.clip(0.5 * c + 64, 0, 255).astype(np.uint8)
        v8 = np.clip(255 - 0.4 * c - 32, 0, 255).astype(np.uint8)
        ys.append(y8)
        us.append(u8)
        vs.append(v8)
    return ys, us, vs


def _halfpel_planes(p):
    """[phase] planes: 0=int, 1=H avg, 2=V avg, 3=HV avg (MPEG rounding)."""
    a = p.astype(np.uint16)
    bpad = np.pad(a, ((0, 0), (0, 1)), mode="edge")
    cpad = np.pad(a, ((0, 1), (0, 0)), mode="edge")
    b = bpad[:, 1:]
    c = cpad[1:, :]
    d = np.pad(a, ((0, 1), (0, 1)), mode="edge")[1:, 1:]
    ab = (a + b + 1) >> 1
    ac = (a + c + 1) >> 1
    abcd = (ab + ((c + d + 1) >> 1) + 1) >> 1
    return [p, ab.astype(np.uint8), ac.astype(np.uint8),
            abcd.astype(np.uint8)]


def _mb_sads(src, pred):
    """(H, W) abs-diff -> per-MB SAD (mbh, mbw)."""
    Hh, W = src.shape
    d = np.abs(src.astype(np.int32) - pred.astype(np.int32))
    return d.reshape(Hh // 16, 16, W // 16, 16).sum(axis=(1, 3))


def _search(src, ref, offsets):
    """Block-matching over candidate (phase, dx, dy) triples.

    Returns (choice index per MB (mbh, mbw), candidate list, SAD of choice,
    SAD of zero motion).  Candidates outside a MB's legal half-pel window
    get infinite SAD."""
    Hh, W = src.shape
    mbh, mbw = Hh // 16, W // 16
    phases = _halfpel_planes(ref)
    cands = []
    sads = []
    for (dx, dy) in offsets:
        for ph in range(4):
            mvx = 2 * dx + (ph & 1)
            mvy = 2 * dy + ((ph >> 1) & 1)
            plane = phases[ph]
            shifted = np.zeros_like(plane)
            sy0, sx0 = max(dy, 0), max(dx, 0)
            ty0, tx0 = max(-dy, 0), max(-dx, 0)
            hh, ww = Hh - abs(dy), W - abs(dx)
            shifted[ty0:ty0 + hh, tx0:tx0 + ww] = \
                plane[sy0:sy0 + hh, sx0:sx0 + ww]
            sad = _mb_sads(src, shifted).astype(np.float64)
            # legality: half-pel window inside the plane per MB
            px = np.arange(mbw) * 16
            py = np.arange(mbh) * 16
            okx = (mvx >= -2 * px[None, :]) & (mvx <= 2 * (W - 16 - px))[None, :]
            oky = (mvy >= -2 * py[:, None]) & (mvy <= 2 * (Hh - 16 - py))[:, None]
            sad[~(okx & oky)] = np.inf
            cands.append((mvx, mvy, shifted))
            sads.append(sad)
    sads = np.stack(sads)           # (C, mbh, mbw)
    choice = np.argmin(sads, axis=0)
    best = np.take_along_axis(sads, choice[None], 0)[0]
    zero_idx = next(i for i, (mx, my, _) in enumerate(cands)
                    if mx == 0 and my == 0)
    return choice, cands, best, sads[zero_idx]


def _quant_blocks(plane, intra, qscale):
    """(H, W) int plane -> per-8x8-block zigzag-scanned levels + DC levels.

    Float orthonormal DCT (the MPEG-2 IDCT's exact inverse), division by
    the default quantiser matrices * quantiser_scale."""
    Hh, W = plane.shape
    blocks = plane.reshape(Hh // 8, 8, W // 8, 8).transpose(0, 2, 1, 3)
    coef = DCT8 @ blocks.astype(np.float64) @ DCT8.T
    if intra:
        wmat = DEFAULT_INTRA_RASTER.astype(np.float64)
        q = np.round(coef * 16.0 / (wmat[None, None] * qscale))
        dc = np.round(coef[:, :, 0, 0] / 8.0)
    else:
        q = np.round(coef * 16.0 / (16.0 * qscale))
        dc = None
    q = np.clip(q, -2047, 2047).astype(np.int32)
    if intra:
        q[:, :, 0, 0] = 0
    flat = q.reshape(q.shape[0], q.shape[1], 64)[:, :, ZIGZAG]
    return flat, dc


def _runs_from_scan(scanned, start):
    """Scanned coefficient vector -> [(run, level), ...] from ``start``."""
    out = []
    run = 0
    for v in scanned[start:]:
        if v == 0:
            run += 1
        else:
            out.append((run, int(v)))
            run = 0
    return out


def natural_picture(pct, src, refs, qscale_code=8, fc=3):
    """Encode one picture of real content.  src/refs: (y, u, v) frames;
    refs = (fwd, bwd) (each may be None).  Returns PictureSpec."""
    y, u, v = src
    Hh, W = y.shape
    mbh, mbw = Hh // 16, W // 16
    qscale = qscale_code * 2
    pic = E.PictureSpec(
        picture_coding_type=pct,
        f_code=((fc, fc), (fc, fc)) if pct != H.PCT_I else ((15, 15),) * 2,
        frame_pred_frame_dct=1)

    offsets = [(dx, dy) for dx in range(-6, 7, 3) for dy in range(-4, 5, 2)]
    dirs = []
    if pct != H.PCT_I:
        if refs[0] is not None:
            dirs.append(("fwd", 0, _search(y, refs[0][0], offsets)))
        if pct == H.PCT_B and refs[1] is not None:
            dirs.append(("bwd", 1, _search(y, refs[1][0], offsets)))

    # luma prediction + per-MB direction decision
    pred_y = np.zeros_like(y)
    use = np.zeros((mbh, mbw), np.int8)      # 0=intra, 1=fwd, 2=bwd
    mvs = np.zeros((mbh, mbw, 2, 2), np.int32)   # [s][xy]
    if pct != H.PCT_I:
        best_sad = np.full((mbh, mbw), np.inf)
        for name, s, (choice, cands, sad, _) in dirs:
            better = sad < best_sad
            best_sad = np.where(better, sad, best_sad)
            for r in range(mbh):
                for c in range(mbw):
                    if better[r, c]:
                        mvx, mvy, plane = cands[choice[r, c]]
                        use[r, c] = 1 + s
                        mvs[r, c, s] = (mvx, mvy)
                        pred_y[r*16:(r+1)*16, c*16:(c+1)*16] = \
                            plane[r*16:(r+1)*16, c*16:(c+1)*16]
        # poor matches become intra MBs (scene statistics: rare)
        intra_mask = best_sad > 28 * 256
        use[intra_mask] = 0

    # chroma prediction: nearest-integer shift by mv>>1 (open loop)
    def chroma_pred(comp, ref_comp_by_s):
        out = np.zeros_like(comp)
        ch, cw = comp.shape
        for r in range(mbh):
            for c in range(mbw):
                s = use[r, c] - 1
                if s < 0:
                    continue
                mvx, mvy = mvs[r, c, s]
                dx, dy = int(mvx) >> 2, int(mvy) >> 2
                y0 = min(max(r * 8 + dy, 0), ch - 8)
                x0 = min(max(c * 8 + dx, 0), cw - 8)
                out[r*8:(r+1)*8, c*8:(c+1)*8] = \
                    ref_comp_by_s[s][y0:y0+8, x0:x0+8]
        return out

    if pct == H.PCT_I:
        res_y = y.astype(np.int32)
        res_u = u.astype(np.int32)
        res_v = v.astype(np.int32)
    else:
        ref_u = (refs[0][1] if refs[0] else None,
                 refs[1][1] if refs[1] else None)
        ref_v = (refs[0][2] if refs[0] else None,
                 refs[1][2] if refs[1] else None)
        res_y = y.astype(np.int32) - pred_y.astype(np.int32)
        res_u = u.astype(np.int32) - chroma_pred(u, ref_u).astype(np.int32)
        res_v = v.astype(np.int32) - chroma_pred(v, ref_v).astype(np.int32)

    # quantize: intra MBs use the intra path on source pixels
    qy_inter, _ = _quant_blocks(res_y, False, qscale)
    qu_inter, _ = _quant_blocks(res_u, False, qscale)
    qv_inter, _ = _quant_blocks(res_v, False, qscale)
    qy_intra, dcy = _quant_blocks(y.astype(np.int32), True, qscale)
    qu_intra, dcu = _quant_blocks(u.astype(np.int32), True, qscale)
    qv_intra, dcv = _quant_blocks(v.astype(np.int32), True, qscale)

    dc_max = 255
    for row in range(mbh):
        sl = E.SliceSpec(mb_row=row, qscale_code=qscale_code)
        st = E._EncState(pic)
        pending_skip = 0
        for col in range(mbw):
            intra = pct == H.PCT_I or use[row, col] == 0
            mb = E.MBSpec()
            n_blocks = 6

            def block_runs(i):
                """(dc, acs) for bitstream block i of this MB."""
                if i < 4:
                    br, bc = row * 2 + i // 2, col * 2 + i % 2
                    q = qy_intra if intra else qy_inter
                    d = dcy
                elif i == 4:
                    br, bc = row, col
                    q = qu_intra if intra else qu_inter
                    d = dcu
                else:
                    br, bc = row, col
                    q = qv_intra if intra else qv_inter
                    d = dcv
                scanned = q[br, bc]
                acs = _runs_from_scan(scanned, 1 if intra else 0)
                if intra:
                    # B.14 ref-compat: first AC code must not start with
                    # '1' (see m2v_encoder._random_block)
                    if not acs:
                        acs = [(1, 1)]
                    elif acs[0][1] in (1, -1) and acs[0][0] == 0:
                        acs[0] = (0, 2 if acs[0][1] > 0 else -2)
                    dc = int(np.clip(d[br, bc], 0, dc_max))
                    return dc, acs
                return None, acs

            runs = {i: block_runs(i) for i in range(n_blocks)}
            coded = {i for i in runs if runs[i][1]}

            s = use[row, col] - 1 if not intra else -1
            if intra:
                mb.intra = True
                mb.cbp = (1 << n_blocks) - 1
                mb.blocks = {i: runs[i] for i in range(n_blocks)}
            else:
                mvx, mvy = int(mvs[row, col, s, 0]), int(mvs[row, col, s, 1])
                # P-frame skip: zero MV, no coefficients, mid-slice
                if (pct == H.PCT_P and not coded and mvx == 0 and mvy == 0
                        and col > 0 and col < mbw - 1):
                    pending_skip += 1
                    st.pmv[:] = 0
                    continue
                if s == 0:
                    mb.fwd = True
                else:
                    mb.bwd = True
                mb.pattern = bool(coded)
                mb.cbp = sum(1 << i for i in coded)
                mb.blocks = {i: runs[i] for i in coded}
                px = int(st.pmv[0, s, 0])
                py = int(st.pmv[0, s, 1])
                dx = E._delta_for_target(px, mvx, fc)
                dy = E._delta_for_target(py, mvy, fc)
                mb.mv_deltas[(0, s)] = (dx, dy)
                E._apply_mv_delta(st, 0, s, 0, dx, fc, False)
                E._apply_mv_delta(st, 0, s, 1, dy, fc, False)
            mb.skip_before = pending_skip
            pending_skip = 0
            # Table 7-9 bookkeeping (mirrors m2v_encoder.random_picture)
            if mb.intra:
                st.pmv[1, 0] = st.pmv[0, 0]
            elif mb.fwd:
                st.pmv[1, 0] = st.pmv[0, 0]
            elif mb.bwd:
                st.pmv[1, 1] = st.pmv[0, 1]
            if mb.intra or (pct == H.PCT_P and not mb.intra and not mb.fwd):
                st.pmv[:] = 0
            sl.macroblocks.append(mb)
        pic.slices.append(sl)
    return pic


def _default_qmext() -> H.QuantMatrixExtension:
    """Every picture loads all four quant matrices explicitly (the
    defaults): semantics unchanged, and each copy of a repeated sequence
    decodes alike."""
    intra_z = DEFAULT_INTRA_RASTER.reshape(-1)[ZIGZAG].astype(np.uint8)
    nonintra_z = np.full(64, 16, np.uint8)
    return H.QuantMatrixExtension(
        load_intra_quantiser_matrix=1, intra_quantiser_matrix=intra_z,
        load_non_intra_quantiser_matrix=1,
        non_intra_quantiser_matrix=nonintra_z,
        load_chroma_intra_quantiser_matrix=1,
        chroma_intra_quantiser_matrix=intra_z,
        load_chroma_non_intra_quantiser_matrix=1,
        chroma_non_intra_quantiser_matrix=nonintra_z)


def _picture_job(args) -> bytes:
    """One picture's bytes: its header, coding extension, quant matrices
    and slices, byte-aligned."""
    config, pct, temporal_reference, src, refs = args
    spec = natural_picture(pct, src, refs, config["qscale_code"])
    spec.temporal_reference = temporal_reference
    spec.qmext = _default_qmext()
    w = BitWriter()
    E.encode_picture(w, spec, mb_size(config)[0], config["chroma_format"],
                     config["height"])
    w.align()
    return w.getvalue()


def make_stream(config: dict, seed: int, pool=None) -> bytes:
    """The configuration's stream of ``distinct_pictures`` pictures from
    ``seed``: sequence start, the pictures, the sequence end code.  The
    frames are drawn here, in display order; each picture is encoded
    against its references (an I or P picture's forward reference the last
    I or P before it in decode order, a B picture's the two last) on
    ``pool``'s workers where given (``generate.worker_pool``)."""
    if config["chroma_format"] != H.CHROMA_420:
        raise ValueError("the natural generator makes 4:2:0 only, not "
                         f"chroma_format {config['chroma_format']}")
    W, Hh = config["width"], config["height"]
    if W % 16 or Hh % 16:
        raise ValueError(f"the natural generator codes whole macroblocks: "
                         f"{W}x{Hh} is not a multiple of 16")
    pcts = picture_types(config)
    shown = display_positions(pcts)
    rng = np.random.default_rng(seed_words(seed))
    ys, us, vs = synth_frames(rng, W, Hh, len(pcts), tuple(config["pan"]),
                              config["noise_sigma"])
    frames = [(ys[shown[i]], us[shown[i]], vs[shown[i]])
              for i in range(len(pcts))]
    jobs, anchors = [], [None, None]     # the two last I or P, oldest first
    for i, pct in enumerate(pcts):
        if pct == H.PCT_B:
            refs = tuple(frames[a] if a is not None else None
                         for a in anchors)
        else:
            refs = (frames[anchors[1]] if anchors[1] is not None else None,
                    None)
            anchors = [anchors[1], i]
        jobs.append((config, pct, shown[i], frames[i], refs))
    pics = (pool.map(_picture_job, jobs) if pool is not None
            else map(_picture_job, jobs))
    return sequence_start(config) + b"".join(pics) + SEQUENCE_END
