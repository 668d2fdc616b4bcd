"""PyTorch port, the formulation the segment kernels K2, K3 and K4 rest
on.

The kernels predict in packed 32-bit words (four pixels each: funnel-shift
taps and per-byte rounding averages, the function of
``fused_mc_pred_swar_ref``, or with field motion of
``fused_mc_pred_swar_field_ref``, which is K8's) and then run an epilogue
on the words: the int16 residual read as 32-bit pairs, added per pixel in
32-bit arithmetic, clipped to [0, 255], zero for uncoded MBs, bytes packed
back into words.  Here that chain, on the CPU at a small size, equals the
unpacked plain versions ``fused_mc_recon_ref`` / ``fused_mc_recon_uv_ref``
at every tile and on every input kind of ``test_torch_gpu._mc_case`` (edge
windows, every ``sx & 3``, every mode, extreme residuals, one-MB planes;
with the field tuples also field units at the edges and at C_1 = -1, every
``sx_r & 3`` at every phase, every MB field-predicted).  The plain
versions are held against the JAX package's Pallas kernels in
``test_torch_mc.py`` and ``test_torch_mc_swar.py``.  Then K5's and K6's
lane schemes (which lane loads which aligned word of a window, what the
warp shuffles deliver: K5 one warp per luma MB, K6 at every chroma tile,
two MBs per warp at 8x8) modelled lane by lane, and the wrappers'
alignment checks, which run before any launch."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gpu import FIELD_KINDS, MC_KINDS, _mc_case  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402

# (tile rows, columns), planes per call: K2 luma, K3 at each chroma tile
TILES = [((16, 16), 1), ((8, 8), 2), ((16, 8), 2), ((16, 16), 2)]
MBH, MBW = 4, 5                       # MBs per plane (one_mb: 1 x 1)


def _epilogue(words, res, mode, h, w):
    """The kernels' epilogue on one (H, W) plane: ``words`` the (H, W/4)
    int32 prediction, ``res`` the int16 residual, ``mode`` per MB.
    Returns the (H, W) uint8 plane."""
    H, W = res.shape
    pairs = res.contiguous().view(torch.int32)    # pixel 2j in the low half
    lo = ((pairs & 0xFFFF) ^ 0x8000) - 0x8000     # sign-extended low half
    r = torch.stack([lo, pairs >> 16], dim=-1).reshape(H, W)
    wd = words.to(torch.int64) & 0xFFFFFFFF
    pred = torch.stack([(wd >> (8 * k)) & 0xFF for k in range(4)],
                       dim=-1).reshape(H, W)
    val = torch.clamp(pred + r, 0, 255)
    coded = ((mode & 4) != 0).reshape(H // h, 1, W // w, 1).expand(
        H // h, h, W // w, w).reshape(H, W)
    val = torch.where(coded, val, 0).reshape(H, W // 4, 4)
    packed = sum(val[..., k] << (8 * k) for k in range(4))
    return mc_fused.unpack_words(mc_fused.words_to_int32(packed))


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
@pytest.mark.parametrize("tile,planes", TILES)
def test_word_prediction_and_epilogue_equal_the_recon(tile, planes, kind,
                                                      bidir):
    h, w = tile
    r0, r1, res, meta = _mc_case("cpu", 70 + h + w + planes, MBH * h,
                                 MBW * w, tile, planes, kind=kind)
    if planes == 1:
        want = (mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                            h=h, w=w, bidir=bidir),)
    else:
        want = mc_fused.fused_mc_recon_uv_ref(tuple(r0), tuple(r1),
                                              tuple(res), *meta, h=h, w=w,
                                              bidir=bidir)
    for k in range(planes):
        words = mc_fused.fused_mc_pred_swar_ref(r0[k], r1[k], *meta, h=h,
                                                w=w, bidir=bidir)
        assert torch.equal(_epilogue(words, res[k], meta[6], h, w), want[k])


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS + FIELD_KINDS)
@pytest.mark.parametrize("tile,planes", TILES)
def test_field_word_prediction_and_epilogue_equal_the_recon(tile, planes,
                                                            kind, bidir):
    """K4's formulation: the field word prediction (K8's plain version)
    plus the epilogue equals the unpacked plain recon given the field
    tuples."""
    h, w = tile
    r0, r1, res, meta = _mc_case("cpu", 90 + h + w + planes, MBH * h,
                                 MBW * w, tile, planes, field=True, kind=kind)
    if planes == 1:
        want = (mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                            h=h, w=w, bidir=bidir),)
    else:
        want = mc_fused.fused_mc_recon_uv_ref(tuple(r0), tuple(r1),
                                              tuple(res), *meta, h=h, w=w,
                                              bidir=bidir)
    for k in range(planes):
        words = mc_fused.fused_mc_pred_swar_field_ref(
            r0[k], r1[k], *meta, h=h, w=w, bidir=bidir)
        assert torch.equal(_epilogue(words, res[k], meta[6], h, w), want[k])


def _tap_row2(w0, w1, w2, s, ph):
    """``tap_row2`` (csrc/swar_word.cuh) on int64 words: the two prediction
    words of one tap row from its three aligned words at bit offset ``s``,
    averaged with the taps one pixel to the right where the phase ``ph``
    (per lane, or one for all) has bit 0."""
    p = [mc_fused._funnel(w0, w1, s), mc_fused._funnel(w1, w2, s)]
    q = [mc_fused._funnel(w0, w1, s + 8), mc_fused._funnel(w1, w2, s + 8)]
    hx = torch.as_tensor((ph & 1) != 0)
    return [torch.where(hx, mc_fused.avg_up(a, b), a) for a, b in zip(p, q)]


def _k5_direction(words, sy, sx, ph):
    """K5's lane scheme (``roll_pred``, csrc/mc_roll.cu) for one direction
    of one luma MB: the 32 lanes' two prediction words, (32, 2) int64, from
    ``words``, the reference's aligned words with the zero pad in place.
    Lane 2*ty + seg holds segment ``seg`` of tile row ``ty``.  Each load is
    logged; the log must hold every word of the window — 16 rows, 17 under
    a vertical half-pel phase, by the 5 word columns from ``sx >> 2`` —
    exactly once."""
    lane = torch.arange(32)
    ty, seg = lane >> 1, lane & 1
    y, x = sy + ty, (sx >> 2) + 3 * seg
    s = torch.full((32,), (sx & 3) << 3)
    vert = bool(ph & 2)
    loads = []

    def load(rows, cols, lanes):
        """The words at (rows, cols) on the lanes of the mask, 0 on the
        others, which make no load."""
        loads.extend(zip(rows[lanes].tolist(), cols[lanes].tolist()))
        return torch.where(lanes, words[torch.where(lanes, rows, 0),
                                        torch.where(lanes, cols, 0)], 0)

    everyone = torch.ones(32, dtype=torch.bool)
    a, b = load(y, x, everyone), load(y, x + 1, everyone)
    # word 2 of the row on segment 0; on lane 31 word 2 of row sy + 16
    c = load(y, x + 2, seg == 0)
    if vert:
        c = c + load(y + 1, x - 1, lane == 31)
    o = c[lane ^ 1]                                   # __shfl_xor_sync(c, 1)
    s0 = seg == 0
    w = [torch.where(s0, a, o), torch.where(s0, b, a), torch.where(s0, c, b)]

    def taps(w0, w1, w2):
        return _tap_row2(w0, w1, w2, s, ph)

    p = taps(*w)
    if vert:
        down = torch.where(lane + 2 < 32, lane + 2, lane)  # __shfl_down_sync
        last = ty == 15
        e, f = load(y + 1, x, last), load(y + 1, x + 1, last)
        below = [torch.where(s0, e, c), torch.where(s0, f, e),
                 torch.where(s0, o, f)]
        v = [torch.where(last, below[k], w[k][down]) for k in range(3)]
        p = [mc_fused.avg_up(p[k], q) for k, q in enumerate(taps(*v))]
    x0 = sx >> 2
    assert sorted(loads) == [(r, col) for r in range(sy, sy + 16 + vert)
                             for col in range(x0, x0 + 5)]
    return torch.stack(p, dim=1)


def _k5_model(r0, r1, res, meta, bidir):
    """K5 on one luma plane through :func:`_k5_direction`: a coded MB's
    lanes predict in each direction its mode uses, average the two packed,
    and the words go through the kernels' epilogue; an uncoded MB loads
    nothing."""
    H, W = res.shape
    mbw = W // 16
    vec = [m.tolist() for m in meta]
    planes = [mc_fused._swar_words(r) for r in (r0, r1)]
    out = torch.zeros((H, W // 4), dtype=torch.int64)
    for i, mode in enumerate(vec[6]):
        if not mode & 4:
            continue
        use = [bool(mode & 1), bidir and bool(mode & 2)]
        preds = [_k5_direction(planes[d],
                               *(v[i] for v in vec[3 * d:3 * d + 3]))
                 for d in range(2) if use[d]]
        if not preds:
            continue
        pred = preds[0] if len(preds) == 1 else mc_fused.avg_up(*preds)
        r, col = (i // mbw) * 16, (i % mbw) * 4
        out[r:r + 16, col:col + 4] = pred.reshape(16, 4)
    return _epilogue(mc_fused.words_to_int32(out), res, meta[6], 16, 16)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
def test_roll_luma_lane_scheme_equals_the_recon(kind, bidir):
    """K5's lane scheme equals ``fused_mc_recon_ref`` on every input kind:
    windows at the bottom and right edges (the lanes of row 15 load row
    ``sy + 16``, the zero pad), every ``sx & 3`` at every phase, modes 0-7;
    and every aligned word of a window is loaded by exactly one lane."""
    r0, r1, res, meta = _mc_case("cpu", 60, MBH * 16, MBW * 16, 16, 1,
                                 kind=kind)
    want = mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta, h=16,
                                       w=16, bidir=bidir)
    assert torch.equal(_k5_model(r0[0], r1[0], res[0], meta, bidir), want)


def _k6_direction8(words, i, pl, ty, meta, use, th):
    """K6's 8-wide lane scheme (``roll_pred8``, csrc/mc_roll.cu) for one
    direction of one warp: the 32 lanes' two prediction words, (32, 2)
    int64.  ``words``: (2, rows, columns) U and V word planes with the zero
    pad in place; per lane ``i`` its MB, ``pl`` its plane, ``ty`` its tile
    row, ``use`` whether its MB uses the direction; ``meta`` the direction's
    (sy, sx, ph) vectors.  The loads are gated by ``use``, the shuffles run
    on every lane.  Each load is logged by (plane, MB); the log of each
    plane tile that uses the direction must hold every word of its window —
    ``th`` rows, ``th + 1`` under a vertical half-pel phase, by the 3 word
    columns from ``sx >> 2`` — exactly once, and no other tile loads."""
    lane = torch.arange(32)
    safe = torch.where(use, i, 0)
    sy, sx, ph = (m[safe] for m in meta)
    y, x = sy + ty, sx >> 2
    s = (sx & 3) << 3
    vert = (ph & 2) != 0
    loads = {}

    def load(rows, cols, lanes):
        for k in lanes.nonzero().flatten().tolist():
            loads.setdefault((int(pl[k]), int(i[k])), []).append(
                (int(rows[k]), int(cols[k])))
        return torch.where(lanes, words[pl, torch.where(lanes, rows, 0),
                                        torch.where(lanes, cols, 0)], 0)

    w = [load(y, x + k, use) for k in range(3)]
    # __shfl_down_sync(w_k, 1, th): lane + 1 inside the lane's group of th
    down = torch.where(lane % th + 1 < th, lane + 1, lane)
    last = use & vert & (ty == th - 1)
    v = [torch.where(last, load(y + 1, x + k, last), w[k][down])
         for k in range(3)]
    p = _tap_row2(*w, s, ph)
    q = _tap_row2(*v, s, ph)
    p = [torch.where(vert, mc_fused.avg_up(a, b), a) for a, b in zip(p, q)]
    want = set()
    for k in use.nonzero().flatten().tolist():
        key = (int(pl[k]), int(i[k]))
        x0, y0, rows = int(x[k]), int(sy[k]), th + int(vert[k])
        if key not in want:
            want.add(key)
            assert sorted(loads.pop(key)) == [
                (r, c) for r in range(y0, y0 + rows)
                for c in range(x0, x0 + 3)]
    assert not loads
    return torch.stack(p, dim=1)


def _k6_model(r0, r1, res, meta, bidir, th, tw):
    """K6 on a U and V plane pair, lane by lane: at 16x16 a warp per plane
    tile, K5's warp (:func:`_k5_direction`); at the 8-wide tiles the lanes
    grouped as the kernel groups them — 16x8 a warp per plane of two MBs,
    8x8 U and V of two MBs in one warp — through :func:`_k6_direction8`,
    each direction run when any lane of the warp uses it.  A coded MB's
    lanes average the two packed predictions, and the words go through the
    kernels' epilogue; an uncoded MB, and the missing second MB of the last
    pair, loads nothing."""
    H, W = res[0].shape
    mbw = W // tw
    n = (H // th) * mbw
    planes = [torch.stack([mc_fused._swar_words(r) for r in refs])
              for refs in (r0, r1)]
    mode = meta[6].to(torch.int64)
    dirs = [[m.to(torch.int64) for m in meta[3 * d:3 * d + 3]]
            for d in range(2)]
    out = torch.zeros((2, H, W // 4), dtype=torch.int64)
    if tw == 16:
        for i in range(n):
            m = int(mode[i])
            use = [bool(m & 4 and m & 1), bidir and bool(m & 4 and m & 2)]
            for k in range(2):
                preds = [_k5_direction(planes[d][k],
                                       *(int(v[i]) for v in dirs[d]))
                         for d in range(2) if use[d]]
                if not preds:
                    continue
                pred = preds[0] if len(preds) == 1 else mc_fused.avg_up(
                    *preds)
                r, col = (i // mbw) * th, (i % mbw) * 4
                out[k, r:r + th, col:col + 4] = pred.reshape(th, 4)
    else:
        tpg = 4 * th                      # U and V of a pair of MBs
        for warp in range(-(-n // 2) * tpg // 32):
            t = warp * 32 + torch.arange(32)
            r = t % tpg
            i = (t // tpg) * 2 + (r // th) % 2
            pl, ty = r // (2 * th), r % th
            live = i < n
            m = torch.where(live, mode[torch.where(live, i, 0)], 0)
            coded = (m & 4) != 0
            f = coded & ((m & 1) != 0)
            b = coded & ((m & 2) != 0) & bidir
            zero = torch.zeros((32, 2), dtype=torch.int64)
            pf = (_k6_direction8(planes[0], i, pl, ty, dirs[0], f, th)
                  if bool(f.any()) else zero)
            pb = (_k6_direction8(planes[1], i, pl, ty, dirs[1], b, th)
                  if bool(b.any()) else zero)
            pred = torch.where((f & b)[:, None], mc_fused.avg_up(pf, pb),
                               torch.where(f[:, None], pf,
                                           torch.where(b[:, None], pb, 0)))
            for k in (coded & live).nonzero().flatten().tolist():
                row = (int(i[k]) // mbw) * th + int(ty[k])
                col = (int(i[k]) % mbw) * 2
                out[pl[k], row, col:col + 2] = pred[k]
    return tuple(_epilogue(mc_fused.words_to_int32(out[k]), res[k], meta[6],
                           th, tw) for k in range(2))


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
@pytest.mark.parametrize("tile", [(8, 8), (16, 8), (16, 16)])
def test_roll_uv_lane_scheme_equals_the_recon(tile, kind, bidir):
    """K6's lane scheme equals ``fused_mc_recon_uv_ref`` at every chroma
    tile on every input kind: two MBs of different modes, windows and
    phases in one warp (8-wide tiles), windows at the bottom and right
    edges (the last row's lane loads row ``sy + h``, the zero pad), every
    ``sx & 3`` at every phase, modes 0-7, one-MB planes (the pair's second
    MB missing); and every aligned word of a plane tile's window is loaded
    by exactly one lane."""
    h, w = tile
    r0, r1, res, meta = _mc_case("cpu", 64, MBH * h, MBW * w, tile, 2,
                                 kind=kind)
    want = mc_fused.fused_mc_recon_uv_ref(tuple(r0), tuple(r1), tuple(res),
                                          *meta, h=h, w=w, bidir=bidir)
    got = _k6_model(r0, r1, res, meta, bidir, h, w)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize("tile", [(16, 16), (8, 8), (16, 8)])
def test_mc_case_kinds_cover_what_they_claim(tile):
    """The input kinds reach what the kernels' tests rely on: windows at
    the bottom and right edges at every phase, every ``sx & 3`` at every
    phase, every mode, residuals at both int16 limits, one-MB planes."""
    h, w = tile
    H, W = MBH * h, MBW * w

    def case(kind):
        _, _, res, meta = _mc_case("cpu", 5, H, W, tile, 1, kind=kind)
        return res[0], [m.numpy() for m in meta]

    _, m = case("edges")
    for s in range(2):
        sy, sx, ph = m[3 * s:3 * s + 3]
        at = {(a, b, p) for a, b, p in zip(sy == H - h, sx == W - w, ph)}
        assert at >= {(e, f, p) for e, f in ((1, 0), (0, 1), (1, 1))
                      for p in range(4)}
    _, m = case("sx_phases")
    for s in range(2):
        sx, ph = m[3 * s + 1], m[3 * s + 2]
        assert set(zip(sx & 3, ph)) == {(a, p) for a in range(4)
                                       for p in range(4)}
        assert sx.min() >= 0 and sx.max() <= W - w
    assert set(case("random")[1][6]) == set(range(8))
    assert set(case("mode7")[1][6]) == {7}
    res, _ = case("extreme_residual")
    assert int(res.min()) == -32768 and int(res.max()) == 32767
    res, m = case("one_mb")
    assert res.shape == (h, w) and all(len(x) == 1 for x in m)

    def units(kind):
        """Mode and, per direction and unit r, (C_r, sx_r, ph_r)."""
        _, _, _, meta = _mc_case("cpu", 5, H, W, tile, 1, field=True,
                                 kind=kind)
        return meta[6].numpy(), [[[x.numpy() for x in meta[7 + s][3 * r:
                                                                  3 * r + 3]]
                                  for r in range(2)] for s in range(2)]

    for kind in FIELD_KINDS:
        mode, dirs = units(kind)
        assert set(mode) == {15}
        for r, (c, sx, ph) in (u for d in dirs for u in enumerate(d)):
            # a start mc_field_meta can give: C_r + r = 2*syf_r + sel_r
            assert (c + r >= 0).all() and ((c + r) >> 1).max() <= (H - h) // 2
            assert sx.min() >= 0 and sx.max() <= W - w
    mode, dirs = units("field_edges")
    for r, (c, sx, ph) in (u for d in dirs for u in enumerate(d)):
        # the second tap row of the unit's last tile row, h - 2 + r
        low = c + h - 2 + r + 2 >= H
        at = set(zip(low, sx == W - w, ph))
        assert at >= {(e, f, p) for e, f in ((1, 0), (0, 1), (1, 1))
                      for p in range(4)}
        if r == 1:
            assert set(ph[c == -1]) == set(range(4))
    mode, dirs = units("field_sx_phases")
    for (c0, sx0, ph0), (c1, sx1, ph1) in dirs:
        assert (ph0 != ph1).all()
        for sx, ph in ((sx0, ph0), (sx1, ph1)):
            assert set(zip(sx & 3, ph)) == {(a, p) for a in range(4)
                                           for p in range(4)}
    _, _, _, meta = _mc_case("cpu", 5, H, W, tile, 1, field=True)
    assert set(meta[6].numpy() >> 3) == {0, 1}


def _recon_args(entry, fault):
    """Arguments of ``_launch`` for K2 or K4 (luma) or K3 or K4 (U+V) on
    CPU tensors, with one input misaligned as ``fault`` says."""
    uv = entry.endswith("_uv")
    h = w = 8 if uv else 16
    H = W = 32
    ref = torch.zeros((H, W), dtype=torch.uint8)
    res = torch.zeros((H, W), dtype=torch.int16)
    if fault == "residual":
        res = torch.zeros(H * W + 1, dtype=torch.int16)[1:].view(H, W)
    elif fault == "reference":
        ref = torch.zeros(H * W + 1, dtype=torch.uint8)[1:].view(H, W)
    else:                             # a reference width not divisible by 4
        ref = torch.zeros((H, W + 2), dtype=torch.uint8)
    n = (H // h) * (W // w)
    n_meta = 19 if "field" in entry else 7    # field tuples of both dirs
    meta = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(n_meta))
    k = 2 if uv else 1
    return ((ref,) * k, (ref,) * k, (res,) * k, meta, h, w)


@pytest.mark.parametrize("fault,match", [("residual", "16-byte"),
                                         ("reference", "4-byte"),
                                         ("width", "divisible by 4")])
@pytest.mark.parametrize("entry", ["mp2v_mc_recon_luma", "mp2v_mc_recon_uv",
                                   "mp2v_mc_field_luma", "mp2v_mc_field_uv",
                                   "mp2v_mc_roll_luma", "mp2v_mc_roll_uv"])
def test_recon_kernels_refuse_misaligned_inputs(entry, fault, match):
    """K2, K3, K4, K5 and K6 read the references as words and the residual
    16 bytes at a time: the launcher's checks raise before it loads the
    kernel library (so they run here, on CPU tensors) and count no
    launch."""
    refs0, refs1, ress, meta, h, w = _recon_args(entry, fault)
    assert all(x.is_contiguous() for x in (*refs0, *ress))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        mc_fused._launch(entry, "mc_recon", refs0, refs1, ress, meta, h, w,
                         True)
    assert dict(_build.LAUNCHES) == before
