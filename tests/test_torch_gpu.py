"""PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain
PyTorch version (K2 and K3 on every input kind of :func:`_mc_case`: edge
windows, every ``sx & 3``, every mode, extreme residuals, one-MB planes;
K4 and K8 on those and the field kinds: field units at the bottom and
right edges and at C_1 = -1, every ``sx_r & 3`` at every phase, every MB
field-predicted; K5, K6 and K7's picture form on every frame kind; K3, K4,
K6, K7 and K8 at the chroma tile of every format; K1 from one block to the
interlaced fixture's 196,608, over all of int16; the chunk transport, which
runs K1's transform inside it on the decoder's paths, on both 1080-line
fixtures' chunks (whole, short, chunks of 1 and 8, both block-position
forms) and on synthetic 1080- and 576-line chunks of every chroma format
(pictures with no coded block, full rows at int16's ends);
K9 and K10 at the MC profiler's shapes, edge starts, every ``sx & 3``
at every phase, on the tightest plane and at 1088x1904; the blocks form
of K2/K3/K4 on 1080-line pictures of every chroma format, whole and as a
band, and its grouped form, which the decoder's mxu path launches, on
groups of 1 and 16 pictures), both 1080-line
fixtures decoded through the kernels of each ``MP2V_MC_IMPL``, through
the chunk pipeline at ``gop_chunk=4`` and four times over at
``gop_chunk=16``, the MC profiler's parity run and the kernel gate; and
the serving and row-sharded paths: K7 and K8 on bands of MB rows,
``decode_batch`` and ``mesh="rows"`` to the committed hashes.

These tests skip where torch finds no CUDA device.  The file imports
neither JAX nor the JAX package, so it also runs on a GPU machine that has
no JAX; there, skip ``tests/conftest.py`` (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tiny_mp2v_dec_tpu_torch import (  # noqa: E402
    DecoderConfig, MP2VDecoder, fixtures)
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.idct import (  # noqa: E402
    idct_blocks, idct_blocks_ref)
from tiny_mp2v_dec_tpu_torch.ops.recon import (  # noqa: E402
    TRANSPORT_LAUNCHES, GopRecon)
from tiny_mp2v_dec_tpu_torch.tokenizer.types import (  # noqa: E402
    PictureGeometry)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _require_cuda():
    """Skip unless torch finds a CUDA device (decided at run time, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(-2048, 2048), (-32768, 32768)])
@pytest.mark.parametrize("n", [1, 31, 33, 70000, 196608])
def test_idct_kernel_matches_plain(n, lo, hi):
    """K1 against its plain version: a block alone, warps and CTAs cut short
    (31, 33: 4 blocks a warp, 32 a CTA), 70,000 blocks and the interlaced
    fixture's 196,608; coefficients over the decoder's range and over all
    of int16, with all-zero and saturating rows among them."""
    dev = _require_cuda()
    rng = np.random.default_rng(3 + n)
    c = rng.integers(lo, hi, (n, 64)).astype(np.int16)
    c[0] = hi - 1
    if n > 2:
        c[1], c[2] = 0, lo
    x = torch.from_numpy(c).to(dev)
    before = _build.LAUNCHES["idct8x8"]
    got = idct_blocks(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["idct8x8"] == before + 1
    assert torch.equal(got, idct_blocks_ref(x))


@pytest.mark.cuda
def test_idct_kernel_refuses_misaligned_input():
    """K1 reads 16-byte rows: coefficients two bytes into their storage
    raise before any launch."""
    dev = _require_cuda()
    flat = torch.zeros(8 * 64 + 1, dtype=torch.int16, device=dev)
    shifted = flat[1:].view(8, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        idct_blocks(shifted)
    assert dict(_build.LAUNCHES) == before


def _transport_check(recon, tokens, pcts):
    """Prepare and upload a chunk, then decode its blob through the chunk
    transport kernel and through the plain version: (dense, meta, flags)
    equal, meta and flags views of the uploaded blob, the kernel's three
    launches counted and no launch of K1 alone."""
    staged = recon.prepare(tokens, pcts)
    (cap_pairs, cap_k), _, _ = staged
    up = recon._upload_released(staged)
    before = dict(_build.LAUNCHES)
    got = recon._decode_blob(up, cap_pairs=cap_pairs, cap_k=cap_k)
    torch.cuda.synchronize()
    counts = {k: _build.LAUNCHES[k] - before.get(k, 0)
              for k in ("transport", "idct8x8")}
    assert counts == {"transport": TRANSPORT_LAUNCHES, "idct8x8": 0}
    want = recon._decode_blob_ref(up, cap_pairs=cap_pairs, cap_k=cap_k)
    for name, g, w in zip(("dense", "meta", "flags"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    blob = up.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == blob for t in got[1:])


# (fixture, chunk, first picture, pictures, uint16 block positions): both
# 1080-line fixtures' 16-picture chunks in both block-position forms, a
# chunk shorter than its size, chunks of 8 and of 1
TRANSPORT_FIXTURES = [
    ("bench_1080p_420_16", 16, 0, 16, True),
    ("bench_1080p_420_16", 16, 0, 16, False),
    ("interlaced_1080_422_16", 16, 0, 16, True),
    ("interlaced_1080_422_16", 16, 0, 16, False),
    ("bench_1080p_420_16", 16, 0, 12, True),
    ("interlaced_1080_422_16", 16, 4, 9, False),
    ("bench_1080p_420_16", 8, 8, 8, True),
    ("interlaced_1080_422_16", 8, 3, 5, True),
    ("bench_1080p_420_16", 1, 0, 1, True),
    ("interlaced_1080_422_16", 1, 5, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,chunk,first,pictures,scat_u16",
                         TRANSPORT_FIXTURES)
def test_transport_kernel_matches_plain(name, chunk, first, pictures,
                                        scat_u16):
    """The chunk transport kernel against its plain version on the
    fixtures' own blobs (:func:`_transport_check`); a chunk with a
    field-predicted MB takes the field form's 9 metadata columns."""
    dev = _require_cuda()
    data, _ = fixtures.load(name)
    toks = MP2VDecoder(DecoderConfig(device="cpu")).tokenize_stream(data)
    sel = toks[first:first + pictures]
    field = any(bool(t.field_pred.any()) for t, _, _ in sel)
    recon = GopRecon(sel[0][1], chunk, dev, field_support=field)
    recon._scat_u16 = scat_u16
    _transport_check(recon, [t for t, _, _ in sel],
                     [ph.picture_coding_type for _, _, ph in sel])


# (chroma format, lines, chunk, pictures, uint16 block positions, pictures
# with no coded block) of synthetic chunks of 1920-wide pictures, or
# 720-wide at 576 lines; the uint16 form only where a picture's blocks fit
# it (at 1088 lines 4:4:4 has 97,920 and takes the int32 form)
TRANSPORT_SYNTHETIC = [
    (1, 1088, 16, 16, True, (5,)),
    (1, 1088, 1, 1, False, ()),
    (2, 1088, 8, 8, False, (0,)),
    (2, 1088, 16, 7, True, (6,)),
    (3, 1088, 16, 16, False, (15,)),
    (3, 1088, 1, 1, False, (0,)),
    (3, 576, 8, 3, True, ()),
    (3, 576, 16, 16, True, (0, 9)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cf,lines,chunk,pictures,scat_u16,empty",
                         TRANSPORT_SYNTHETIC)
def test_transport_kernel_matches_plain_synthetic(cf, lines, chunk, pictures,
                                                  scat_u16, empty):
    """The chunk transport kernel against its plain version on synthetic
    chunks (``transport_cases.synthetic_chunk``): every chroma format,
    coded rows in a random claim order and of every density, two full rows
    a picture at int16's ends, pictures with no coded block, short chunks
    (:func:`_transport_check`)."""
    from transport_cases import synthetic_chunk
    dev = _require_cuda()
    geom = PictureGeometry(1920 if lines == 1088 else 720, lines, cf)
    assert not scat_u16 or geom.n_mb * geom.blocks_per_mb < 0xFFFF
    recon = GopRecon(geom, chunk, dev)
    recon._scat_u16 = scat_u16
    toks, pcts = synthetic_chunk(np.random.default_rng(40 + cf + chunk),
                                 geom, pictures, empty)
    _transport_check(recon, toks, pcts)


# input kinds of the frame forms (:func:`_mc_case`)
MC_KINDS = ("random", "edges", "sx_phases", "mode7", "extreme_residual",
            "one_mb")
# input kinds that shape the field tuples (``field=True`` only)
FIELD_KINDS = ("field_edges", "field_sx_phases", "field_all")


def _field_units(t, rng, kind, s, H, W, th, tw, n):
    """Direction ``s``'s field tuple (C0, sx0, ph0, C1, sx1, ph1) for the
    field kinds of :func:`_mc_case`, with C_r = 2*syf_r + sel_r - r from
    field window starts ``syf_r`` in [0, H/2 - th/2] and ``sx_r`` in
    [0, W - tw], as :func:`mc_fused.mc_field_meta` clamps them."""
    i = np.arange(n)
    out = []
    for r in range(2):
        syf = rng.integers(0, H // 2 - th // 2 + 1, n)
        sel = rng.integers(0, 2, n)
        sx = rng.integers(0, W - tw + 1, n)
        if kind == "field_edges":
            # the lowest start: the unit's last row's second tap is frame
            # row H + sel_r, past the plane
            syf = np.where(i % 3 != 1, H // 2 - th // 2, syf)
            sx = np.where(i % 3 != 0, W - tw, sx)
            if r == 1:                # C_1 = -1 on the others
                syf = np.where(i % 3 == 1, 0, syf)
                sel = np.where(i % 3 == 1, 0, sel)
            ph = (i // 3 + s + r) % 4
        else:
            sx = (np.minimum(sx, W - tw - 3) & ~3) + (i + r) % 4
            ph = (i // 4 + s + r) % 4
        out += [2 * syf + sel - r, sx, ph]
    return tuple(t(x.astype(np.int32)) for x in out)


def _mc_case(dev, seed, H, W, tile, n_planes, field=False, kind="random"):
    """Random planes and per-MB vectors; ``tile`` is (rows, columns) or a
    square side.  ``field``: field tuples of both directions appended, the
    field bit on about half the MBs.  ``kind`` (one of :data:`MC_KINDS`)
    shapes the frame vectors and the residual, or (one of
    :data:`FIELD_KINDS`, with ``field``) the field tuples:

    * ``random``: window starts and phases from random MVs (clamped by
      ``mc_meta``), modes 0-7 in equal numbers;
    * ``edges``: windows at ``sy = H - h``, ``sx = W - w`` or both (the
      taps past the plane read the zero pad) at every phase, mode 7;
    * ``sx_phases``: every ``sx & 3`` at every phase, mode 7 (needs
      ``W - w >= 3``);
    * ``mode7``: random windows, every MB at mode 7;
    * ``extreme_residual``: random windows and modes, the residual mostly
      at -32768 and 32767;
    * ``one_mb``: a plane of one MB (``H`` and ``W`` ignored);
    * ``field_edges``: every MB at mode 15 (field, both directions, coded),
      units at the lowest field window start (the second tap row of the
      unit's last row lies past the plane), at ``sx = W - w`` or both, and
      unit 1 at C_1 = -1 elsewhere, at every phase;
    * ``field_sx_phases``: mode 15, every ``sx_r & 3`` at every phase for
      both units, the two units' phases different (needs ``W - w >= 3``);
    * ``field_all``: random vectors, every MB at mode 15."""
    assert field or kind not in FIELD_KINDS, kind
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    th, tw = tile if isinstance(tile, tuple) else (tile, tile)
    if kind == "one_mb":
        H, W = th, tw
    mbh, mbw = H // th, W // tw
    n = mbh * mbw
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos = (t((mb_y * th).astype(np.int32)), t((mb_x * tw).astype(np.int32)))
    mv = t(rng.integers(-64, 64, (n, 2, 2, 2)).astype(np.int16))
    mode = rng.permutation(np.arange(n) % 8)
    if field:
        field_bit = rng.random(n) < 0.5
    meta = [*mc_fused.mc_meta(*pos, mv[:, 0, 0, 0], mv[:, 0, 0, 1], H, W,
                              th, tw),
            *mc_fused.mc_meta(*pos, mv[:, 0, 1, 0], mv[:, 0, 1, 1], H, W,
                              th, tw)]
    if kind in ("edges", "sx_phases", "mode7"):
        mode = np.full(n, 7)
    if kind in ("edges", "sx_phases"):
        i = np.arange(n)
        for s in range(2):
            sy = rng.integers(0, H - th + 1, n)
            sx = rng.integers(0, W - tw + 1, n)
            if kind == "edges":
                sy = np.where(i % 3 != 1, H - th, sy)
                sx = np.where(i % 3 != 0, W - tw, sx)
                ph = (i // 3 + s) % 4
            else:
                sx = (np.minimum(sx, W - tw - 3) & ~3) + i % 4
                ph = (i // 4 + s) % 4
            meta[3 * s:3 * s + 3] = [t(x.astype(np.int32))
                                     for x in (sy, sx, ph)]
    if field:
        mode = np.full(n, 15) if kind in FIELD_KINDS else mode + 8 * field_bit
    meta.append(t(mode.astype(np.int32)))
    if field:
        mvfs = t(rng.integers(0, 2, (n, 2, 2)).astype(np.uint8))
        meta += [mc_fused.mc_field_meta(*pos, mv[:, :, s], mvfs[:, :, s],
                                        H, W, th, tw) for s in range(2)]
        if kind in ("field_edges", "field_sx_phases"):
            meta[7:] = [_field_units(t, rng, kind, s, H, W, th, tw, n)
                        for s in range(2)]
    plane = lambda: t(rng.integers(0, 256, (H, W)).astype(np.uint8))  # noqa

    def resid():
        r = rng.integers(-300, 300, (H, W))
        if kind == "extreme_residual":
            r = np.where(rng.random((H, W)) < 0.75,
                         rng.choice([-32768, 32767], (H, W)), r)
        return t(r.astype(np.int16))

    res = [resid() for _ in range(n_planes)]
    return ([plane() for _ in range(n_planes)],
            [plane() for _ in range(n_planes)], res, meta)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
def test_mc_luma_kernel_matches_plain(kind, bidir):
    """K2 against its plain version on every input kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 13, 1088, 1920, 16, 1, kind=kind)
    before = _build.LAUNCHES["mc_recon_luma"]
    got = mc_fused.fused_mc_recon(r0[0], r1[0], res[0], *meta, bidir=bidir)
    want = mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                       h=16, w=16, bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_recon_luma"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
def test_mc_uv_kernel_matches_plain(kind, bidir):
    """K3 at the 4:2:0 tile (8x8) on every input kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 14, 544, 960, 8, 2, kind=kind)
    args = (tuple(r0), tuple(r1), tuple(res), *meta)
    before = _build.LAUNCHES["mc_recon_uv"]
    got = mc_fused.fused_mc_recon_uv(*args, bidir=bidir)
    want = mc_fused.fused_mc_recon_uv_ref(*args, h=8, w=8, bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_recon_uv"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
@pytest.mark.parametrize("H,W,tile", [(1088, 960, (16, 8)),
                                      (1088, 1920, (16, 16))])
def test_mc_uv_kernel_tiles_match_plain(H, W, tile, kind, bidir):
    """K3 at the 4:2:2 and 4:4:4 chroma tiles on every input kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 15, H, W, tile, 2, kind=kind)
    args = (tuple(r0), tuple(r1), tuple(res), *meta)
    got = mc_fused.fused_mc_recon_uv(*args, h=tile[0], w=tile[1],
                                     bidir=bidir)
    want = mc_fused.fused_mc_recon_uv_ref(*args, h=tile[0], w=tile[1],
                                          bidir=bidir)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("uv", [False, True])
def test_mc_recon_refuses_misaligned_residual(uv, field):
    """K2, K3 and K4 load the residual 16 bytes at a time: a residual view
    two bytes into its storage raises before any launch."""
    dev = _require_cuda()
    tile = 8 if uv else 16
    r0, r1, res, meta = _mc_case(dev, 21, 64, 64, tile, 2 if uv else 1,
                                 field=field)
    flat = torch.zeros(64 * 64 + 1, dtype=torch.int16, device=dev)
    shifted = flat[1:].view(64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        if uv:
            mc_fused.fused_mc_recon_uv(tuple(r0), tuple(r1),
                                       (res[0], shifted), *meta, h=8, w=8)
        else:
            mc_fused.fused_mc_recon(r0[0], r1[0], shifted, *meta)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS + FIELD_KINDS)
def test_mc_field_luma_kernel_matches_plain(kind, bidir):
    """K4, luma: the field kernel against the plain field-view version on
    every input kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 16, 1088, 1920, 16, 1, field=True,
                                 kind=kind)
    before = _build.LAUNCHES["mc_field_luma"]
    got = mc_fused.fused_mc_recon(r0[0], r1[0], res[0], *meta, bidir=bidir)
    want = mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                       h=16, w=16, bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_field_luma"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS + FIELD_KINDS)
@pytest.mark.parametrize("H,W,tile", [(544, 960, (8, 8)),
                                      (1088, 960, (16, 8)),
                                      (1088, 1920, (16, 16))])
def test_mc_field_uv_kernel_matches_plain(H, W, tile, kind, bidir):
    """K4, chroma, at the chroma tile of every format on every input
    kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 17, H, W, tile, 2, field=True,
                                 kind=kind)
    args = (tuple(r0), tuple(r1), tuple(res), *meta)
    before = _build.LAUNCHES["mc_field_uv"]
    got = mc_fused.fused_mc_recon_uv(*args, h=tile[0], w=tile[1],
                                     bidir=bidir)
    want = mc_fused.fused_mc_recon_uv_ref(*args, h=tile[0], w=tile[1],
                                          bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_field_uv"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# the blocks form's pictures: (chroma format, field rows) at 1080 lines,
# 120 x 68 MBs; the main path's two first
BLOCK_PICTURES = [(1, False), (2, True), (1, True), (2, False), (3, False),
                  (3, True)]
# (first MB row, MB rows) of the whole picture and of the second of the row
# path's 4 bands
BLOCK_BANDS = {"whole": (0, 68), "band": (17, 17)}


def _blocks_inputs(dev, seed, cf, field):
    """``tests/blocks_cases.blocks_case`` at 1920x1088 on the card."""
    from blocks_cases import blocks_case
    refs0, refs1, dense, meta = blocks_case(np.random.default_rng(seed), cf,
                                            field, 120, 68)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ([t(x) for x in refs0], [t(x) for x in refs1], t(dense),
            t(meta))


@pytest.mark.cuda
@pytest.mark.parametrize("band", sorted(BLOCK_BANDS))
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("cf,field", BLOCK_PICTURES)
def test_blocks_kernels_match_plain(cf, field, bidir, band):
    """The blocks form — luma and U+V, the field form with field rows — on
    a 1080-line picture of every chroma format, whole and as the row path's
    second band (window starts in the whole reference), each one launch and
    ``torch.equal`` to its plain version; the band equal to the whole
    picture's rows."""
    dev = _require_cuda()
    refs0, refs1, dense, meta = _blocks_inputs(dev, 40 + cf, cf, field)
    row0, rows = BLOCK_BANDS[band]
    bpm = dense.shape[0] // meta.shape[0]
    mb0, n = row0 * 120, rows * 120
    d, m = dense[mb0 * bpm:(mb0 + n) * bpm], meta[mb0:mb0 + n]
    form = "field" if field else "recon"
    kw = dict(chroma_format=cf, mbw=120, mb0=mb0, bidir=bidir)
    before = dict(_build.LAUNCHES)
    y = mc_fused.fused_mc_recon_blocks(refs0[0], refs1[0], d, m, **kw)
    uv = mc_fused.fused_mc_recon_uv_blocks(tuple(refs0[1:]),
                                           tuple(refs1[1:]), d, m, **kw)
    torch.cuda.synchronize()
    assert _launched(before) == {f"mc_{form}_blocks_luma": 1,
                                 f"mc_{form}_blocks_uv": 1}
    assert torch.equal(y, mc_fused.fused_mc_recon_blocks_ref(
        refs0[0], refs1[0], d, m, **kw))
    want = mc_fused.fused_mc_recon_uv_blocks_ref(
        tuple(refs0[1:]), tuple(refs1[1:]), d, m, **kw)
    assert all(torch.equal(g, w) for g, w in zip(uv, want))
    if band == "band":
        kw.update(mb0=0)
        whole = [mc_fused.fused_mc_recon_blocks(refs0[0], refs1[0], dense,
                                                meta, **kw),
                 *mc_fused.fused_mc_recon_uv_blocks(
                     tuple(refs0[1:]), tuple(refs1[1:]), dense, meta, **kw)]
        for g, w in zip((y, *uv), whole):
            th = g.shape[0] // rows
            assert torch.equal(g, w[row0 * th:(row0 + rows) * th])


# the grouped form's chunks: (chroma format, field rows) of the two
# 1080-line streams, and the group sizes
GROUP_PICTURES = [(1, False), (2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 16])
@pytest.mark.parametrize("cf,field", GROUP_PICTURES)
def test_group_kernel_matches_plain(cf, field, size):
    """The grouped blocks form on 1080-line pictures at 4:2:0 frame and
    4:2:2 field rows, groups of 1 and 16 pictures sharing two references
    and mixing bidir and forward-only pictures as a chunk's decode order
    does: one launch, ``torch.equal`` picture for picture to its plain
    version."""
    dev = _require_cuda()
    refs0, refs1, _, _ = _blocks_inputs(dev, 60 + cf, cf, field)
    pictures = []
    for k in range(size):
        _, _, dense, meta = _blocks_inputs(dev, 70 + 16 * cf + k, cf, field)
        pictures.append((refs0, refs1, dense, meta, k > 1 and k % 3 != 1))
    kw = dict(chroma_format=cf, mbw=120)
    before = dict(_build.LAUNCHES)
    got = mc_fused.fused_mc_recon_blocks_group(pictures, **kw)
    assert _launched(before) == {
        f"mc_{'field' if field else 'recon'}_blocks_group": 1}
    want = mc_fused.fused_mc_recon_blocks_group_ref(pictures, **kw)
    for k, (g, w) in enumerate(zip(got, want)):
        assert all(torch.equal(a, b) for a, b in zip(g, w)), f"picture {k}"


@pytest.mark.cuda
def test_blocks_kernels_refuse_misaligned_grid():
    """The blocks form loads a block row as one 16-byte vector: a grid two
    bytes into its storage raises on the card before any launch."""
    dev = _require_cuda()
    refs0, refs1, dense, meta = _blocks_inputs(dev, 50, 1, False)
    flat = torch.zeros(dense.numel() + 1, dtype=torch.int16, device=dev)
    shifted = flat[1:].view(dense.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        mc_fused.fused_mc_recon_blocks(refs0[0], refs1[0], shifted, meta,
                                       chroma_format=1, mbw=120)
    assert dict(_build.LAUNCHES) == before


# the decoder's mxu path: the grouped blocks form of K2/K3 (frame metadata
# rows) or of K4 (field rows), once a group of pictures that read no output
# of one another (ops/recon.py mc_groups)
MXU_FRAME = ("mc_recon_blocks_group",)
MXU_FIELD = ("mc_field_blocks_group",)
# its launches in a decode of a 16-picture fixture (decode order I P B B P
# B B ...) by gop_chunk: {I} {P} {B B P} x4 {B B} in a chunk of 16, 3 + 2 +
# 2 + 2 in four chunks of 4, a picture a chunk at 0
MXU_GROUPS = {16: 7, 4: 9, 0: 16}
# the vector form of K2/K3/K4 and the blocks form's one-picture entries,
# which the decoder's path no longer launches
VECTOR_FORM = ("mc_recon_luma", "mc_recon_uv", "mc_field_luma",
               "mc_field_uv", "mc_recon_blocks_luma", "mc_recon_blocks_uv",
               "mc_field_blocks_luma", "mc_field_blocks_uv")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernels", [
    ("bench_1080p_420_16", ("transport",) + MXU_FRAME),
    ("interlaced_1080_422_16", ("transport",) + MXU_FIELD),
])
def test_decode_fixture_through_kernels(name, kernels):
    """Each 1080-line fixture decodes to its JAX hash through the chunk
    transport once (its three launches; no launch of K1 alone) and the
    grouped blocks form of its MC kernels once a group (seven), and no
    launch of the vector form or of the one-picture blocks form."""
    _require_cuda()
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        want = json.load(f)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]
    counts = {k: _build.LAUNCHES[k] - before.get(k, 0)
              for k in kernels + VECTOR_FORM + ("idct8x8",)}
    assert counts == {"transport": TRANSPORT_LAUNCHES,
                      **{k: MXU_GROUPS[16] for k in kernels[1:]},
                      **{k: 0 for k in VECTOR_FORM + ("idct8x8",)}}


@pytest.mark.cuda
@pytest.mark.parametrize("pool,output_host", [(0, False), (1, True)])
@pytest.mark.parametrize("name,kernels", [
    ("bench_1080p_420_16", MXU_FRAME),
    ("interlaced_1080_422_16", MXU_FIELD),
])
def test_decode_fixture_through_pipeline(name, kernels, pool, output_host):
    """``gop_chunk=4``: the fixture's four chunks through the fill and
    dispatch threads, from pinned staging slots, to the same JAX hash,
    with the chunk transport once a chunk and the MC kernel once a group
    of each chunk; with host
    output, each chunk's frames read from the pinned copy started on the
    dispatch thread."""
    _require_cuda()
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        want = json.load(f)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=4, output_host=output_host,
                                    pictures_pool_size=pool, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]
    counts = {k: _build.LAUNCHES[k] - before.get(k, 0)
              for k in ("transport", "idct8x8") + kernels}
    assert counts == {"transport": 4 * TRANSPORT_LAUNCHES, "idct8x8": 0,
                      **{k: MXU_GROUPS[4] for k in kernels}}
    recon, = dec._recons.values()
    slots = [s for shape in recon._stage.values() for s in shape if s]
    assert 0 < len(slots) <= 3 * len(recon._stage)
    assert all(s.pinned.is_pinned() for s in slots)
    assert recon._seq_prep == recon._seq_disp == 4
    if output_host:
        assert all(f._shared._pinned.is_pinned() for f in frames)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernels", [
    ("bench_1080p_420_16", MXU_FRAME),
    ("interlaced_1080_422_16", MXU_FIELD),
])
def test_decode_fixture_over_four_chunks(name, kernels):
    """The main path at ``gop_chunk=16`` over several chunks: the fixture
    four times over in one stream (``fixtures.repeat_stream``) through
    the pipeline, each 16-frame group to the fixture's JAX hash, every
    launch four times the one-chunk decode's."""
    _require_cuda()
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = fixtures.repeat_stream(f.read(), 4)
    with open(os.path.join(DATA, name + ".json")) as f:
        want = json.load(f)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    assert len(frames) == 64
    for i in range(4):
        h = hashlib.sha256()
        for f in frames[16 * i:16 * (i + 1)]:
            h.update(f.tobytes())
        assert h.hexdigest() == want["yuv_sha256"], f"copy {i}"
    counts = {k: _build.LAUNCHES[k] - before.get(k, 0)
              for k in ("transport", "idct8x8") + kernels}
    assert counts == {"transport": 4 * TRANSPORT_LAUNCHES, "idct8x8": 0,
                      **{k: 4 * MXU_GROUPS[16] for k in kernels}}
    assert len(dec._spare_tokens) <= 32


# MP2V_MC_IMPL -> the MC kernels of a frame-predicted picture
FRAME_MC = {"mxu": MXU_FRAME,
            "roll": ("mc_roll_luma", "mc_roll_uv"),
            "swar": ("mc_swar_yuv",)}


@pytest.mark.cuda
@pytest.mark.parametrize("gop_chunk", [0, 4, 16])
@pytest.mark.parametrize("impl", sorted(FRAME_MC))
def test_decode_natural_content(monkeypatch, impl, gop_chunk):
    """Natural content (``natural_576_420_16``: 720x576 4:2:0 from
    ``tests/natural_m2v.py``'s motion search) through each MC
    implementation at each chunk size, to the JAX package's hash: the
    chunk transport once a chunk (a picture at ``gop_chunk=0``), the
    implementation's MC kernels once a picture (under mxu once a group)
    and no other kernel."""
    _require_cuda()
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    data, want = fixtures.load("natural_576_420_16")
    dec = MP2VDecoder(DecoderConfig(gop_chunk=gop_chunk, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    torch.cuda.synchronize()
    counts = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()
              if n != before.get(k, 0)}
    assert fixtures.check_frames(frames, want) == want["yuv_sha256"]
    chunks = 16 // gop_chunk if gop_chunk else 16
    mc = MXU_GROUPS[gop_chunk] if impl == "mxu" else 16
    assert counts == {"transport": chunks * TRANSPORT_LAUNCHES,
                      **{k: mc for k in FRAME_MC[impl]}}


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
def test_roll_luma_kernel_matches_plain(kind, bidir):
    """K5 against K2's plain version, which computes the same function, on
    every input kind."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 18, 1088, 1920, 16, 1, kind=kind)
    before = _build.LAUNCHES["mc_roll_luma"]
    got = mc_fused.fused_mc_recon_roll(r0[0], r1[0], res[0], *meta,
                                       bidir=bidir)
    want = mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                       h=16, w=16, bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_roll_luma"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_roll_luma_refuses_misaligned_residual():
    """K5 loads the residual 16 bytes at a time, as K2: a residual view two
    bytes into its storage raises before any launch."""
    dev = _require_cuda()
    r0, r1, _, meta = _mc_case(dev, 23, 64, 64, 16, 1)
    flat = torch.zeros(64 * 64 + 1, dtype=torch.int16, device=dev)
    shifted = flat[1:].view(64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        mc_fused.fused_mc_recon_roll(r0[0], r1[0], shifted, *meta)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
@pytest.mark.parametrize("H,W,tile", [(544, 960, (8, 8)),
                                      (1088, 960, (16, 8)),
                                      (1088, 1920, (16, 16)),
                                      (24, 40, (8, 8))])
def test_roll_uv_kernel_matches_plain(H, W, tile, bidir, kind):
    """K6 at the chroma tile of every format on every input kind, and on
    an 8x8 plane of an odd number of MBs (the last warp's second MB
    missing)."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 19, H, W, tile, 2, kind=kind)
    args = (tuple(r0), tuple(r1), tuple(res), *meta)
    before = _build.LAUNCHES["mc_roll_uv"]
    got = mc_fused.fused_mc_recon_uv_roll(*args, h=tile[0], w=tile[1],
                                          bidir=bidir)
    want = mc_fused.fused_mc_recon_uv_ref(*args, h=tile[0], w=tile[1],
                                          bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_roll_uv"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 8), (16, 8), (16, 16)])
def test_roll_uv_refuses_misaligned_residual(tile):
    """K6 loads the residual 16 bytes at a time, as K3: a V residual view
    two bytes into its storage raises before any launch."""
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 26, 64, 64, tile, 2)
    flat = torch.zeros(64 * 64 + 1, dtype=torch.int16, device=dev)
    shifted = flat[1:].view(64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        mc_fused.fused_mc_recon_uv_roll(tuple(r0), tuple(r1),
                                        (res[0], shifted), *meta, h=tile[0],
                                        w=tile[1])
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("H,W,tile", [(1088, 1920, (16, 16)),
                                      (544, 960, (8, 8)),
                                      (1088, 960, (16, 8))])
def test_swar_kernel_matches_plain(H, W, tile, bidir, field):
    """K7 (K8 with ``field``) on one component: luma and 4:4:4 chroma at
    16x16, 4:2:0 and 4:2:2 chroma; words equal to the plain version's."""
    dev = _require_cuda()
    r0, r1, _, meta = _mc_case(dev, 20, H, W, tile, 1, field=field)
    fn, ref_fn, counter = (
        (mc_fused.fused_mc_pred_swar_field,
         mc_fused.fused_mc_pred_swar_field_ref, "mc_swar_field") if field
        else (mc_fused.fused_mc_pred_swar, mc_fused.fused_mc_pred_swar_ref,
              "mc_swar"))
    before = _build.LAUNCHES[counter]
    got = fn(r0[0], r1[0], *meta, h=tile[0], w=tile[1], bidir=bidir)
    want = ref_fn(r0[0], r1[0], *meta, h=tile[0], w=tile[1], bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[counter] == before + 1
    assert got.dtype == torch.int32 and got.shape == (H, W // 4)
    assert torch.equal(got, want)


def _yuv_case(dev, seed, Hc, Wc, tile, kind="random"):
    """One picture for K7's picture form: (Y, U, V) reference triples, the
    luma and chroma vectors of :func:`_mc_case` (``kind`` shapes both) and
    the mode vector all three components share.  Luma is 16x16 on the MB
    grid of the (Hc, Wc) chroma planes of ``tile`` MBs."""
    th, tw = tile
    y0, y1, _, meta_y = _mc_case(dev, seed, Hc * 16 // th, Wc * 16 // tw, 16,
                                 1, kind=kind)
    c0, c1, _, meta_c = _mc_case(dev, seed + 1, Hc, Wc, tile, 2, kind=kind)
    return ((y0[0], *c0), (y1[0], *c1), tuple(meta_y[:6]), tuple(meta_c[:6]),
            meta_y[6])


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS)
@pytest.mark.parametrize("Hc,Wc,tile", [(544, 960, (8, 8)),
                                        (1088, 960, (16, 8)),
                                        (1088, 1920, (16, 16))])
def test_swar_yuv_kernel_matches_plain(Hc, Wc, tile, kind, bidir):
    """K7's picture form, one launch for the three components, at the
    chroma tile of every format on every input kind: each word plane equal
    to the plain version's."""
    dev = _require_cuda()
    args = _yuv_case(dev, 24, Hc, Wc, tile, kind)
    before = dict(_build.LAUNCHES)
    got = mc_fused.fused_mc_pred_swar_yuv(*args, h=tile[0], w=tile[1],
                                          bidir=bidir)
    want = mc_fused.fused_mc_pred_swar_yuv_ref(*args, h=tile[0], w=tile[1],
                                               bidir=bidir)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {
        **before, "mc_swar_yuv": before.get("mc_swar_yuv", 0) + 1}
    assert len(got) == 3
    for g, w, ref in zip(got, want, args[0]):
        assert g.dtype == torch.int32
        assert g.shape == (ref.shape[0], ref.shape[1] // 4)
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_swar_yuv_refuses_chroma_planes_of_another_picture():
    """The chroma planes must be the luma plane's at the tile: 4:2:0 planes
    under the 4:2:2 tile raise before any launch."""
    dev = _require_cuda()
    args = _yuv_case(dev, 25, 64, 96, (8, 8))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError):
        mc_fused.fused_mc_pred_swar_yuv(*args, h=16, w=8)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("kind", MC_KINDS + FIELD_KINDS)
@pytest.mark.parametrize("H,W,tile", [(1088, 1920, (16, 16)),
                                      (544, 960, (8, 8)),
                                      (1088, 960, (16, 8))])
def test_swar_field_kernel_matches_plain_on_every_kind(H, W, tile, kind,
                                                       bidir):
    """K8 on luma and each chroma tile, on every input kind: words equal to
    the plain version's."""
    dev = _require_cuda()
    r0, r1, _, meta = _mc_case(dev, 22, H, W, tile, 1, field=True,
                               kind=kind)
    before = _build.LAUNCHES["mc_swar_field"]
    got = mc_fused.fused_mc_pred_swar_field(r0[0], r1[0], *meta, h=tile[0],
                                            w=tile[1], bidir=bidir)
    want = mc_fused.fused_mc_pred_swar_field_ref(r0[0], r1[0], *meta,
                                                 h=tile[0], w=tile[1],
                                                 bidir=bidir)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_swar_field"] == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl,kernels", [
    ("bench_1080p_420_16", "roll",
     {"transport": 3, "mc_roll_luma": 16, "mc_roll_uv": 16}),
    ("bench_1080p_420_16", "swar", {"transport": 3, "mc_swar_yuv": 16}),
    ("interlaced_1080_422_16", "swar", {"transport": 3, "mc_swar_field": 48}),
])
def test_decode_fixture_under_mc_impl(monkeypatch, name, impl, kernels):
    """Under ``MP2V_MC_IMPL`` roll and swar the fixtures decode to the same
    JAX hash through that implementation's kernels, launched as often as the
    16 pictures ask (K7's picture form once a picture, K8 once a component),
    and through no mxu kernel nor K7's one-component form."""
    _require_cuda()
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    with open(os.path.join(DATA, name + ".m2v"), "rb") as f:
        data = f.read()
    with open(os.path.join(DATA, name + ".json")) as f:
        want = json.load(f)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]
    for k, n in kernels.items():
        assert _build.LAUNCHES[k] == before.get(k, 0) + n, k
    for k in ("mc_recon_luma", "mc_recon_uv", "mc_field_luma",
              "mc_field_uv", "mc_swar"):
        assert _build.LAUNCHES[k] == before.get(k, 0), k


@pytest.mark.cuda
def test_roll_with_field_support_refused_on_cuda():
    """An explicit roll with field support has no kernel: on the card the
    recon refuses it rather than run the plain version there."""
    dev = _require_cuda()
    from tiny_mp2v_dec_tpu_torch import PictureGeometry
    from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon
    geom = PictureGeometry(width=32, height=32, chroma_format=1)
    with pytest.raises(ValueError, match="roll"):
        DeviceRecon(geom, dev, field_support=True, mc_impl="roll")


def _rows_inputs(case):
    """The MC profiler's 1080p inputs on the card at the starts of
    ``profile_mc_variants.row_case`` (``profiler``, ``edges``,
    ``sx_phases``), each also on the tightest plane the kernels take
    (``-tight``); or the profiler's draw at 1088x1904, whose 119 MBs a row
    put the kernels' 8-MB blocks across MB rows and leave the last block 4
    MBs (``1904``)."""
    from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv
    if case == "1904":
        return pmv.make_inputs(W=1904, device="cuda")
    starts, _, tight = case.partition("-")
    return pmv.row_case(pmv.make_inputs(device="cuda"), starts, bool(tight))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["profiler", "edges", "sx_phases",
                                  "profiler-tight", "edges-tight",
                                  "sx_phases-tight", "1904"])
def test_mc_row_kernels_match_plain(case):
    """K9 and K10 against their plain versions at the profiler's shapes —
    the (1120, 2048) byte plane and the (1120, 640) word plane — on the
    tightest plane they take and at 1088x1904, one launch each."""
    _require_cuda()
    from tiny_mp2v_dec_tpu_torch.ops import mc_rows
    x = _rows_inputs(case)
    before = dict(_build.LAUNCHES)
    got = mc_rows.mc_row_pred(x.plane_pad, x.sy, x.sx, x.ph, H=x.H, W=x.W)
    gotw = mc_rows.mc_row_pred_packed(x.plane32, x.sy, x.sxq, x.rb, x.ph,
                                      H=x.H, W=x.W)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mc_row"] == before.get("mc_row", 0) + 1
    assert (_build.LAUNCHES["mc_row_packed"]
            == before.get("mc_row_packed", 0) + 1)
    want = mc_rows.mc_row_pred_ref(x.plane_pad, x.sy, x.sx, x.ph, H=x.H,
                                   W=x.W)
    assert torch.equal(got, want)
    assert gotw.dtype == torch.int32 and gotw.shape == (x.H, x.W // 4)
    assert torch.equal(gotw, mc_rows.mc_row_pred_packed_ref(
        x.plane32, x.sy, x.sxq, x.rb, x.ph, H=x.H, W=x.W))
    assert torch.equal(mc_fused.unpack_words(gotw), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["odd width", "misaligned", "W + 4 bytes"])
def test_mc_row_refuses_a_plane_it_cannot_read_as_words(fault):
    """K9 and K10 read their planes as 16-byte quads: on the card a K9 plane
    of odd width, either plane one element past a quad or of rows of W + 4
    bytes raises before any launch (no plain fallback)."""
    _require_cuda()
    from tiny_mp2v_dec_tpu_torch.ops import mc_rows
    x = _rows_inputs("profiler")
    before = dict(_build.LAUNCHES)
    for packed in (False, True):
        plane = x.plane32 if packed else x.plane_pad
        Hp, Wp = plane.shape
        if fault == "odd width":
            if packed:
                continue
            plane = torch.zeros((Hp, x.W + 1), dtype=plane.dtype,
                                device="cuda")
        elif fault == "W + 4 bytes":
            plane = torch.zeros((Hp, (x.W + 4) // plane.element_size()),
                                dtype=plane.dtype, device="cuda")
        else:
            plane = torch.zeros(Hp * Wp + 1, dtype=plane.dtype,
                                device="cuda")[1:].view(Hp, Wp)
        with pytest.raises(ValueError, match="16-byte aligned"):
            if packed:
                mc_rows.mc_row_pred_packed(plane, x.sy, x.sxq, x.rb, x.ph,
                                           H=x.H, W=x.W)
            else:
                mc_rows.mc_row_pred(plane, x.sy, x.sx, x.ph, H=x.H, W=x.W)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
def test_profiler_parity_launches_each_row_kernel_once():
    _require_cuda()
    from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv
    x = pmv.make_inputs(device="cuda")
    _build.LAUNCHES.clear()
    assert pmv.parity(x) == {"b": True, "c": True, "d": True}
    assert dict(_build.LAUNCHES) == {"mc_row": 1, "mc_row_packed": 1}


@pytest.mark.cuda
def test_perf_gate_passes():
    _require_cuda()
    from tiny_mp2v_dec_tpu_torch.tools import perf_gate
    rec = perf_gate.run_gates()
    assert rec["mc_equal"] and rec["chunk_equal"], rec
    assert rec["serve_equal"], rec
    assert rec["pass"], rec


# ---- the serving and row-sharded paths

BANDS = 4


def _bands(n_mb, mbw):
    """The MB slices of :data:`BANDS` equal bands of MB rows."""
    per = n_mb // mbw // BANDS
    return [(k * per, per, slice(k * per * mbw, (k + 1) * per * mbw))
            for k in range(BANDS)]


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("form", ["component", "field", "picture"])
def test_swar_band_kernels_match_plain(form, bidir):
    """K7 (both entry points) and K8 given an output band, ``H`` below the
    reference's rows, as the row-sharded path launches them on a 1080-line
    picture in 4 bands of 17 MB rows: each band's words equal the plain
    version's band and the same rows of the whole-picture launch."""
    dev = _require_cuda()
    if form == "picture":
        tile = (8, 8)
        args = _yuv_case(dev, 31, 544, 960, tile)
        whole = mc_fused.fused_mc_pred_swar_yuv(*args, h=8, w=8,
                                                bidir=bidir)
        for row0, per, sl in _bands(68 * 120, 120):
            cut = (args[0], args[1], tuple(v[sl] for v in args[2]),
                   tuple(v[sl] for v in args[3]), args[4][sl])
            got = mc_fused.fused_mc_pred_swar_yuv(*cut, h=8, w=8,
                                                  bidir=bidir, H=per * 16)
            want = mc_fused.fused_mc_pred_swar_yuv_ref(
                *cut, h=8, w=8, bidir=bidir, H=per * 16)
            for c, (g, w, wh) in enumerate(zip(got, want, whole)):
                th = 16 if c == 0 else tile[0]
                assert torch.equal(g, w), (row0, c)
                assert torch.equal(g, wh[row0 * th:(row0 + per) * th])
        return
    field = form == "field"
    fn = (mc_fused.fused_mc_pred_swar_field if field
          else mc_fused.fused_mc_pred_swar)
    plain = (mc_fused.fused_mc_pred_swar_field_ref if field
             else mc_fused.fused_mc_pred_swar_ref)
    for H, W, tile in ((1088, 1920, (16, 16)), (544, 960, (8, 8))):
        r0, r1, _, meta = _mc_case(dev, 32, H, W, tile, 1, field=field)
        flat = [*meta[:7], *(meta[7] + meta[8] if field else ())]
        nf = len(flat)
        whole = fn(r0[0], r1[0], *meta, h=tile[0], w=tile[1], bidir=bidir)
        for row0, per, sl in _bands(len(flat[0]), W // tile[1]):
            cut = [v[sl] for v in flat]
            parts = (*cut[:7], tuple(cut[7:13]), tuple(cut[13:nf])) \
                if field else cut
            kw = dict(h=tile[0], w=tile[1], bidir=bidir, H=per * tile[0])
            got = fn(r0[0], r1[0], *parts, **kw)
            assert got.shape == (per * tile[0], W // 4)
            assert torch.equal(got, plain(r0[0], r1[0], *parts, **kw))
            assert torch.equal(
                got, whole[row0 * tile[0]:(row0 + per) * tile[0]])


# the committed streams of the stream batch: three geometry groups, two
# 1080p 4:2:0 streams of unequal length (the shorter padded with no-op
# pictures), the interlaced stream on K4
BATCH = ("bench_1080p_420_16", "bench_1080p_420_8", "interlaced_1080_422_16",
         "natural_576_420_16")
# MP2V_MC_IMPL -> (streams, launches of their decode_batch on one card: the
# chunk transport once a step (three launches), the longest stream of each
# group setting its steps; under mxu the MC kernels once a step, every
# stream of the step in one launch; under roll and swar once a stream a
# step, padding included)
BATCH_CASES = {
    "mxu": (BATCH, {"transport": 144, "mc_recon_blocks_group": 32,
                    "mc_field_blocks_group": 16}),
    "roll": (BATCH[:2], {"transport": 48, "mc_roll_luma": 32,
                         "mc_roll_uv": 32}),
    "swar": (BATCH[:2], {"transport": 48, "mc_swar_yuv": 32}),
}


def _launched(before):
    torch.cuda.synchronize()
    return {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()
            if n != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", sorted(BATCH_CASES))
def test_decode_batch_fixtures(monkeypatch, impl):
    """``decode_batch`` of the committed streams on the card: every
    stream to its JAX hash, the chunk transport once a step."""
    _require_cuda()
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    names, launches = BATCH_CASES[impl]
    loaded = [fixtures.load(n) for n in names]
    dec = MP2VDecoder(DecoderConfig(output_host=False, device="cuda"))
    before = dict(_build.LAUNCHES)
    out = dec.decode_batch([d for d, _ in loaded])
    assert _launched(before) == launches
    for frames, (_, want) in zip(out, loaded):
        assert fixtures.check_frames(frames, want) == want["yuv_sha256"]


# (fixture, MP2V_MC_IMPL) -> launches of its decode in 4 bands on one card:
# the chunk transport once a picture (three launches), the MC kernels once
# a band a picture (under mxu luma and U+V in one launch; the interlaced
# stream's I picture, which has no field MB, on the frame kernels)
ROWS = {
    ("bench_1080p_420_16", "mxu"): {
        "transport": 48, "mc_recon_blocks_group": 64},
    ("bench_1080p_420_16", "swar"): {"transport": 48, "mc_swar_yuv": 64},
    ("interlaced_1080_422_16", "mxu"): {
        "transport": 48, "mc_recon_blocks_group": 4,
        "mc_field_blocks_group": 60},
    ("interlaced_1080_422_16", "swar"): {
        "transport": 48, "mc_swar_yuv": 4, "mc_swar_field": 180},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl", sorted(ROWS))
def test_mesh_rows_fixtures(monkeypatch, name, impl):
    """``mesh="rows"`` with 4 bands (68 MB rows: 17 a band) on one card,
    to the JAX hash."""
    _require_cuda()
    monkeypatch.setenv("MP2V_MC_IMPL", impl)
    data, want = fixtures.load(name)
    dec = MP2VDecoder(DecoderConfig(mesh="rows", mesh_devices=BANDS,
                                    device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    assert _launched(before) == ROWS[name, impl]
    assert fixtures.check_frames(frames, want) == want["yuv_sha256"]
