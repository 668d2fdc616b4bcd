"""The blocks form of the MC kernels K2/K3/K4 on the CPU.

``mc_fused.fused_mc_recon_blocks`` and ``fused_mc_recon_uv_blocks`` take a
picture's residual block grid and its metadata rows as the chunk blob
carries them; the decoder's ``mxu`` path runs them.  On the CPU they take
their plain versions.  These tests hold them, on random pictures of every
chroma format, frame and field rows, both directions and forward only,
whole pictures and bands:

* equal to the vector-form composition the decoder ran before the blocks
  form (the residual laid out as planes, the MVs unpacked, scaled and
  turned into window starts by ``mc_meta`` / ``mc_field_meta``, then the
  vector-form wrappers);
* equal to a thread-by-thread model of the kernel's blocks front end
  (``blocks_cases.kernel_model``), the index arithmetic that only the card
  runs;

and check that each refuses what its kernel would refuse, on either
device.  The grouped form (``fused_mc_recon_blocks_group``: luma and U+V
of up to 16 pictures in one launch) is held picture for picture to the
one-picture plain versions and to a model of its grid
(``blocks_cases.group_model``); ``GopRecon._gop`` forms its groups by the
rule of ``recon.mc_groups`` and decodes a chunk as a picture-at-a-time
loop over the plain versions does.
"""
import numpy as np
import pytest
import torch

from blocks_cases import blocks_case, group_model, kernel_model
from tiny_mp2v_dec_tpu_torch import headers as H
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused
from tiny_mp2v_dec_tpu_torch.ops.recon import (DeviceRecon, GopRecon,
                                               mc_groups)
from tiny_mp2v_dec_tpu_torch.tokenizer.types import (CHROMA_INFO,
                                                     PictureGeometry)

CFS = (H.CHROMA_420, H.CHROMA_422, H.CHROMA_444)
# (mb rows of the band, its first row): the whole 5-row picture, a band
BANDS = {"whole": (5, 0), "band": (2, 2)}
MBW, MBH = 4, 5


def _case(seed, cf, field, band):
    rng = np.random.default_rng(seed)
    refs0, refs1, dense, meta = blocks_case(rng, cf, field, MBW, MBH)
    rows, row0 = BANDS[band]
    sl = slice(row0 * MBW, (row0 + rows) * MBW)
    bpm = dense.shape[0] // meta.shape[0]
    t = torch.from_numpy
    return ([t(x) for x in refs0], [t(x) for x in refs1],
            t(np.ascontiguousarray(dense[sl.start * bpm:sl.stop * bpm])),
            t(np.ascontiguousarray(meta[sl])), row0 * MBW)


def _vector_form(refs0, refs1, dense, meta, cf, mb0, bidir):
    """The decoder's per-picture composition before the blocks form:
    ``_unpack_meta2``, ``_tiles_from_blocks``, ``_plane_from_tiles``,
    ``_scale_mv``, ``mc_meta``/``mc_field_meta`` and the vector-form
    wrappers ``fused_mc_recon`` / ``fused_mc_recon_uv``."""
    fs = meta.shape[1] == 9
    dct, fwd, bwd, fpred, coded, mv, mvfs = mc_fused._unpack_meta2(meta, fs)
    xs, ys, n_cb = CHROMA_INFO[cf]
    n = meta.shape[0]
    residual = dense.view(n, 4 + 2 * n_cb, 8, 8)
    mode = fwd.to(torch.int32) + 2 * bwd.to(torch.int32) + 4 * coded.to(
        torch.int32)
    if fs:
        mode = mode + 8 * fpred.to(torch.int32)
    mb = mb0 + np.arange(n)
    mb_y, mb_x = mb // MBW, mb % MBW
    mbh = n // MBW
    out = []
    for uv in (False, True):
        ch, cw = (16 >> ys, 16 >> xs) if uv else (16, 16)
        sy, sx = (ys, xs) if uv else (0, 0)
        py = torch.from_numpy(((mb_y * 16) >> sy).astype(np.int32))
        px = torch.from_numpy(((mb_x * 16) >> sx).astype(np.int32))
        mvs = mc_fused._scale_mv(mv, cf) if uv else mv
        Hr, Wr = (refs0[1] if uv else refs0[0]).shape
        vecs = [*mc_fused.mc_meta(py, px, mvs[:, 0, 0, 0], mvs[:, 0, 0, 1],
                                  Hr, Wr, ch, cw),
                *mc_fused.mc_meta(py, px, mvs[:, 0, 1, 0], mvs[:, 0, 1, 1],
                                  Hr, Wr, ch, cw), mode]
        if fs:
            vecs += [mc_fused.mc_field_meta(py, px, mvs[:, :, s],
                                            mvfs[:, :, s], Hr, Wr, ch, cw)
                     for s in range(2)]
        if uv:
            inter = dct if cf != H.CHROMA_420 else None
            res = tuple(mc_fused._plane_from_tiles(
                mc_fused._tiles_from_blocks(b, ch // 8, cw // 8, inter),
                mbh, MBW, ch, cw)
                for b in (residual[:, 4:4 + n_cb], residual[:, 4 + n_cb:]))
            out += mc_fused.fused_mc_recon_uv(
                tuple(refs0[1:]), tuple(refs1[1:]), res, *vecs, h=ch, w=cw,
                bidir=bidir)
        else:
            res = mc_fused._plane_from_tiles(
                mc_fused._tiles_from_blocks(residual[:, :4], 2, 2, dct),
                mbh, MBW, 16, 16)
            out.append(mc_fused.fused_mc_recon(refs0[0], refs1[0], res,
                                               *vecs, bidir=bidir))
    return out


def _blocks_form(refs0, refs1, dense, meta, cf, mb0, bidir, plain=False):
    luma, uv = ((mc_fused.fused_mc_recon_blocks_ref,
                 mc_fused.fused_mc_recon_uv_blocks_ref) if plain else
                (mc_fused.fused_mc_recon_blocks,
                 mc_fused.fused_mc_recon_uv_blocks))
    kw = dict(chroma_format=cf, mbw=MBW, mb0=mb0, bidir=bidir)
    y = luma(refs0[0], refs1[0], dense, meta, **kw)
    u, v = uv(tuple(refs0[1:]), tuple(refs1[1:]), dense, meta, **kw)
    return [y, u, v]


@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("cf", CFS)
def test_blocks_form_equals_vector_form(cf, field, bidir, band):
    """Y, U and V of the blocks form equal the vector-form composition's,
    and the kernel model's, on a picture with dct_type on some MBs,
    uncoded MBs, windows clamped at every edge and, with field rows, field
    prediction with selects of both parities; whole or a band of MB rows
    from row 2 (its window starts in the whole reference's
    coordinates)."""
    seed = 1000 + 10 * cf + 4 * field + 2 * bidir + (band == "band")
    refs0, refs1, dense, meta, mb0 = _case(seed, cf, field, band)
    before = dict(_build.LAUNCHES)
    got = _blocks_form(refs0, refs1, dense, meta, cf, mb0, bidir)
    want = _vector_form(refs0, refs1, dense, meta, cf, mb0, bidir)
    assert dict(_build.LAUNCHES) == before
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.uint8 and g.shape == w.shape, c
        assert torch.equal(g, w), f"component {c}"
    r0, r1 = [r.numpy() for r in refs0], [r.numpy() for r in refs1]
    rest = (dense.numpy(), meta.numpy(), cf, MBW, mb0, bidir)
    model = (kernel_model(r0[:1], r1[:1], *rest, uv=False)
             + kernel_model(r0[1:], r1[1:], *rest, uv=True))
    for c, (g, m) in enumerate(zip(got, model)):
        np.testing.assert_array_equal(g.numpy(), m, err_msg=f"component {c}")


@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("impl", ["roll", "swar"])
def test_roll_and_swar_recon_equal_the_blocks_form(impl, cf, field, bidir,
                                                   band):
    """``DeviceRecon._recon_from_residual`` under ``roll`` (K5/K6's
    wrappers; with field rows, the explicit roll's plain version) and
    ``swar`` (K7's picture form, or K8 per component, then the epilogue),
    which lay the residual grid and the metadata rows out through
    ``blocks_to_vectors``, equal the blocks form's plain version: every
    chroma format, frame and field rows, both directions and forward only,
    the whole picture and a band of MB rows."""
    seed = 3000 + 100 * (impl == "swar") + 10 * cf + 4 * field + 2 * bidir \
        + (band == "band")
    refs0, refs1, dense, meta, mb0 = _case(seed, cf, field, band)
    geom = PictureGeometry(width=16 * MBW, height=16 * MBH, chroma_format=cf)
    recon = DeviceRecon(geom, "cpu", field_support=field, mc_impl=impl)
    rows = BANDS[band][0]
    before = dict(_build.LAUNCHES)
    got = recon._recon_from_residual(
        dense, meta, *refs0, *refs1, bidir=bidir,
        band=None if band == "whole" else (mb0 // MBW, rows))
    want = _blocks_form(refs0, refs1, dense, meta, cf, mb0, bidir,
                        plain=True)
    assert dict(_build.LAUNCHES) == before
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.uint8 and g.shape == w.shape, c
        assert torch.equal(g, w), f"component {c}"


def test_cases_reach_what_they_are_for():
    """The random pictures hold what the tests above are said to cover:
    dct_type, uncoded and field-predicted MBs, selects of both parities in
    each unit and direction, and windows clamped at all four edges."""
    _, _, _, meta = blocks_case(np.random.default_rng(1), H.CHROMA_422, True,
                                MBW, MBH)
    flags = meta[:, 0].astype(np.int64)
    assert (flags & 1).any() and not (flags & 1).all()
    assert not ((flags >> 4) & 1).all()
    assert (flags & 8).any()
    for bit in range(5, 9):
        assert ((flags >> bit) & 1).any() and not ((flags >> bit) & 1).all()
    mvx, mvy = meta[:, 1].astype(int), meta[:, 2].astype(int)
    mb = np.arange(len(meta))
    y = (mb // MBW) * 16 + (mvy >> 1)
    x = (mb % MBW) * 16 + (mvx >> 1)
    assert (y < 0).any() and (y > 16 * MBH - 16).any()
    assert (x < 0).any() and (x > 16 * MBW - 16).any()


def _refusal_args(cf=H.CHROMA_420, field=False):
    refs0, refs1, dense, meta, _ = _case(7, cf, field, "whole")
    return refs0, refs1, dense, meta


def _grid_misaligned(dense):
    flat = torch.zeros(dense.numel() + 1, dtype=torch.int16)
    shifted = flat[1:].view(dense.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return shifted


# refusal -> (what it changes of the good arguments, the message)
REFUSALS = {
    "meta_dtype": (lambda d, m: (d, m.to(torch.int32)), "metadata rows"),
    "meta_cols": (lambda d, m: (d, torch.zeros((m.shape[0], 6),
                                               dtype=torch.int16)),
                  "metadata rows"),
    "grid_dtype": (lambda d, m: (d.to(torch.int32), m), "block grid"),
    "grid_misaligned": (lambda d, m: (_grid_misaligned(d), m), "16-byte"),
    "grid_length": (lambda d, m: (d[:-1].clone(), m), "block grid"),
}


@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("refusal", sorted(REFUSALS))
def test_blocks_form_refuses(refusal, uv):
    """Each wrapper refuses, before any work, metadata rows of another
    dtype or of a column count other than 5 or 9, a block grid of another
    dtype, one not 16-byte aligned (the kernel loads a block row as one
    16-byte vector) and one of the wrong length for the MBs."""
    refs0, refs1, dense, meta = _refusal_args()
    change, msg = REFUSALS[refusal]
    dense, meta = change(dense, meta)
    kw = dict(chroma_format=H.CHROMA_420, mbw=MBW)
    with pytest.raises(ValueError, match=msg):
        if uv:
            mc_fused.fused_mc_recon_uv_blocks(tuple(refs0[1:]),
                                              tuple(refs1[1:]), dense, meta,
                                              **kw)
        else:
            mc_fused.fused_mc_recon_blocks(refs0[0], refs1[0], dense, meta,
                                           **kw)


@pytest.mark.parametrize("bad", ["mbw", "mb0", "past_reference", "format"])
def test_blocks_form_refuses_geometry(bad):
    """MBs that are not whole MB rows, a band that does not start at a row
    or that lies past the reference, and an unknown chroma format."""
    refs0, refs1, dense, meta = _refusal_args()
    kw = {"mbw": dict(chroma_format=H.CHROMA_420, mbw=3),
          "mb0": dict(chroma_format=H.CHROMA_420, mbw=MBW, mb0=2),
          "past_reference": dict(chroma_format=H.CHROMA_420, mbw=MBW,
                                 mb0=MBW),
          "format": dict(chroma_format=0, mbw=MBW)}[bad]
    with pytest.raises(ValueError):
        mc_fused.fused_mc_recon_blocks(refs0[0], refs1[0], dense, meta, **kw)


GROUP_SIZES = (1, 3, 8, 16)


def _group(seed, cf, field, size, band="whole"):
    """``size`` pictures of one geometry (a band of each when asked), bidir
    and forward-only mixed: ``(refs0, refs1, dense, meta, bidir)`` each,
    and the band's first MB."""
    pictures = []
    for k in range(size):
        refs0, refs1, dense, meta, mb0 = _case(seed + 7919 * k, cf, field,
                                               band)
        pictures.append((refs0, refs1, dense, meta, (k + size) % 3 != 0))
    return pictures, mb0


@pytest.mark.parametrize("band", sorted(BANDS))
@pytest.mark.parametrize("size", GROUP_SIZES)
@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("cf", CFS)
def test_group_equals_one_picture_forms(cf, field, size, band):
    """The grouped form's planes equal, picture for picture, the
    one-picture plain versions' (luma, then U+V, each picture at its own
    ``bidir``) and the model of the group's grid, for groups of 1, 3, 8 and
    16 pictures mixing bidir and forward-only ones, every chroma format,
    frame and field rows, whole pictures and bands."""
    pictures, mb0 = _group(6000 + 100 * cf + 10 * field + size, cf, field,
                           size, band)
    assert size == 1 or len({p[4] for p in pictures}) == 2
    before = dict(_build.LAUNCHES)
    got = mc_fused.fused_mc_recon_blocks_group(pictures, chroma_format=cf,
                                               mbw=MBW, mb0=mb0)
    assert dict(_build.LAUNCHES) == before
    assert len(got) == size
    model = group_model([([r.numpy() for r in r0], [r.numpy() for r in r1],
                          d.numpy(), m.numpy(), b)
                         for r0, r1, d, m, b in pictures], cf, MBW, mb0)
    for k, ((refs0, refs1, dense, meta, bidir), planes) in enumerate(
            zip(pictures, got)):
        want = _blocks_form(refs0, refs1, dense, meta, cf, mb0, bidir,
                            plain=True)
        for c, (g, w, m) in enumerate(zip(planes, want, model[k])):
            assert g.dtype == torch.uint8 and g.shape == w.shape, (k, c)
            assert torch.equal(g, w), f"picture {k}, component {c}"
            np.testing.assert_array_equal(g.numpy(), m,
                                          err_msg=f"picture {k}, "
                                                  f"component {c}")


def _refuse_cap(pictures):
    return pictures + pictures[:1] * (17 - len(pictures))


def _refuse_geometry(pictures):
    refs0, refs1, dense, meta, _ = _case(8, H.CHROMA_420, False, "band")
    return pictures + [(refs0, refs1, dense, meta, True)]


def _refuse_rows(pictures):
    refs0, refs1, dense, meta, _ = _case(9, H.CHROMA_420, True, "whole")
    return pictures + [(refs0, refs1, dense, meta, True)]


def _refuse_grid(pictures):
    refs0, refs1, dense, meta, bidir = pictures[-1]
    return pictures[:-1] + [(refs0, refs1, _grid_misaligned(dense), meta,
                             bidir)]


def _refuse_triples(pictures):
    refs0, refs1, dense, meta, bidir = pictures[1]
    return [pictures[0], (refs0[1:], refs1[1:], dense, meta, bidir)]


# refusal -> (what it makes of a good group of 3, the message)
GROUP_REFUSALS = {
    "empty": (lambda p: [], "1 to 16"),
    "over_cap": (_refuse_cap, "1 to 16"),
    "mixed_geometry": (_refuse_geometry, "share"),
    "mixed_rows": (_refuse_rows, "share"),
    "misaligned_grid": (_refuse_grid, "16-byte"),
    "not_triples": (_refuse_triples, "triples"),
}


@pytest.mark.parametrize("refusal", sorted(GROUP_REFUSALS))
def test_group_refuses(refusal):
    """The grouped form refuses, before any work, an empty group and one
    over the cap of 16, a picture of another geometry or row form than the
    others, a misaligned grid in any entry, and references that are not
    (Y, U, V) triples."""
    pictures, _ = _group(7, H.CHROMA_420, False, 3)
    change, msg = GROUP_REFUSALS[refusal]
    with pytest.raises(ValueError, match=msg):
        mc_fused.fused_mc_recon_blocks_group(change(pictures),
                                             chroma_format=H.CHROMA_420,
                                             mbw=MBW)


def _out_planes(pictures, cf, drop=0, narrow=0):
    """Planes for the group's ``out=``: a triple a picture but the last
    ``drop``, each U plane ``narrow`` columns narrower."""
    xs, ys, _ = CHROMA_INFO[cf]
    n = pictures[0][3].shape[0] // MBW * 16
    sizes = ((n, MBW * 16), (n >> ys, (MBW * 16 >> xs) - narrow),
             (n >> ys, MBW * 16 >> xs))
    return [tuple(torch.full(s, 77, dtype=torch.uint8) for s in sizes)
            for _ in pictures[:len(pictures) - drop]]


# out= case -> (drop, narrow, the message of its refusal or None)
OUT_CASES = {"written": (0, 0, None), "short": (1, 0, "out must"),
             "shape": (0, 8, "out must")}


@pytest.mark.parametrize("case", sorted(OUT_CASES))
@pytest.mark.parametrize("cf", CFS)
def test_group_out(cf, case):
    """Given ``out=``, the grouped form writes each picture's planes into
    its triple and returns them, equal to the planes it makes without it;
    it refuses, before any work, a triple short and a plane of another
    shape."""
    pictures, mb0 = _group(7100 + cf, cf, cf == H.CHROMA_422, 3, "band")
    drop, narrow, msg = OUT_CASES[case]
    out = _out_planes(pictures, cf, drop, narrow)
    kw = dict(chroma_format=cf, mbw=MBW, mb0=mb0)
    if msg is not None:
        with pytest.raises(ValueError, match=msg):
            mc_fused.fused_mc_recon_blocks_group(pictures, out=out, **kw)
        assert all(bool((x == 77).all()) for o in out for x in o)
        return
    got = mc_fused.fused_mc_recon_blocks_group(pictures, out=out, **kw)
    want = mc_fused.fused_mc_recon_blocks_group(pictures, **kw)
    for g, o, w in zip(got, out, want):
        assert all(a is b for a, b in zip(g, o))
        assert all(torch.equal(a, b) for a, b in zip(g, w))


# decode orders (picture coding types, decode order) of one GOP and more
ORDERS = {
    "m1": [H.PCT_I] + [H.PCT_P] * 17,
    "m2": [H.PCT_I] + [H.PCT_P, H.PCT_B] * 8 + [H.PCT_P],
    "m3": [H.PCT_I] + [H.PCT_P, H.PCT_B, H.PCT_B] * 5 + [H.PCT_P, H.PCT_B],
}


def test_mc_groups_close_after_each_ip_and_at_the_cap():
    """A group closes after each I/P picture, at the cap of 16 and at the
    chunk's end."""
    b, ip = 1, 2
    assert mc_groups([ip, ip, b, b, ip, b]) == [[0], [1], [2, 3, 4], [5]]
    assert mc_groups([b] * 20) == [list(range(16)), list(range(16, 20))]
    assert mc_groups([b] * 15 + [ip, b]) == [list(range(16)), [16]]
    assert mc_groups([]) == []


@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("order", ["m1", "m2", "m3", "m3_opens_on_b"])
def test_gop_groups_and_frames(monkeypatch, order, chunk):
    """``GopRecon._gop`` on the CPU over a chunk of each decode order (M=1,
    2 and 3, and M=3 from a chunk that opens on two B pictures), at chunks
    of 1, 4 and 16: its groups end exactly after each I/P picture and at
    the chunk's end, and its frames and references equal those of a
    picture-at-a-time loop over the one-picture plain versions."""
    from transport_cases import synthetic_tokens
    types = (ORDERS["m3"][2:] if order == "m3_opens_on_b"
             else ORDERS[order])[:chunk]
    geom = PictureGeometry(width=16 * MBW, height=16 * MBH - 8,
                           chroma_format=H.CHROMA_420)
    rng = np.random.default_rng(len(order) * 100 + chunk)
    toks = []
    for t in types:
        tok = synthetic_tokens(rng, geom, coded_share=0.3)
        if t == H.PCT_B:
            tok.bwd[:] = rng.random(geom.n_mb) < 0.6
        toks.append(tok)
    recon = GopRecon(geom, chunk, "cpu")
    sizes = []
    inner = recon.inner._recon_group

    def record(pictures, band=None):
        sizes.append(len(pictures))
        return inner(pictures, band)

    monkeypatch.setattr(recon.inner, "_recon_group", record)
    planes = lambda: tuple(  # noqa: E731
        torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
        for s in (geom.luma_padded, geom.chroma_padded, geom.chroma_padded))
    ref0, ref1 = planes(), planes()
    staged = recon.prepare(toks, types)
    (cap_pairs, cap_k), blob, _ = staged
    dense, meta, _ = recon._decode_blob(torch.from_numpy(blob.copy()),
                                        cap_pairs=cap_pairs, cap_k=cap_k)
    r0, r1, packs = recon.dispatch(staged, ref0, ref1)
    want_sizes, run = [], 0
    for t in types:
        run += 1
        if t != H.PCT_B:
            want_sizes.append(run)
            run = 0
    assert sizes == want_sizes + ([run] if run else [])
    assert recon.mc_launches == len(sizes)
    w0, w1 = ref0, ref1
    kw = dict(chroma_format=geom.chroma_format, mbw=geom.mb_width)
    for i, t in enumerate(types):
        b = t == H.PCT_B
        a0, a1 = (w0 if b else w1), w1
        out = (mc_fused.fused_mc_recon_blocks_ref(a0[0], a1[0], dense[i],
                                                  meta[i], bidir=b, **kw),
               *mc_fused.fused_mc_recon_uv_blocks_ref(
                   a0[1:], a1[1:], dense[i], meta[i], bidir=b, **kw))
        frame = torch.cat([out[0][:geom.height, :geom.width].reshape(-1)]
                          + [p[:(geom.height + 1) // 2,
                               :geom.width // 2].reshape(-1)
                             for p in out[1:]])
        assert torch.equal(packs[i], frame), f"picture {i}"
        if not b:
            w0, w1 = w1, out
    for got, want in zip((*r0, *r1), (*w0, *w1)):
        assert torch.equal(got, want)
