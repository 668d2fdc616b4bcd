"""PyTorch port, GOP-chunk transport and reconstruction against the JAX
package's GopRecon: the prepared blob byte for byte, the decoded blob, and
a 4-picture chunk's output (Pallas kernels in interpret mode) — in the
frame-prediction form and, for every chroma format, the field form."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity import ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import DecoderConfig as JaxConfig  # noqa: E402
from tiny_mp2v_dec_tpu import MP2VDecoder as JaxDecoder  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.ops.recon import GopRecon as JaxGopRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import PictureGeometry  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402

IPBPB_B = ((H.PCT_I, 0), (H.PCT_P, 2), (H.PCT_B, 1), (H.PCT_P, 4),
           (H.PCT_B, 3), (H.PCT_P, 6), (H.PCT_B, 5))


FIELD = {"fpfd": False, "allow_field_motion": True}


def _tokens(seed, mb_w=3, mb_h=2, cf=H.CHROMA_420, **opts):
    """One random stream tokenized by both packages' native tokenizers.
    One tokenizer thread each: with several, slices claim coefficient rows
    in scheduling order, and the blob's row order with them."""
    data = ipb_stream(np.random.default_rng(seed), mb_w, mb_h, cf, IPBPB_B,
                      **opts)
    jt = JaxDecoder(JaxConfig(num_threads=1)).tokenize_stream(data)
    tt = MP2VDecoder(DecoderConfig(num_threads=1,
                                   device="cpu")).tokenize_stream(data)
    pcts = [ph.picture_coding_type for _, _, ph in jt]
    return jt, tt, pcts


def _recons(jt, tt, chunk, scat_u16=True, pallas=False, field=False):
    jr = JaxGopRecon(jt[0][1], chunk, field_support=field,
                     use_pallas_idct=pallas, use_pallas_mc=pallas,
                     pallas_interpret=pallas)
    tr = GopRecon(tt[0][1], chunk, "cpu", field_support=field)
    # the int32 block-index form is taken by pictures wider than ~2.7K;
    # forcing it here covers that layout at a small size
    jr._scat_u16 = tr._scat_u16 = scat_u16
    return jr, tr


CASES = [(1, 0, 1, True), (4, 0, 4, True), (4, 3, 3, True),
         (4, 1, 4, False)]


@pytest.mark.parametrize("chunk,start,t,scat_u16", CASES)
def test_prepare_blob_byte_identical(chunk, start, t, scat_u16):
    jt, tt, pcts = _tokens(101)
    jr, tr = _recons(jt, tt, chunk, scat_u16)
    sel = slice(start, start + t)
    (jkey, jblob) = jr.prepare([x[0] for x in jt[sel]], pcts[sel])
    (tkey, tblob, n) = tr.prepare([x[0] for x in tt[sel]], pcts[sel])
    assert n == t and tkey == jkey[:2]
    assert jblob.dtype == tblob.dtype == np.uint8
    assert jblob.tobytes() == tblob.tobytes()


# int16 values at and next to the type's ends
ENDS = np.array([32767, -32768, 32766, -32767], np.int16)


def _edit(jt, tt, i, edit):
    """The same edit of picture ``i``'s tokens in both packages' lists:
    ``"no_coded"`` takes its coded blocks away, ``"full_row"`` makes its
    first coded row all 64 coefficients, at int16's ends."""
    for toks in (jt, tt):
        tok = toks[i][0]
        if edit == "no_coded":
            tok.n_coded_blocks = 0
        elif edit == "full_row":
            assert tok.n_coded_blocks > 0
            tok.cblk[0] = np.resize(ENDS, 64)
            tok.row_nnz[0] = 64


# CASES (by their old ids), then a short chunk of 8 in both block-position
# forms, a picture with no coded block inside a chunk and as a chunk of
# one, and a row with all 64 coefficients nonzero
DECODE_CASES = [pytest.param(*c, None, id="-".join(map(str, c)))
                for c in CASES] + [
    pytest.param(8, 0, 7, True, None, id="8-0-7-True-short"),
    pytest.param(8, 0, 7, False, None, id="8-0-7-False-short"),
    pytest.param(4, 0, 4, True, "no_coded", id="4-0-4-True-no_coded"),
    pytest.param(1, 2, 1, False, "no_coded", id="1-2-1-False-no_coded"),
    pytest.param(4, 1, 4, False, "full_row", id="4-1-4-False-full_row"),
]


@pytest.mark.parametrize("chunk,start,t,scat_u16,edit", DECODE_CASES)
def test_decode_blob_equal(chunk, start, t, scat_u16, edit):
    jt, tt, pcts = _tokens(102)
    jr, tr = _recons(jt, tt, chunk, scat_u16)
    sel = slice(start, start + t)
    if edit:
        _edit(jt, tt, start + (t > 1), edit)
    (cap_pairs, cap_k, _), blob = jr.prepare([x[0] for x in jt[sel]],
                                             pcts[sel])
    want = jr._decode_blob(jnp.asarray(blob), cap_pairs=cap_pairs,
                           cap_k=cap_k)
    got = tr._decode_blob(torch.from_numpy(blob.copy()),
                          cap_pairs=cap_pairs, cap_k=cap_k)
    for name, g, w in zip(("dense", "meta", "flags"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("scat_u16", [True, False])
def test_chunk_output_matches_pallas(scat_u16):
    """A 4-picture I P B P chunk (with field-DCT MBs) from zero references:
    packed output and the carried reference pictures are equal."""
    jt, tt, pcts = _tokens(103, fpfd=False)
    assert any(t.dct_type.any() for t, _, _ in tt[:4])
    jr, tr = _recons(jt, tt, 4, scat_u16, pallas=True)
    j0, j1, jpacks = jr.dispatch(jr.prepare([x[0] for x in jt[:4]],
                                            pcts[:4]), bidir=True)
    t0, t1, tpacks = tr.dispatch(tr.prepare([x[0] for x in tt[:4]],
                                            pcts[:4]), bidir=True)
    np.testing.assert_array_equal(tpacks.numpy(), np.asarray(jpacks)[:4])
    for g, w in zip((*t0, *t1), (*j0, *j1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CHROMA = [H.CHROMA_420, H.CHROMA_422, H.CHROMA_444]


@pytest.mark.parametrize("scat_u16", [True, False])
@pytest.mark.parametrize("cf", CHROMA)
def test_field_blob_byte_identical(cf, scat_u16):
    """The 9-column form (all 8 MVs + field selects in the flags) moves
    every later section; the blob is JAX's byte for byte."""
    jt, tt, pcts = _tokens(110 + cf, cf=cf, **FIELD)
    assert any(t.field_pred.any() for t, _, _ in tt[:4])
    jr, tr = _recons(jt, tt, 4, scat_u16, field=True)
    (jkey, jblob) = jr.prepare([x[0] for x in jt[:4]], pcts[:4])
    (tkey, tblob, n) = tr.prepare([x[0] for x in tt[:4]], pcts[:4])
    assert n == 4 and tkey == jkey[:2]
    assert len(tblob) == tr._layout(*tkey)[-1]
    assert jblob.tobytes() == tblob.tobytes()


# every chroma format in both block-position forms (by their old ids),
# then each with a picture with no coded block and with a full row
FIELD_DECODE_CASES = [
    pytest.param(cf, u16, None, id=f"{cf}-{u16}")
    for cf in CHROMA for u16 in (True, False)] + [
    pytest.param(cf, u16, edit, id=f"{cf}-{u16}-{edit}")
    for cf in CHROMA for u16, edit in ((True, "no_coded"),
                                       (False, "full_row"))]


@pytest.mark.parametrize("cf,scat_u16,edit", FIELD_DECODE_CASES)
def test_field_decode_blob_equal(cf, scat_u16, edit):
    jt, tt, pcts = _tokens(120 + cf, cf=cf, **FIELD)
    jr, tr = _recons(jt, tt, 4, scat_u16, field=True)
    if edit:
        _edit(jt, tt, 2, edit)
    (cap_pairs, cap_k, _), blob = jr.prepare([x[0] for x in jt[1:4]],
                                             pcts[1:4])
    want = jr._decode_blob(jnp.asarray(blob), cap_pairs=cap_pairs,
                           cap_k=cap_k)
    got = tr._decode_blob(torch.from_numpy(blob.copy()),
                          cap_pairs=cap_pairs, cap_k=cap_k)
    assert got[1].shape[-1] == 9
    for name, g, w in zip(("dense", "meta", "flags"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_frame_recon_refuses_field_mbs():
    """A frame-prediction recon's 5 metadata columns would drop the second
    unit's vectors: it refuses a chunk with field-predicted MBs."""
    _, tt, pcts = _tokens(130, **FIELD)
    assert any(t.field_pred.any() for t, _, _ in tt[:4])
    with pytest.raises(ValueError, match="field_support"):
        GopRecon(tt[0][1], 4, "cpu").prepare([x[0] for x in tt[:4]],
                                             pcts[:4])


@pytest.mark.parametrize("cf", CHROMA)
def test_field_chunk_output_matches_pallas(cf):
    """A 4-picture I P B P chunk with field motion and field DCT from zero
    references, field form (K4 in interpret mode on the JAX side): packed
    output and the carried reference pictures are equal.  4:4:4 takes the
    int32 block-index form, as it does at 1088 lines."""
    jt, tt, pcts = _tokens(140 + cf, cf=cf, **FIELD)
    assert any(t.field_pred.any() for t, _, _ in tt[:4])
    assert any(t.dct_type.any() for t, _, _ in tt[:4])
    jr, tr = _recons(jt, tt, 4, cf != H.CHROMA_444, pallas=True, field=True)
    j0, j1, jpacks = jr.dispatch(jr.prepare([x[0] for x in jt[:4]],
                                            pcts[:4]), bidir=True)
    t0, t1, tpacks = tr.dispatch(tr.prepare([x[0] for x in tt[:4]],
                                            pcts[:4]), bidir=True)
    np.testing.assert_array_equal(tpacks.numpy(), np.asarray(jpacks)[:4])
    for g, w in zip((*t0, *t1), (*j0, *j1)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cf,u16", [(H.CHROMA_420, True),
                                    (H.CHROMA_422, True),
                                    (H.CHROMA_444, False)])
def test_block_index_form_at_1088_lines(cf, u16):
    """At 1920x1088 the dense grid of 4:4:4 (97,920 blocks) no longer fits
    the uint16 index: its blob takes the int32 form, which the tests above
    force at a small size."""
    g = PictureGeometry(width=1920, height=1088, chroma_format=cf)
    assert GopRecon(g, 16, "cpu", field_support=True)._scat_u16 is u16
