"""PyTorch port, GOP-chunk transport and reconstruction against the JAX
package's GopRecon: the prepared blob byte for byte, the decoded blob, and
a 4-picture chunk's output (Pallas kernels in interpret mode)."""
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
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402

IPBPB_B = ((H.PCT_I, 0), (H.PCT_P, 2), (H.PCT_B, 1), (H.PCT_P, 4),
           (H.PCT_B, 3), (H.PCT_P, 6), (H.PCT_B, 5))


def _tokens(seed, mb_w=3, mb_h=2, **opts):
    """One random stream tokenized by both packages' native tokenizers.
    One tokenizer thread each: with several, slices claim coefficient rows
    in scheduling order, and the blob's row order with them."""
    data = ipb_stream(np.random.default_rng(seed), mb_w, mb_h,
                      H.CHROMA_420, IPBPB_B, **opts)
    jt = JaxDecoder(JaxConfig(num_threads=1)).tokenize_stream(data)
    tt = MP2VDecoder(DecoderConfig(num_threads=1,
                                   device="cpu")).tokenize_stream(data)
    pcts = [ph.picture_coding_type for _, _, ph in jt]
    return jt, tt, pcts


def _recons(jt, tt, chunk, scat_u16=True, pallas=False):
    jr = JaxGopRecon(jt[0][1], chunk, field_support=False,
                     use_pallas_idct=pallas, use_pallas_mc=pallas,
                     pallas_interpret=pallas)
    tr = GopRecon(tt[0][1], chunk, "cpu")
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


@pytest.mark.parametrize("chunk,start,t,scat_u16", CASES)
def test_decode_blob_equal(chunk, start, t, scat_u16):
    jt, tt, pcts = _tokens(102)
    jr, tr = _recons(jt, tt, chunk, scat_u16)
    sel = slice(start, start + t)
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
