"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; every
comparison is exact, because all of the decoder's arithmetic is integer.
"""
import numpy as np

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import headers as H

# decode-order picture types and temporal references of an IPBPB stream
IPBPB = ((H.PCT_I, 0), (H.PCT_P, 2), (H.PCT_B, 1), (H.PCT_P, 4),
         (H.PCT_B, 3))


def ipb_stream(rng, mb_w, mb_h, cf, pictures=IPBPB, **opts) -> bytes:
    """A random stream with the given (picture type, temporal reference)
    sequence (the recipe of test_pallas_kernels._ipb_stream)."""
    pics = []
    for pct, tr in pictures:
        p = random_picture(rng, mb_w, mb_h, cf, pct, **opts)
        p.temporal_reference = tr
        pics.append(p)
    return encode_stream(mb_w * 16, mb_h * 16, cf, pics)


def assert_frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for i, (a, b) in enumerate(zip(fa, fb)):
        np.testing.assert_array_equal(a.y, b.y, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(a.u, b.u, err_msg=f"frame {i} U")
        np.testing.assert_array_equal(a.v, b.v, err_msg=f"frame {i} V")

