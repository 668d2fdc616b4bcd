"""PyTorch port, K1: the IDCT against the golden model and the JAX
package's Pallas kernel (interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tiny_mp2v_dec_tpu.golden.idct import idct_blocks as golden_idct  # noqa: E402
from tiny_mp2v_dec_tpu.ops.idct import idct_blocks_pallas  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.idct import (  # noqa: E402
    idct_blocks, idct_blocks_ref)


def _coeffs(rng, n, lo=-2048, hi=2048):
    c = rng.integers(lo, hi, (n, 64)).astype(np.int16)
    c[0] = 0
    c[1] = hi - 1             # saturation stress
    c[2] = lo
    return c


def test_idct_cpu_matches_golden_and_pallas():
    coeffs = _coeffs(np.random.default_rng(1729), 700)
    got = idct_blocks(torch.from_numpy(coeffs)).numpy()
    np.testing.assert_array_equal(got, golden_idct(coeffs))
    np.testing.assert_array_equal(
        got, np.asarray(idct_blocks_pallas(coeffs, interpret=True)))


@pytest.mark.parametrize("lo,hi", [(-32768, 32768), (-256, 256)])
def test_idct_ref_matches_golden_full_range(lo, hi):
    """int16 extremes exercise every saturate and wrap of the butterfly."""
    coeffs = _coeffs(np.random.default_rng(7 + hi), 4096, lo, hi)
    got = idct_blocks_ref(torch.from_numpy(coeffs)).numpy()
    np.testing.assert_array_equal(got, golden_idct(coeffs))


def test_idct_cpu_takes_no_kernel():
    before = _build.LAUNCHES["idct8x8"]
    idct_blocks(torch.zeros((4, 64), dtype=torch.int16))
    assert _build.LAUNCHES["idct8x8"] == before


def test_idct_rejects_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        idct_blocks(torch.zeros((4, 64), dtype=torch.int16, device="meta"))

