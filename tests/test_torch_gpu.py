"""PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain
PyTorch version, and the 1080p fixture decoded through the kernels.

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

from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.idct import (  # noqa: E402
    idct_blocks, idct_blocks_ref)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "bench_1080p_420_16")


def _require_cuda():
    """Skip unless torch finds a CUDA device (decided at run time, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_idct_kernel_matches_plain():
    dev = _require_cuda()
    rng = np.random.default_rng(3)
    c = rng.integers(-2048, 2048, (70000, 64)).astype(np.int16)
    c[0], c[1], c[2] = 0, 2047, -2048
    x = torch.from_numpy(c).to(dev)
    before = _build.LAUNCHES["idct8x8"]
    got = idct_blocks(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["idct8x8"] == before + 1
    assert torch.equal(got, idct_blocks_ref(x))


def _mc_case(dev, seed, H, W, tile, n_planes):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    mbh, mbw = H // tile, W // tile
    n = mbh * mbw
    mb_y, mb_x = np.divmod(np.arange(n), mbw)
    pos = (t((mb_y * tile).astype(np.int32)), t((mb_x * tile).astype(np.int32)))
    mv = t(rng.integers(-64, 64, (n, 2, 2)).astype(np.int16))
    meta = [*mc_fused.mc_meta(*pos, mv[:, 0, 0], mv[:, 0, 1], H, W, tile, tile),
            *mc_fused.mc_meta(*pos, mv[:, 1, 0], mv[:, 1, 1], H, W, tile, tile),
            t(rng.permutation(np.arange(n) % 8).astype(np.int32))]
    plane = lambda: t(rng.integers(0, 256, (H, W)).astype(np.uint8))  # noqa
    res = [t(rng.integers(-300, 300, (H, W)).astype(np.int16))
           for _ in range(n_planes)]
    return ([plane() for _ in range(n_planes)],
            [plane() for _ in range(n_planes)], res, meta)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
def test_mc_luma_kernel_matches_plain(bidir):
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 13, 1088, 1920, 16, 1)
    got = mc_fused.fused_mc_recon(r0[0], r1[0], res[0], *meta, bidir=bidir)
    want = mc_fused.fused_mc_recon_ref(r0[0], r1[0], res[0], *meta,
                                       h=16, w=16, bidir=bidir)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bidir", [True, False])
def test_mc_uv_kernel_matches_plain(bidir):
    dev = _require_cuda()
    r0, r1, res, meta = _mc_case(dev, 14, 544, 960, 8, 2)
    args = (tuple(r0), tuple(r1), tuple(res), *meta)
    got = mc_fused.fused_mc_recon_uv(*args, bidir=bidir)
    want = mc_fused.fused_mc_recon_uv_ref(*args, h=8, w=8, bidir=bidir)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_decode_fixture_through_kernels():
    _require_cuda()
    with open(FIXTURE + ".m2v", "rb") as f:
        data = f.read()
    with open(FIXTURE + ".json") as f:
        want = json.load(f)
    dec = MP2VDecoder(DecoderConfig(gop_chunk=16, output_host=False,
                                    pictures_pool_size=0, device="cuda"))
    before = dict(_build.LAUNCHES)
    frames = dec.decode(data)
    h = hashlib.sha256()
    for f in frames:
        h.update(f.tobytes())
    assert h.hexdigest() == want["yuv_sha256"]
    for name in ("idct8x8", "mc_recon_luma", "mc_recon_uv"):
        assert _build.LAUNCHES[name] > before.get(name, 0), name
