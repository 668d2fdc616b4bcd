"""The chunk transport (``GopRecon._decode_blob``) on the CPU: a model of
the transport kernel's three launches (``transport_cases.transport_model``)
against the plain version on synthetic chunks of every chroma format and
both block-position forms, with short chunks, pictures with no coded block,
full rows at int16's ends and a block -> row scratch of stale rows; and the
dispatch by device: a CPU blob takes the plain version and launches
nothing, another device raises, and the kernel wrapper refuses blobs it
cannot read before it loads the kernel library.  The kernel itself runs in
``tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transport_cases import (staged_blob, synthetic_chunk,  # noqa: E402
                             transport_model)
from tiny_mp2v_dec_tpu_torch.ops import _build  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import recon as recon_mod  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tokenizer.types import (  # noqa: E402
    PictureGeometry)

# (chroma format, chunk, pictures, block-position form uint16, pictures
# with no coded block)
MODEL_CASES = [
    (1, 16, 16, True, ()),
    (1, 16, 11, False, (3,)),
    (2, 8, 8, True, (0, 7)),
    (2, 1, 1, False, ()),
    (3, 8, 5, True, (2,)),
    (3, 1, 1, True, (0,)),
]


def _chunk(cf, chunk, pictures, scat_u16, empty, seed):
    """A recon of 5 x 3 MBs and a prepared synthetic chunk's blob."""
    rng = np.random.default_rng(seed)
    geom = PictureGeometry(80, 48, cf)
    rec = GopRecon(geom, chunk, "cpu")
    rec._scat_u16 = scat_u16
    toks, pcts = synthetic_chunk(rng, geom, pictures, empty)
    return rng, rec, staged_blob(rec, toks, pcts)


@pytest.mark.parametrize("cf,chunk,pictures,scat_u16,empty", MODEL_CASES)
def test_transport_model_matches_plain(cf, chunk, pictures, scat_u16, empty):
    """The kernel's launches, modelled, give the plain version's grid, and
    write each of its blocks exactly once, whatever rows the block -> row
    scratch holds from before (in range and out)."""
    rng, rec, (blob, cap_pairs, cap_k) = _chunk(cf, chunk, pictures,
                                                scat_u16, empty, 7 + cf)
    span = chunk * rec.geom.n_mb * rec.geom.blocks_per_mb
    stale = rng.integers(-3, cap_k + 3, span)
    grid, writes = transport_model(rec, blob, cap_pairs, cap_k, stale)
    want = rec._decode_blob_ref(torch.from_numpy(blob), cap_pairs=cap_pairs,
                                cap_k=cap_k)[0].numpy()
    np.testing.assert_array_equal(grid, want)
    assert (writes == 1).all()


def test_cpu_blob_takes_plain_version(monkeypatch):
    """A CPU blob decodes through the plain version: the kernel wrapper is
    never called and no launch is counted."""
    _, rec, (blob, cap_pairs, cap_k) = _chunk(1, 4, 3, True, (1,), 3)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the kernel wrapper was called")

    monkeypatch.setattr(recon_mod, "transport_grid", no_kernel)
    before = dict(_build.LAUNCHES)
    got = rec._decode_blob(torch.from_numpy(blob), cap_pairs=cap_pairs,
                           cap_k=cap_k)
    want = rec._decode_blob_ref(torch.from_numpy(blob), cap_pairs=cap_pairs,
                                cap_k=cap_k)
    assert dict(_build.LAUNCHES) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_decode_blob_refuses_other_devices():
    """No kernel and no plain fallback for a blob on another device."""
    _, rec, (blob, cap_pairs, cap_k) = _chunk(1, 1, 1, True, (), 4)
    with pytest.raises(ValueError, match="no kernel"):
        rec._decode_blob(torch.from_numpy(blob).to("meta"),
                         cap_pairs=cap_pairs, cap_k=cap_k)


@pytest.mark.parametrize("kind", ["dtype", "length", "misaligned"])
def test_transport_grid_refuses_unreadable_blobs(kind):
    """The wrapper reads the blob's int16 and int32 sections in place: a
    blob of another type, one shorter than its layout, or one not 4-byte
    aligned raises before the kernel library is loaded (so on any
    device), and counts no launch."""
    _, rec, (blob, cap_pairs, cap_k) = _chunk(2, 2, 2, True, (), 5)
    layout = rec._layout(cap_pairs, cap_k)
    t = torch.from_numpy(blob)
    if kind == "dtype":
        t = t.view(torch.int16)
    elif kind == "length":
        t = t[:-4]
    else:
        t = torch.cat([torch.zeros(1, dtype=torch.uint8), t])[1:]
        assert t.data_ptr() % 4
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="transport_grid"):
        recon_mod.transport_grid(t, layout, cap_pairs=cap_pairs, cap_k=cap_k,
                                 chunk=rec.chunk,
                                 n_rows=rec.geom.n_mb * rec.geom.blocks_per_mb,
                                 scat_u16=rec._scat_u16)
    assert dict(_build.LAUNCHES) == before
