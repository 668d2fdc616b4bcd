"""PyTorch port, the host reference: the port's copies of the VLC tables and
LUTs, the golden IDCT, the Python tokenizer and the golden decoder, each
held exactly to its JAX package counterpart on seeded inputs, the Python
tokenizer also to the port's native tokenizer, and the golden decoder
also to the port's ``MP2VDecoder`` on the CPU."""
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from m2v_encoder import encode_stream, random_picture  # noqa: E402
from torch_parity import ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden import decoder as jax_golden  # noqa: E402
from tiny_mp2v_dec_tpu.golden import idct as jax_idct  # noqa: E402
from tiny_mp2v_dec_tpu.tokenizer import types as jax_types  # noqa: E402
from tiny_mp2v_dec_tpu.vlc import lut as jax_lut  # noqa: E402
from tiny_mp2v_dec_tpu.vlc import tables as jax_tables  # noqa: E402
import tiny_mp2v_dec_tpu_torch as P  # noqa: E402
from tiny_mp2v_dec_tpu_torch import headers as PH  # noqa: E402
from tiny_mp2v_dec_tpu_torch.golden import decoder as port_golden  # noqa: E402
from tiny_mp2v_dec_tpu_torch.golden import idct as port_idct  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tokenizer import (  # noqa: E402
    get_tokenizer, python_tokenizer)
from tiny_mp2v_dec_tpu_torch.tokenizer import types as port_types  # noqa: E402
from tiny_mp2v_dec_tpu_torch.vlc import lut as port_lut  # noqa: E402
from tiny_mp2v_dec_tpu_torch.vlc import tables as port_tables  # noqa: E402

CFS = (H.CHROMA_420, H.CHROMA_422, H.CHROMA_444)
PCTS = (H.PCT_I, H.PCT_P, H.PCT_B)
# the feature matrix of tests/test_golden_decode.py
FEATURES = [
    dict(q_scale_type=1), dict(intra_vlc_format=1), dict(alternate_scan=1),
    dict(intra_dc_precision=2), dict(fpfd=False),
    dict(fpfd=False, allow_field_motion=True),
]
TOKEN_VECTORS = ("intra", "fwd", "bwd", "field_pred", "dct_type", "mv",
                 "mvfs", "coded")


def _data_names(mod):
    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_") and k != "annotations"
                  and not isinstance(v, (types.ModuleType,
                                         types.FunctionType, type)))


def _assert_same(a, b, where):
    """Equal values of equal types, ndarrays with equal dtypes, through
    dicts, lists and tuples."""
    assert type(a) is type(b), where
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", _data_names(jax_tables))
def test_vlc_table_equals_jax(name):
    _assert_same(getattr(jax_tables, name), getattr(port_tables, name), name)


@pytest.mark.parametrize("name", _data_names(jax_lut))
def test_vlc_lut_equals_jax(name):
    _assert_same(getattr(jax_lut, name), getattr(port_lut, name), name)


def test_vlc_modules_hold_the_same_names():
    assert _data_names(port_tables) == _data_names(jax_tables)
    assert _data_names(port_lut) == _data_names(jax_lut)
    # build_lut gives the same tables on the same entries
    entries = [(code, n, v) for v, (code, n) in port_tables.CBP.items()]
    _assert_same(jax_lut.build_lut(entries, 9),
                 port_lut.build_lut(entries, 9), "build_lut")


def _idct_inputs(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "intra-dc":
        # intra DC alone reaches +-2040 on real streams
        x = np.zeros((256, 64), np.int16)
        x[:, 0] = rng.choice([-2040, 2040, -2048, 2047, 1024], 256)
        x[:, 1:] = rng.integers(-64, 65, (256, 63))
        return x
    if case == "wrap":
        # the int16 wraparound inputs of tests/test_idct_golden.py
        return np.random.default_rng(7).integers(
            -2048, 2048, (64, 64)).astype(np.int16)
    if case == "full-range":
        return rng.integers(-32768, 32768, (512, 64)).astype(np.int16)
    if case == "basis":
        x = np.zeros((64, 64), np.int16)
        x[np.arange(64), np.arange(64)] = 1000
        return x
    return rng.integers(-300, 301, (4, 3, 64)).astype(np.int16)


@pytest.mark.parametrize("case", ["intra-dc", "wrap", "full-range", "basis",
                                  "batched"])
def test_golden_idct_equals_jax(case):
    x = _idct_inputs(case)
    got = port_idct.idct_blocks(x)
    assert got.dtype == np.int16 and got.shape == x.shape[:-1] + (8, 8)
    np.testing.assert_array_equal(got, jax_idct.idct_blocks(x))
    np.testing.assert_array_equal(port_idct.float_idct_blocks(x),
                                  jax_idct.float_idct_blocks(x))


def _pictures(data, hdr, tmod):
    """Walk ``data`` as the golden model does and return each picture's
    ``(slices, params, geom)``, the params and geometry made from the
    classes of ``hdr`` (a headers module) and ``tmod`` (a tokenizer types
    module), quant matrix extensions included."""
    out = []
    seq, sext, qmext, cur = None, hdr.SequenceExtension(), None, None

    def finish():
        pcext = cur["pcext"]
        geom = tmod.PictureGeometry(
            seq.horizontal_size_value
            | (sext.horizontal_size_extension << 12),
            seq.vertical_size_value | (sext.vertical_size_extension << 12),
            sext.chroma_format)
        params = tmod.PictureParams(
            picture_coding_type=cur["header"].picture_coding_type,
            f_code=pcext.f_code,
            intra_dc_precision=pcext.intra_dc_precision,
            picture_structure=pcext.picture_structure,
            frame_pred_frame_dct=pcext.frame_pred_frame_dct,
            concealment_motion_vectors=pcext.concealment_motion_vectors,
            q_scale_type=pcext.q_scale_type,
            intra_vlc_format=pcext.intra_vlc_format,
            alternate_scan=pcext.alternate_scan,
            chroma_format=sext.chroma_format, vertical_size=geom.height,
            quant_matrices=hdr.build_quant_matrices(seq, qmext))
        out.append((cur["slices"], params, geom))

    for off in port_golden.scan_start_codes(data):
        off = int(off)
        code = data[off + 3]
        r_pos = (off + 4) * 8
        if code == hdr.SEQUENCE_HEADER_CODE:
            seq = hdr.SequenceHeader.parse(hdr.BitReader(data, r_pos))
            qmext = None
        elif code == hdr.EXTENSION_START_CODE:
            r = hdr.BitReader(data, r_pos)
            ext_id = r.read(4)
            if ext_id == hdr.SEQUENCE_EXTENSION_ID:
                sext = hdr.SequenceExtension.parse(r)
            elif ext_id == hdr.PICTURE_CODING_EXTENSION_ID and cur:
                cur["pcext"] = hdr.PictureCodingExtension.parse(r)
            elif ext_id == hdr.QUANT_MATRIX_EXTENSION_ID:
                qmext = hdr.QuantMatrixExtension.parse(r)
        elif code == hdr.PICTURE_START_CODE:
            if cur:
                finish()
            ph = hdr.PictureHeader.parse(hdr.BitReader(data, r_pos))
            cur = {"header": ph, "slices": [],
                   "pcext": hdr.PictureCodingExtension(f_code=(
                       (ph.forward_f_code, ph.forward_f_code),
                       (ph.backward_f_code, ph.backward_f_code)))}
        elif hdr.SLICE_START_CODE_MIN <= code <= hdr.SLICE_START_CODE_MAX \
                and cur:
            cur["slices"].append((r_pos, code))
    if cur:
        finish()
    return out


def _jax_python_tokenize(data, slices, params, geom, on_error="raise"):
    """The JAX package's ``_python_tokenizer``, called as its own
    ``tokenizer/__init__.py`` calls it."""
    from tiny_mp2v_dec_tpu.tokenizer import _python_tokenizer
    return _python_tokenizer(on_error)(data, slices, params, geom)


def _assert_tokens_equal(a, b, where, sparse=True):
    """Every array of two ``PictureTokens``: the sparse rows in order when
    ``sparse`` (both from Python tokenizers), else the scattered dense
    coefficients (the native tokenizer claims rows in its own order)."""
    assert a.n_coded_blocks == b.n_coded_blocks, where
    assert a.bad_slices == b.bad_slices, where
    n = a.n_coded_blocks
    if sparse:
        np.testing.assert_array_equal(a.cblk[:n], b.cblk[:n],
                                      err_msg=f"{where}: cblk")
        np.testing.assert_array_equal(a.cblk_idx[:n], b.cblk_idx[:n],
                                      err_msg=f"{where}: cblk_idx")
    np.testing.assert_array_equal(a.dense_coeff(), b.dense_coeff(),
                                  err_msg=f"{where}: dense")
    for name in TOKEN_VECTORS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=f"{where}: {name}")


def _tokenize_three_ways(data, where, on_error="raise"):
    """Each picture of ``data`` through the JAX Python tokenizer, the
    port's and the port's native one (one thread: a fixed row order);
    asserts all three agree.  Returns the port's Python tokens."""
    jax_pics = _pictures(data, H, jax_types)
    port_pics = _pictures(data, PH, port_types)
    py = python_tokenizer(on_error)
    native = get_tokenizer(num_threads=1, on_error=on_error)
    out = []
    for i, (jp, pp) in enumerate(zip(jax_pics, port_pics)):
        want = _jax_python_tokenize(data, *jp, on_error=on_error)
        got = py(data, *pp)
        _assert_tokens_equal(want, got, f"{where} picture {i}")
        _assert_tokens_equal(got, native(data, *pp),
                             f"{where} picture {i} native", sparse=False)
        out.append(got)
    return out


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("pct", PCTS)
def test_python_tokenizer_equals_jax_and_native(cf, pct):
    rng = np.random.default_rng(4100 + 10 * cf + pct)
    pics = [random_picture(rng, 4, 3, cf, H.PCT_I)]
    if pct != H.PCT_I:
        pics.append(random_picture(rng, 4, 3, cf, pct))
    data = encode_stream(64, 48, cf, pics)
    tokens = _tokenize_three_ways(data, f"cf={cf} pct={pct}")
    assert len(tokens) == len(pics)
    assert tokens[-1].n_coded_blocks > 0


@pytest.mark.parametrize("opts", FEATURES + [
    dict(fpfd=False, allow_field_motion=True, cf=H.CHROMA_422),
    dict(intra_dc_precision=3), dict(cmv=1)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_python_tokenizer_features_equal_jax_and_native(opts):
    """Field motion, field DCT and the picture coding extension's options
    (concealment vectors in an I picture)."""
    opts = dict(opts)
    cf = opts.pop("cf", H.CHROMA_420)
    rng = np.random.default_rng(sum(map(ord, str(opts))) * 11 + cf)
    pcts = [H.PCT_I] if "cmv" in opts else list(PCTS)
    pics = [random_picture(rng, 4, 3, cf, pct, **opts) for pct in pcts]
    data = encode_stream(64, 48, cf, pics)
    tokens = _tokenize_three_ways(data, str(opts))
    if opts.get("allow_field_motion"):
        assert any(t.field_pred.any() for t in tokens)
    if opts.get("fpfd") is False:
        assert any(t.dct_type.any() for t in tokens)


def _garbage(seed):
    """``tests/test_tokenizer_fuzz.py``'s garbage-slice case: a picture's
    slice positions over random bytes."""
    rng = np.random.default_rng(100 + seed)
    pic = random_picture(rng, 3, 3, H.CHROMA_420, H.PCT_I)
    data = encode_stream(48, 48, H.CHROMA_420, [pic])
    garbage = bytes(rng.integers(0, 256, len(data), dtype=np.uint8))
    return data, garbage


def _outcome(fn):
    try:
        return fn(), None
    except (ValueError, IndexError) as e:
        return None, type(e)


@pytest.mark.parametrize("on_error", ["raise", "drop_slice"])
@pytest.mark.parametrize("seed", range(8))
def test_python_tokenizer_garbage_equals_jax(seed, on_error):
    """Random bytes at the slice positions: the port's Python tokenizer
    raises where the JAX one raises, with the same exception type, and
    otherwise gives the same tokens and ``bad_slices``.  The native
    tokenizer raises on the same pictures under "raise"; under
    "drop_slice" it never raises, and where the Python tokenizers finish
    it drops the same slices.  (The Python tokenizers contain only a
    ``ValueError``: a sparse-row overflow, an ``IndexError``, ends the
    picture under either policy, seeds 0-6 here, in both packages.)"""
    data, garbage = _garbage(seed)
    (jp,), (pp,) = _pictures(data, H, jax_types), _pictures(data, PH,
                                                            port_types)
    want, want_err = _outcome(
        lambda: _jax_python_tokenize(garbage, *jp, on_error=on_error))
    got, got_err = _outcome(
        lambda: python_tokenizer(on_error)(garbage, *pp))
    assert got_err is want_err
    nat, nat_err = _outcome(
        lambda: get_tokenizer(num_threads=1, on_error=on_error)(garbage,
                                                                *pp))
    if on_error == "raise":
        assert got_err is not None and nat_err is ValueError
        return
    assert nat_err is None and nat.bad_slices > 0
    if want is not None:
        _assert_tokens_equal(want, got, f"seed {seed} {on_error}")
        _assert_tokens_equal(got, nat, f"seed {seed} native", sparse=False)
    else:
        assert got_err is IndexError


def test_python_tokenizer_is_never_a_fallback(monkeypatch):
    """``get_tokenizer`` raises when the native library cannot be loaded,
    instead of taking the Python tokenizer; ``python_tokenizer`` takes the
    same ``on_error`` values."""
    from tiny_mp2v_dec_tpu_torch.tokenizer import native

    def broken():
        raise OSError("no library")

    monkeypatch.setattr(native, "_load", broken)
    with pytest.raises(OSError):
        get_tokenizer()
    with pytest.raises(ValueError):
        python_tokenizer("ignore")


def _frames_equal(a, b, where):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.tobytes() == y.tobytes(), f"{where} frame {i}"
        assert x.temporal_reference == y.temporal_reference, where
        assert x.picture_coding_type == y.picture_coding_type, where


@pytest.mark.parametrize("reordering", [True, False])
@pytest.mark.parametrize("cf", CFS)
def test_golden_decoder_equals_jax(cf, reordering):
    data = ipb_stream(np.random.default_rng(4200 + cf), 3, 2, cf)
    got = P.decode_stream_golden(data, reordering=reordering)
    _frames_equal(jax_golden.decode_stream(data, reordering=reordering),
                  got, f"cf={cf}")
    assert isinstance(got[0], P.DecodedFrame)
    order = [f.temporal_reference for f in got]
    assert order == (sorted(order) if reordering else [0, 2, 1, 4, 3])


@pytest.mark.parametrize("opts", FEATURES,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_golden_decoder_feature_matrix_equals_jax(opts):
    rng = np.random.default_rng(sum(map(ord, str(opts))))
    pics = [random_picture(rng, 3, 2, H.CHROMA_420, pct, **opts)
            for pct in (H.PCT_I, H.PCT_P, H.PCT_B)]
    for p, tr in zip(pics, (0, 2, 1)):
        p.temporal_reference = tr
    data = encode_stream(48, 32, H.CHROMA_420, pics)
    for reordering in (True, False):
        _frames_equal(jax_golden.decode_stream(data, reordering=reordering),
                      port_golden.decode_stream(data, reordering=reordering),
                      f"{opts} reordering={reordering}")


def test_golden_tokenize_stream_equals_jax():
    data = ipb_stream(np.random.default_rng(4300), 3, 2, H.CHROMA_422,
                      fpfd=False, allow_field_motion=True)
    want = jax_golden.GoldenDecoder().tokenize_stream(data)
    got = port_golden.GoldenDecoder().tokenize_stream(data)
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(want, got)):
        _assert_tokens_equal(a, b, f"picture {i}")


@pytest.mark.parametrize("gop_chunk", [0, 4])
@pytest.mark.parametrize("cf", CFS)
def test_golden_decoder_equals_the_ports_decoder(cf, gop_chunk):
    """The port's own reference against its decoder on the CPU: the same
    frames in the same order."""
    data = ipb_stream(np.random.default_rng(4400 + cf), 3, 2, cf,
                      fpfd=False, allow_field_motion=True)
    golden = P.decode_stream_golden(data)
    dec = P.MP2VDecoder(P.DecoderConfig(gop_chunk=gop_chunk, device="cpu"))
    _frames_equal(golden, dec.decode(data), f"cf={cf} chunk={gop_chunk}")


def test_package_exports_the_jax_names():
    import tiny_mp2v_dec_tpu as J
    assert set(J.__all__) | {"PictureGeometry"} == set(P.__all__)
    for name in ("CHROMA_420", "CHROMA_422", "CHROMA_444", "PCT_I", "PCT_P",
                 "PCT_B", "__version__"):
        assert getattr(P, name) == getattr(J, name), name
    assert P.decode_stream_golden is port_golden.decode_stream
    # one definition of the start-code scan, shared with the runtime
    from tiny_mp2v_dec_tpu_torch.runtime import decoder as runtime
    assert runtime.scan_start_codes is port_golden.scan_start_codes
