"""PyTorch port, the serving path's counters and spans on the CPU:
``decode_batch`` times each step's prepare into ``fill_s`` (span
``prepare``) apart from its upload and enqueue (``device_s``, span
``dispatch``), its tokenize phase into ``batch_tokenize_s`` (span
``batch_tokenize``), counts its steps and no-op pictures, and reckons the
bytes its output stack and reference picks write from the step flags and
plane shapes; the chunk and latency paths keep their counters, the new
ones at 0.  Every path counts its MC launches: one a step of the batch, a
picture live, a group of pictures that read no output of one another in a
chunk.  Imports neither ``jax`` nor ``tiny_mp2v_dec_tpu``."""
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_batch_golden import (UNEQUAL, batch_config,  # noqa: E402
                                     batch_streams)
from mp2v_bench import spec  # noqa: E402
from mp2v_bench.streams import generate  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch import headers as H  # noqa: E402

# the counters of every path before decode_batch had its own
KEPT = {"pictures", "tokenize_s", "fill_s", "device_s", "output_s",
        "bad_slices", "slot_wait_s", "fill_wait_s", "chunk_wait_s"}
BATCH = {"batch_tokenize_s", "batch_steps", "noop_pictures",
         "batch_copy_bytes"}
# the counters of every path since
EVERY = {"mc_launches", "coded_blocks", "coded_bytes"}


def _decoder(**kw):
    return MP2VDecoder(DecoderConfig(device="cpu", num_threads=1, **kw))


def _durations(records, name):
    return sum(r[4] - r[3] for r in records if r[0] == name) / 1e9


def test_prepare_is_timed_apart_from_dispatch():
    streams = batch_streams()
    dec = _decoder()
    dec.spans.start()
    t0 = time.time_ns()
    dec.decode_batch(streams)
    wall = (time.time_ns() - t0) / 1e9
    records = dec.spans.stop()
    s = dec.stats
    assert s["fill_s"] > 0 and s["device_s"] > 0
    prepare = {r[2]: r for r in records if r[0] == "prepare"}
    dispatch = {r[2]: r for r in records if r[0] == "dispatch"}
    assert sorted(prepare) == sorted(dispatch) == list(range(16))
    for step in range(16):
        # a step's prepare ends before its dispatch starts, and its
        # dispatch before the next step's prepare
        assert prepare[step][4] <= dispatch[step][3]
        if step + 1 < 16:
            assert dispatch[step][4] <= prepare[step + 1][3]
    for key, name in (("fill_s", "prepare"), ("device_s", "dispatch"),
                      ("batch_tokenize_s", "batch_tokenize")):
        assert _durations(records, name) == pytest.approx(
            s[key], rel=1e-9, abs=1e-9)
    (tok,) = [r for r in records if r[0] == "batch_tokenize"]
    assert tok[2] == 0 and tok[4] <= min(r[3] for r in prepare.values())
    assert 0 < s["batch_tokenize_s"] <= wall
    # the tokenize phase holds the shells' tokenizer calls
    assert all(tok[3] <= r[3] and r[4] <= tok[4]
               for r in records if r[0] == "tokenize")


def test_batch_tokenize_unit_is_the_call():
    dec = _decoder()
    dec.spans.start()
    streams = batch_streams()[:2]
    for _ in range(2):
        dec.decode_batch(streams)
    records = dec.spans.stop()
    assert [r[2] for r in records if r[0] == "batch_tokenize"] == [0, 1]
    dec.reset()
    assert dec.stats["batch_tokenize_s"] == 0


def _padded_plane_bytes(config) -> int:
    """One stream's padded Y, U and V bytes at 4:2:0, from the
    configuration's size."""
    h = (config["height"] + 15) // 16 * 16
    w = (config["width"] + 15) // 16 * 16
    return h * w + 2 * (h // 2) * (w // 2)


@pytest.mark.parametrize("mesh_devices", [0, 3])
@pytest.mark.parametrize("lengths", [None, UNEQUAL], ids=["equal", "unequal"])
def test_steps_noop_pictures_and_copy_bytes(lengths, mesh_devices):
    """Three shards of 8 streams pad the stream axis with a ninth, no-op
    stream."""
    config = batch_config(lengths)
    types = [generate.picture_types(c) for c in spec.channels(config)]
    dec = _decoder(mesh_devices=mesh_devices)
    dec.decode_batch(batch_streams(lengths))
    n_streams = 9 if mesh_devices == 3 else 8
    steps = max(map(len, types))
    s = dec.stats
    assert s["batch_steps"] == steps
    # one MC launch a shard a step
    assert s["mc_launches"] == steps * (mesh_devices or 1)
    assert s["noop_pictures"] == n_streams * steps - sum(map(len, types))
    want = 0
    for step in range(steps):
        # a no-op picture (past a stream's end, or a padding stream) is B
        ip = [step < len(t) and t[step] != H.PCT_B for t in types]
        ip += [False] * (n_streams - len(types))
        mixed = any(ip) and not all(ip)
        want += n_streams * _padded_plane_bytes(config) * (3 if mixed else 1)
    assert s["batch_copy_bytes"] == want


@pytest.mark.parametrize("gop_chunk", [0, 4])
def test_chunk_and_latency_counters_as_before(gop_chunk):
    data = batch_streams()[0]
    dec = _decoder(gop_chunk=gop_chunk)
    frames = dec.decode(data)
    s = dec.stats
    assert set(s) == KEPT | BATCH | EVERY
    assert all(s[k] == 0 for k in BATCH)
    assert s["pictures"] == len(frames) == 16
    # live, a launch a picture; in a chunk, a launch for each I/P picture
    # (which closes its group) and one for B pictures the chunk ends on
    types = generate.picture_types(spec.channels(batch_config(None))[0])
    size = gop_chunk or 1
    chunks = [types[k:k + size] for k in range(0, 16, size)]
    assert s["mc_launches"] == sum(
        sum(t != H.PCT_B for t in c) + (c[-1] == H.PCT_B) for c in chunks)
    assert s["tokenize_s"] > 0 and s["fill_s"] > 0 and s["device_s"] > 0


# every path of the decoder, by its configuration
SEAM_PATHS = {"chunk": dict(gop_chunk=4), "live": dict(gop_chunk=0),
              "rows": dict(mesh="rows", mesh_devices=2), "batch": {}}


def _decode_bytes(path):
    streams = batch_streams()
    dec = _decoder(**SEAM_PATHS[path])
    if path == "batch":
        frames = [f for stream in dec.decode_batch(streams) for f in stream]
    else:
        frames = dec.decode(streams[0])
    return dec, [f.tobytes() for f in frames]


@pytest.mark.parametrize("path", sorted(SEAM_PATHS))
def test_every_picture_passes_recon_from_residual(path, monkeypatch):
    """``DeviceRecon._recon_from_residual`` is the seam through which each
    picture (each band in ``mesh="rows"``) is reconstructed, grouped or
    not: a recon that hands back its newer reference there leaves the
    decode's state unchanged, and every picture's call reaches it."""
    from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon
    _, sound = _decode_bytes(path)
    orig = DeviceRecon._recon_from_residual
    calls = [0]

    def counted(self, *a, **kw):
        calls[0] += 1
        return orig(self, *a, **kw)
    monkeypatch.setattr(DeviceRecon, "_recon_from_residual", counted)
    dec, again = _decode_bytes(path)
    assert again == sound
    pictures = (dec.stats["batch_steps"] * 8 if path == "batch"
                else dec.stats["pictures"] * (2 if path == "rows" else 1))
    assert calls[0] == pictures

    def unchanged(self, dense, meta, r0y, r0u, r0v, r1y, r1u, r1v,
                  bidir=True, band=None):
        return r1y, r1u, r1v
    monkeypatch.setattr(DeviceRecon, "_recon_from_residual", unchanged)
    _, faulty = _decode_bytes(path)
    assert len(faulty) == len(sound) and faulty != sound
