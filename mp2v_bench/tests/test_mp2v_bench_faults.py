"""``correct`` comes out false when the timed path is broken underneath:
a run of each cell, past the look for a card, on the port's plain CPU
versions at a small geometry, with a fault planted in the port; and the
control (the reference with the float IDCT) fails the comparison at that
size, on several seeds.  A sound run of each cell is correct."""
import time

import numpy as np
import pytest

from mp2v_bench import check, control, reference, spec
from mp2v_bench.run import run_cell
from mp2v_bench.streams import generate

CELLS = ("hd420_offline", "hd422i_offline", "hd420_live")
SEED = 2**32 + 99
SECONDS = 1.0


def small_cell(name):
    cell = spec.cell(name)
    cell.config.update(width=64, height=40)
    return cell


def run(name):
    return run_cell(small_cell(name), SEED, SECONDS, False, device="cpu",
                    t_start=time.perf_counter())


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: each picture's
    reconstruction hands back the newer reference planes it was given."""
    from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon

    def recon(self, dense, meta, r0y, r0u, r0v, r1y, r1u, r1v, bidir=True,
              band=None):
        return r1y, r1u, r1v
    monkeypatch.setattr(DeviceRecon, "_recon_from_residual", recon)


def _half_left_out(monkeypatch):
    """Half of the pictures left out: every second picture's frame is
    never reconstructed (left zero)."""
    from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon
    orig = GopRecon._gop
    seen = [0]

    def gop(self, blob, r0, r1, **kw):
        r0, r1, packs = orig(self, blob, r0, r1, **kw)
        for i in range(len(packs)):
            if (seen[0] + i) % 2:
                packs[i] = 0
        seen[0] += len(packs)
        return r0, r1, packs
    monkeypatch.setattr(GopRecon, "_gop", gop)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: one byte of each chunk's
    first frame."""
    from tiny_mp2v_dec_tpu_torch.ops.recon import GopRecon
    orig = GopRecon._gop

    def gop(self, blob, r0, r1, **kw):
        r0, r1, packs = orig(self, blob, r0, r1, **kw)
        packs[0, 7] ^= 1
        return r0, r1, packs
    monkeypatch.setattr(GopRecon, "_gop", gop)


def _token_altered(monkeypatch):
    """A token altered where it is produced: in every picture, the first
    nonzero coefficient becomes the most distant one of the other sign,
    so that its block's pixels saturate the other way."""
    from tiny_mp2v_dec_tpu_torch.runtime import decoder
    orig = decoder.get_tokenizer

    def get_tokenizer(*a, **kw):
        tok = orig(*a, **kw)

        def tokenize(*b, **kb):
            tokens = tok(*b, **kb)
            coeffs = tokens.cblk[:tokens.n_coded_blocks]
            nz = np.argwhere(coeffs)
            if len(nz):
                row, col = nz[0]
                coeffs[row, col] = -2048 if coeffs[row, col] > 0 else 2047
            return tokens
        return tokenize
    monkeypatch.setattr(decoder, "get_tokenizer", get_tokenizer)


def _frame_dropped(monkeypatch):
    """A frame that never comes: every fifth one is not delivered."""
    from tiny_mp2v_dec_tpu_torch.runtime.decoder import MP2VDecoder
    orig = MP2VDecoder._emit
    seen = [0]

    def emit(self, pending):
        seen[0] += 1
        if seen[0] % 5:
            orig(self, pending)
    monkeypatch.setattr(MP2VDecoder, "_emit", emit)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "token_altered": _token_altered,
          "frame_dropped": _frame_dropped}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"] == {k: {"value": 0, "limit": 0}
                           for k in check.LIMITS}
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0
    # the CPU has no device trace: a metric read from it finds nothing
    assert {m["name"] for m in spec.cell(name).end_to_end
            if m["source"] != "device_trace"} == set(r["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run(name)
    assert not r["correct"]
    assert r["failed"] > 0


@pytest.mark.parametrize("config", ("mp_hl_1080_420", "422p_hl_1080_422"))
@pytest.mark.parametrize("seed", (1, 2, 3))
def test_control_is_not_correct(config, seed):
    cfg = spec.load_json(f"{spec.ROOT}/mp2v_bench/configs/{config}.json")
    cfg.update(width=64, height=40)
    r = control.reading(cfg, seed, 2)
    assert r["mismatched_bytes"] > 0

    # and through the harness's comparison, in the program's place
    import torch

    class Frame:
        def __init__(self, row):
            self.row = torch.from_numpy(row)

        def device_buffer(self):
            return self.row
    with generate.worker_pool(2) as pool:
        data = generate.make_stream(cfg, seed, pool)
    exact = reference.decode(data, 2)
    ctrl = reference.decode(data, 2, idct=control.float32_idct)
    frames = [Frame(np.ascontiguousarray(row)) for row in ctrl.frames]
    comp = check.open_loop({i: (i, [f]) for i, f in enumerate(frames)},
                           exact.frames, "cpu")
    assert not check.correct(comp.numbers())
    assert comp.numbers()["mismatched_bytes"] == r["mismatched_bytes"]
