"""PyTorch port, the measurement tools on the CPU: the kernel gate's and
the MC profiler's formulations (``tiny_mp2v_dec_tpu_torch/tools/``), the
recons' plain-version switches the gate uses, and both tools' refusal to
measure without a card.  All comparisons are exact."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity import ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.ops import mc as jmc  # noqa: E402
from tiny_mp2v_dec_tpu_torch import (DecoderConfig, MP2VDecoder,  # noqa
                                     PictureGeometry)
from tiny_mp2v_dec_tpu_torch.ops import _build, mc_fused  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import recon as trecon  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops.mc_rows import plane_of_tiles  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tools import perf_gate  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tools import profile_mc_variants as pmv  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"perf_gate": perf_gate, "profile_mc_variants": pmv}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tools_exit_2_without_a_card(capsys, monkeypatch, name):
    """Without a CUDA device neither tool measures: exit 2 with a message,
    as the JAX gate does off-TPU, and no record on stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TOOLS[name].main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_gate_module_entry_exits_2_and_writes_no_file():
    """``python -m ...tools.perf_gate`` with no CUDA device visible exits
    2, and leaves the JAX package's PERF_GATE.json as it was."""
    path = os.path.join(REPO, "PERF_GATE.json")
    with open(path, "rb") as f:
        before = f.read()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "-m",
                        "tiny_mp2v_dec_tpu_torch.tools.perf_gate"],
                       cwd=REPO, capture_output=True, text=True, env=env,
                       timeout=300)
    assert p.returncode == 2, p.stderr
    assert "no CUDA device" in p.stderr
    with open(path, "rb") as f:
        assert f.read() == before


@pytest.mark.parametrize("shape", [(48, 128), (64, 192)])
def test_profiler_parity_on_cpu(shape):
    """Variants b, c (K9) and d (K10) equal a at a small geometry; on CPU
    tensors the wrappers take their plain versions and launch nothing."""
    x = pmv.make_inputs(*shape, device="cpu")
    before = dict(_build.LAUNCHES)
    assert pmv.parity(x) == {"b": True, "c": True, "d": True}
    assert dict(_build.LAUNCHES) == before


def test_gate1_formulations_match_jax_and_each_other():
    """Gate 1's gather formulation equals the JAX gate's (its XLA op, on the
    same numpy inputs), and K2's plain version equals both."""
    x = perf_gate.mc_gate_inputs(64, 96, seed=3, device="cpu")
    got = perf_gate.gather_recon(x).numpy()
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    pad = jmc.pad_for_mc(j(x.plane))
    pf = jmc.mc_unidir_tiles(pad, j(x.pos_y), j(x.pos_x), j(x.mvx),
                             j(x.mvy), 16, 16)
    both = jmc.mc_bidir_tiles(pf, pf)
    tiles = j(x.res).reshape(4, 16, 6, 16).transpose(0, 2, 1, 3).reshape(
        24, 16, 16)
    want = jnp.clip(both.astype(jnp.int16) + tiles, 0, 255).astype(jnp.uint8)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        perf_gate.kernel_recon(x).numpy(),
        plane_of_tiles(perf_gate.gather_recon(x), x.H, x.W).numpy())


def _stream(cf=H.CHROMA_420, **opts):
    return ipb_stream(np.random.default_rng(4040 + cf), 3, 2, cf, **opts)


def test_gate2_chunk_steps_agree_on_cpu():
    steps = perf_gate.chunk_steps(_stream(), torch.device("cpu"))
    want = steps["plain"]()
    assert perf_gate._equal(steps["kernel"](), want)
    assert want[2].shape[0] == 5


@pytest.mark.parametrize("impl", trecon.MC_IMPLS)
def test_gate3_serve_steps_agree_on_cpu(impl):
    """Gate 3's serving steps, kernels' wrappers against plain versions on
    the CPU: equal reference lists and planes, two streams stacked."""
    steps = perf_gate.serve_steps(_stream(), torch.device("cpu"),
                                  mc_impl=impl)
    want = steps["plain"]()
    assert perf_gate._equal(steps["kernel"](), want)
    assert [p.shape[0] for p in want[2]] == [perf_gate.SERVE_STREAMS] * 3


FIELD = {"fpfd": False, "allow_field_motion": True}


@pytest.mark.parametrize("field", [False, True])
@pytest.mark.parametrize("impl", trecon.MC_IMPLS)
def test_gop_recon_plain_switches_match_default(impl, field):
    """``GopRecon(use_kernels=False)`` — the plain
    versions the kernel gate times — prepares the same blob and decodes
    the same planes as the default recon, under every MC implementation
    and both metadata forms."""
    data = _stream(H.CHROMA_422, **FIELD) if field else _stream()
    seq = MP2VDecoder(DecoderConfig(num_threads=1,
                                    device="cpu")).tokenize_stream(data)
    toks = [t for t, _, _ in seq]
    pcts = [ph.picture_coding_type for _, _, ph in seq]
    assert any(t.field_pred.any() for t in toks) == field
    outs = []
    for use in (True, False):
        gr = trecon.GopRecon(seq[0][1], 8, "cpu", field_support=field,
                             mc_impl=impl, use_kernels=use)
        assert gr.use_kernels is use
        if not (impl == "roll" and field):
            assert gr.inner.use_kernels is use
        staged = gr.prepare(toks, pcts)
        outs.append((staged[1].tobytes(), gr.dispatch(staged)))
    assert outs[0][0] == outs[1][0]
    assert perf_gate._equal(outs[0][1], outs[1][1])


def test_plain_switch_takes_the_plain_functions():
    g = PictureGeometry(width=32, height=32, chroma_format=1)
    plain = trecon.DeviceRecon(g, "cpu", mc_impl="swar", use_kernels=False)
    assert plain._mc_fns is mc_fused.fused_mc_pred_swar_yuv_ref
    plain = trecon.DeviceRecon(g, "cpu", field_support=True, mc_impl="swar",
                               use_kernels=False)
    assert plain._mc_fns is mc_fused.fused_mc_pred_swar_field_ref
    # mxu takes the grouped blocks form of K2/K3/K4, frame or field by the
    # rows
    kern = trecon.DeviceRecon(g, "cpu", field_support=True, mc_impl="mxu")
    assert kern._mc_fns is mc_fused.fused_mc_recon_blocks_group
    plain = trecon.DeviceRecon(g, "cpu", mc_impl="mxu", use_kernels=False)
    assert plain._mc_fns is mc_fused.fused_mc_recon_blocks_group_ref
    # an explicit roll with field support has no kernel: the blocks form's
    # plain version on the CPU
    roll = trecon.DeviceRecon(g, "cpu", field_support=True, mc_impl="roll")
    assert not roll.use_kernels and (
        roll._mc_fns is mc_fused.fused_mc_recon_blocks_group_ref)
