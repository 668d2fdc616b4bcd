"""PyTorch port, isolation: the port imports every module, decodes, runs
its two command-line entry points (the CLI and the bench) and its host
reference (the golden model, ``split_gops``, the Python tokenizer) with JAX
and the JAX package made unimportable, as on a GPU machine that has
neither."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu.golden.decoder import decode_stream  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["tiny_mp2v_dec_tpu"] = None
sys.path.insert(0, sys.argv[1])
import tiny_mp2v_dec_tpu_torch as P
mods = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
frames = P.MP2VDecoder(P.DecoderConfig(gop_chunk=4, device="cpu")).decode(
    open(sys.argv[2], "rb").read())
h = hashlib.sha256()
for f in frames:
    h.update(f.tobytes())
from tiny_mp2v_dec_tpu_torch import bench, cli
yuv = sys.argv[3]
rc_cli = cli.main(["-v", sys.argv[2], "-o", yuv, "--gop-chunk", "4",
                   "--device", "cpu"])
cli_sha = hashlib.sha256(open(yuv, "rb").read()).hexdigest()
rc_bench = bench.main(["--device", "cpu", "--stream", sys.argv[2],
                       "--repeats", "1", "--warmup", "0", "--no-capacity",
                       "--no-latency", "--no-host-delivery"])
# the host reference: the golden model, split_gops and the Python
# tokenizer on the first picture (its slices and parameters found as the
# golden model finds them)
data = open(sys.argv[2], "rb").read()
g = hashlib.sha256()
for f in P.decode_stream_golden(data):
    g.update(f.tobytes())
from tiny_mp2v_dec_tpu_torch import headers as H
from tiny_mp2v_dec_tpu_torch.golden.decoder import GoldenDecoder
from tiny_mp2v_dec_tpu_torch.parallel.hosts import split_gops
from tiny_mp2v_dec_tpu_torch.tokenizer import python_tokenizer
from tiny_mp2v_dec_tpu_torch.tokenizer.types import (PictureGeometry,
                                                     PictureParams)
chunks = [(c.n_pictures, c.index) for c in split_gops(data)]
first = {}
class Walk(GoldenDecoder):
    def _decode_picture(self, data, cur):
        first.setdefault("pic", (cur, self.seq, self.sext))
Walk().decode(data)
cur, seq, sext = first["pic"]
pc = cur["pcext"]
geom = PictureGeometry(seq.horizontal_size_value, seq.vertical_size_value,
                       sext.chroma_format)
params = PictureParams(
    picture_coding_type=cur["header"].picture_coding_type, f_code=pc.f_code,
    intra_dc_precision=pc.intra_dc_precision,
    picture_structure=pc.picture_structure,
    frame_pred_frame_dct=pc.frame_pred_frame_dct,
    concealment_motion_vectors=pc.concealment_motion_vectors,
    q_scale_type=pc.q_scale_type, intra_vlc_format=pc.intra_vlc_format,
    alternate_scan=pc.alternate_scan, chroma_format=sext.chroma_format,
    vertical_size=geom.height,
    quant_matrices=H.build_quant_matrices(seq, None))
tok = python_tokenizer()(data, cur["slices"], params, geom)
want_tok = GoldenDecoder().tokenize_stream(data)[0]
tok_equal = all((getattr(tok, k) == getattr(want_tok, k)).all() for k in (
    "intra", "coded", "mv")) and (tok.dense_coeff()
                                  == want_tok.dense_coeff()).all()
leaked = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "tiny_mp2v_dec_tpu")))
print(json.dumps({"sha256": h.hexdigest(), "frames": len(frames),
                  "modules": mods, "leaked": leaked, "rc_cli": rc_cli,
                  "cli_sha256": cli_sha, "rc_bench": rc_bench,
                  "golden_sha256": g.hexdigest(), "chunks": chunks,
                  "tok_blocks": tok.n_coded_blocks,
                  "tok_equal": bool(tok_equal)}))
"""


def test_port_runs_without_jax(tmp_path):
    data = ipb_stream(np.random.default_rng(6060), 3, 2, H.CHROMA_420)
    path = tmp_path / "stream.m2v"
    path.write_bytes(data)
    yuv = b"".join(f.tobytes() for f in decode_stream(data))
    want = hashlib.sha256(yuv).hexdigest()
    # the record the bench holds the stream to
    (tmp_path / "stream.json").write_text(json.dumps({
        "stream_sha256": hashlib.sha256(data).hexdigest(),
        "yuv_sha256": want, "yuv_bytes": len(yuv), "frames": 5}))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHILD, REPO, str(path),
                          str(tmp_path / "out.yuv")],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    assert len(got["modules"]) >= 10
    # the measurement tools are imported too, and importing them runs
    # nothing
    assert {"tiny_mp2v_dec_tpu_torch.tools.tbench",
            "tiny_mp2v_dec_tpu_torch.tools.profile_mc_variants",
            "tiny_mp2v_dec_tpu_torch.tools.perf_gate",
            "tiny_mp2v_dec_tpu_torch.ops.mc_rows",
            "tiny_mp2v_dec_tpu_torch.bench",
            "tiny_mp2v_dec_tpu_torch.cli"} <= set(got["modules"])
    assert got["frames"] == 5
    assert got["sha256"] == want
    assert got["rc_cli"] == got["rc_bench"] == 0
    assert got["cli_sha256"] == want
    # the port's own reference, without JAX: the golden model gives the
    # JAX golden model's bytes, split_gops one closed chunk of the five
    # pictures, and the Python tokenizer the golden model's tokens of the
    # I picture, which codes every block
    assert got["golden_sha256"] == want
    assert got["chunks"] == [[5, 0]]
    assert got["tok_equal"] and got["tok_blocks"] == 3 * 2 * 6
    assert {"tiny_mp2v_dec_tpu_torch.golden.decoder",
            "tiny_mp2v_dec_tpu_torch.golden.recon",
            "tiny_mp2v_dec_tpu_torch.tokenizer.python_tok",
            "tiny_mp2v_dec_tpu_torch.vlc.lut",
            "tiny_mp2v_dec_tpu_torch.parallel.hosts",
            "tiny_mp2v_dec_tpu_torch.parallel.distributed"} <= set(
                got["modules"])
