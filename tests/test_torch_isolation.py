"""PyTorch port, isolation: the port imports every module and decodes
with JAX and the JAX package made unimportable, as on a GPU machine that
has neither."""
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
leaked = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "tiny_mp2v_dec_tpu")))
print(json.dumps({"sha256": h.hexdigest(), "frames": len(frames),
                  "modules": mods, "leaked": leaked}))
"""


def test_port_runs_without_jax(tmp_path):
    data = ipb_stream(np.random.default_rng(6060), 3, 2, H.CHROMA_420)
    path = tmp_path / "stream.m2v"
    path.write_bytes(data)
    want = hashlib.sha256(b"".join(
        f.tobytes() for f in decode_stream(data))).hexdigest()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", CHILD, REPO, str(path)],
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
            "tiny_mp2v_dec_tpu_torch.ops.mc_rows"} <= set(got["modules"])
    assert got["frames"] == 5
    assert got["sha256"] == want
