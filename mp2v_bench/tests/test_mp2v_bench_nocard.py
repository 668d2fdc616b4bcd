"""A run needs the card and the program: without a CUDA card it exits
non-zero and prints no result, and so it does in a directory that holds
only ``BENCHMARK.json`` and the benchmark's files.  On the card, a short
run of a cell is correct (marked ``cuda``)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from mp2v_bench import spec

ARGS = ["--workload", "hd420_offline", "--seed", str(2**31 + 5),
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "-m", "mp2v_bench.run", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("a CUDA card is present: the run would measure it")
    r = run(spec.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_paths_alone_no_result(tmp_path):
    shutil.copytree(os.path.join(spec.ROOT, "mp2v_bench"),
                    tmp_path / "mp2v_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    r = run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_unknown_workload():
    r = subprocess.run([sys.executable, "-m", "mp2v_bench.run", "--workload",
                        "no_such_cell", "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 2 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_on_the_card():
    if not _has_card():
        pytest.skip("needs a CUDA card")
    r = run(spec.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
