"""The kernel build (``ops/_build.py``) with a stand-in ``nvcc``, the
summary of ``tools/ab_kernel_times.py`` and the port's copy of the C++
tokenizer: all run without a card."""
import os
import stat
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ab_kernel_times  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build  # noqa: E402

# writes its -o argument, or fails when its command line holds the pattern
FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
case " $* " in *"{fail}"*) exit 1;; esac
echo "$*" > "$out"
"""


@pytest.mark.parametrize("fail,raises", [
    ("<never>", None),
    ("csrc/idct.cu", RuntimeError),
    (" -shared ", subprocess.CalledProcessError),
])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail,
                                               raises):
    """One compile per source and one link into the library; a failed
    compile or link raises and leaves no object or temporary file
    behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{fail}", fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out_dir = tmp_path / "kernels"
    lib = out_dir / "libmp2v_kernels.so"
    monkeypatch.setattr(_build, "BUILD_DIR", str(out_dir))
    monkeypatch.setattr(_build, "LIB", str(lib))
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    if raises is None:
        assert _build.build(force=True) == str(lib)
        assert os.listdir(out_dir) == [lib.name]
        link = lib.read_text().split()
        assert "-shared" in link
        assert sorted(os.path.basename(x).split(".tmp")[0]
                      for x in link if x.endswith(".o")) == sorted(
            os.path.basename(s) + "." + str(os.getpid())
            for s in _build._sources())
    else:
        with pytest.raises(raises):
            _build.build(force=True)
        assert os.listdir(out_dir) == []


def test_ab_summary_counts_pairs():
    """Medians per side, the parent's interquartile range, and the pairs
    the change read lower in."""
    runs = []
    for p, c in ((10.0, 1.0), (12.0, 2.0), (8.0, 9.0), (14.0, 1.5)):
        runs += [{"root": "P", "stacks": [64], "k": p},
                 {"root": "C", "stacks": [0], "k": c}]
    s = ab_kernel_times.summary(runs, "P", "C")
    assert list(s) == ["k"]
    assert s["k"]["parent_median"] == 11.0
    assert s["k"]["change_median"] == 1.75
    assert s["k"]["change_wins"] == 3 and s["k"]["pairs"] == 4
    assert s["k"]["parent_iqr"] == pytest.approx(13.5 - 8.5)


@pytest.mark.parametrize("name", ["tokenizer.cpp", "vlc_tables.inc"])
def test_tokenizer_sources_are_the_jax_packages(name):
    """The port builds its own copy of the C++ tokenizer; each file equals
    the JAX package's byte for byte, so the two cannot drift."""
    from tiny_mp2v_dec_tpu_torch.tokenizer import build as tok_build
    port = os.path.join(tok_build.CSRC, name)
    assert os.path.dirname(os.path.dirname(port)) == os.path.dirname(
        os.path.abspath(tok_build.__file__))
    assert {tok_build.SRC, tok_build.INC} == {
        os.path.join(tok_build.CSRC, n)
        for n in ("tokenizer.cpp", "vlc_tables.inc")}
    with open(port, "rb") as f, open(os.path.join(
            REPO, "tiny_mp2v_dec_tpu", "tokenizer", "csrc", name), "rb") as g:
        assert f.read() == g.read()
