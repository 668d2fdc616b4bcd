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
    sass = {"16x16 bidir=1": "ab"}
    for p, c in ((10.0, 1.0), (12.0, 2.0), (8.0, 9.0), (14.0, 1.5)):
        runs += [{"root": "P", "stacks": [64], "field_sass": sass, "k": p},
                 {"root": "C", "stacks": [0], "field_sass": sass, "k": c}]
    s = ab_kernel_times.summary(runs, "P", "C")
    assert list(s) == ["k", "field_sass_equal"]
    assert s["field_sass_equal"] is True
    assert s["k"]["parent_median"] == 11.0
    assert s["k"]["change_median"] == 1.75
    assert s["k"]["change_wins"] == 3 and s["k"]["pairs"] == 4
    assert s["k"]["parent_iqr"] == pytest.approx(13.5 - 8.5)


_SASS = {"16x16 bidir=1": "ab", "8x8 bidir=1": "cd"}


@pytest.mark.parametrize("parent_sass,change_sass,equal", [
    (_SASS, dict(_SASS), True),
    (_SASS, {**_SASS, "8x8 bidir=1": "ce"}, False),
    (_SASS, {"16x16 bidir=1": "ab"}, False),
    ({}, {}, False),
], ids=["same", "one-differs", "one-missing", "none-found"])
def test_ab_summary_field_sass(parent_sass, change_sass, equal):
    """K4's machine code counts as unchanged only when both sides compiled
    the same instantiations to the same SASS, and at least one."""
    runs = [{"root": "P", "stacks": [], "field_sass": parent_sass, "k": 1.0},
            {"root": "C", "stacks": [], "field_sass": change_sass, "k": 1.0}]
    assert ab_kernel_times.summary(runs, "P", "C")[
        "field_sass_equal"] is equal


def _sass(field_arg, pad, label, op="IADD3"):
    """A ``cuobjdump -sass`` listing of one frame and one field kernel."""
    def fn(name, op):
        return (f"\t\tFunction : _ZN3_GN15{name}\n"
                f"        /*0000*/{pad}{op} R1, R2, R3 ;{pad}/* 0x0001 */\n"
                f"        /*0010*/{pad}BRA `(.L_x_{label}) ;{pad}/* 0x0002 */\n"
                f".L_x_{label}:\n        /*0020*/{pad}EXIT ;\n")
    return ("\n\tcode for sm_90a\n"
            + fn("mc_recon_kernelILi8ELi8ELb1ELb0EEEvv", "IMAD")
            + fn(f"mc_recon_kernelILi8ELi8ELb1E{field_arg}EEvv", op))


def test_sass_digests_ignore_layout():
    """Column padding and the file-wide label numbering do not count; an
    instruction does; a frame instantiation (FIELD 0) is left out, and the
    keys of sources with and without the FIELD argument agree."""
    parent = ab_kernel_times.sass_digests(_sass("Lb1E", " " * 19, 3))
    same = ab_kernel_times.sass_digests(_sass("", " " * 7, 12))
    other = ab_kernel_times.sass_digests(_sass("", " " * 7, 12, op="IADD"))
    assert list(parent) == ["8x8 bidir=1"]
    assert parent == same
    assert parent != other


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
