"""The kernel build (``ops/_build.py``) with a stand-in ``nvcc``, the
summary of ``tools/ab_kernel_times.py``, the port's copy of the C++
tokenizer, and the two libraries' loads from many threads at once: all run
without a card."""
import os
import stat
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ab_kernel_times  # noqa: E402
from torch_parity import ipb_stream  # noqa: E402
from tiny_mp2v_dec_tpu import headers as H  # noqa: E402
from tiny_mp2v_dec_tpu_torch import DecoderConfig, MP2VDecoder  # noqa: E402
from tiny_mp2v_dec_tpu_torch.ops import _build  # noqa: E402
from tiny_mp2v_dec_tpu_torch.tokenizer import native  # noqa: E402

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
    sass = {"seg 16x16 np=1 bidir=1 field=0 recon=1": "ab"}
    for p, c in ((10.0, 1.0), (12.0, 2.0), (8.0, 9.0), (14.0, 1.5)):
        runs += [{"root": "P", "card": "H100, 700.00 W",
                  "ptxas": {"k": {"registers": 64}},
                  "control_sass": sass, "k": p},
                 {"root": "C", "card": "H100, 700.00 W",
                  "ptxas": {"k": {"registers": 32}},
                  "control_sass": sass, "k": c}]
    s = ab_kernel_times.summary(runs, "P", "C")
    assert list(s) == ["k", "control_sass_equal", "cards"]
    assert s["control_sass_equal"] is True
    assert s["cards"] == ["H100, 700.00 W"]
    assert s["k"]["parent_median"] == 11.0
    assert s["k"]["change_median"] == 1.75
    assert s["k"]["change_wins"] == 3 and s["k"]["pairs"] == 4
    assert s["k"]["parent_iqr"] == pytest.approx(13.5 - 8.5)


def test_ab_summary_of_runs_without_sass():
    """Runs made with ``--only`` carry no ptxas report or SASS: the
    summary has their readings and cards, and no SASS verdict."""
    runs = [{"root": "P", "card": "a", "K9 mc_row": 2.0},
            {"root": "C", "card": "a", "K9 mc_row": 1.0}]
    s = ab_kernel_times.summary(runs, "P", "C")
    assert list(s) == ["K9 mc_row", "cards"]
    assert s["K9 mc_row"]["change_wins"] == 1


_SASS = {"seg 16x16 np=1 bidir=1 field=0 recon=1": "ab",
         "roll luma bidir=1": "cd"}


@pytest.mark.parametrize("parent_sass,change_sass,equal", [
    (_SASS, dict(_SASS), True),
    (_SASS, {**_SASS, "roll luma bidir=1": "ce"}, False),
    (_SASS, {"seg 16x16 np=1 bidir=1 field=0 recon=1": "ab"}, False),
    ({}, {}, False),
], ids=["same", "one-differs", "one-missing", "none-found"])
def test_ab_summary_field_sass(parent_sass, change_sass, equal):
    """The controls' machine code (the segment kernel's forms, K5, K6,
    K7's word kernel) counts as unchanged only when both sides compiled the
    same instantiations to the same SASS, and at least one."""
    runs = [{"root": "P", "card": "a", "ptxas": {},
             "control_sass": parent_sass, "k": 1.0},
            {"root": "C", "card": "a", "ptxas": {},
             "control_sass": change_sass, "k": 1.0}]
    assert ab_kernel_times.summary(runs, "P", "C")[
        "control_sass_equal"] is equal


def _sass(newer, pad, label, op="IADD3"):
    """A ``cuobjdump -sass`` listing of the controls — K2's, K4's and K8's
    forms of the segment kernel, K5's and K6's warp kernels, one of K7's
    word kernel — beside kernels that are none: K7's picture form, which
    only a ``newer`` source has, and the empty kernel."""
    def fn(name, op):
        return (f"\t\tFunction : _ZN3_GN15{name}\n"
                f"        /*0000*/{pad}{op} R1, R2, R3 ;{pad}/* 0x0001 */\n"
                f"        /*0010*/{pad}BRA `(.L_x_{label}) ;{pad}/* 0x0002 */\n"
                f".L_x_{label}:\n        /*0020*/{pad}EXIT ;\n"
                f"\t\t..........\n\n\n")
    seg = "mc_seg_kernelILi16ELi16ELi1ELb1E"
    # K2 last: a second listing's header follows its body
    names = {seg + "Lb1ELb1EEEvv": "LDG", seg + "Lb1ELb0EEEvv": "STG",
             "mc_roll_luma_kernelILb1EEEvv": "SHFL",
             "mc_roll_uv_kernelILi8ELi8ELb1EEEvv": "IMAD",
             "mc_swar_kernelILi8ELi8ELb1EEEvv": "LOP3",
             "empty_kernelEv": "NOP", seg + "Lb0ELb1EEEvv": op}
    if newer:
        names = {"mc_swar_yuv_kernelILi8ELi8ELb1EEEvv": "VABSDIFF4", **names}
    header = "\n\tcode for sm_90a\n"
    return header + "".join(fn(n, o) for n, o in names.items()) + header


def test_sass_digests_ignore_layout():
    """Column padding, what follows a function's body and the file-wide
    label numbering do not count; a changed opcode does; K7's picture form
    and the empty kernel are left out, so an older and a newer source give
    the same keys."""
    parent = ab_kernel_times.sass_digests(_sass(False, " " * 19, 3))
    same = ab_kernel_times.sass_digests(_sass(True, " " * 7, 12))
    other = ab_kernel_times.sass_digests(_sass(True, " " * 7, 12,
                                               op="IADD"))
    assert sorted(parent) == [
        "roll luma bidir=1",
        "roll uv 8x8 bidir=1",
        "seg 16x16 np=1 bidir=1 field=0 recon=1",
        "seg 16x16 np=1 bidir=1 field=1 recon=0",
        "seg 16x16 np=1 bidir=1 field=1 recon=1",
        "swar 8x8 bidir=1"]
    assert parent == same
    assert parent != other
    assert {k for k in parent if parent[k] != other[k]} == {
        "seg 16x16 np=1 bidir=1 field=0 recon=1"}


def test_sass_digests_read_the_front_end_parameter():
    """A source whose segment kernel takes its front end as a template
    parameter: the vector form (``VecFront``) is the same control under the
    same key as the form without the parameter, and the blocks form
    (``BlockFront``), which older sources lack, is no control."""
    body = ("        /*0000*/ IADD3 R1, R2, R3 ; /* 0x0001 */\n"
            "        /*0010*/ EXIT ;\n\t\t..........\n\n\n")
    base = "_ZN3_GN15mc_seg_kernelILi16ELi16ELi1ELb1ELb0ELb1E"
    older = ab_kernel_times.sass_digests(
        f"\t\tFunction : {base}EvN4mp2v6PlanesE\n{body}")
    newer = ab_kernel_times.sass_digests(
        f"\t\tFunction : {base}NS_8VecFrontILb0EEEEEvN4mp2v6PlanesET5_\n"
        f"{body}\t\tFunction : {base}NS_10BlockFrontILi16ELi16ELi1ELb0EEEEE"
        f"vN4mp2v6PlanesET5_\n{body}")
    assert list(older) == ["seg 16x16 np=1 bidir=1 field=0 recon=1"]
    assert newer == older


def test_sass_opcodes_count_one_kernel():
    """K1's instruction count by opcode: modifiers and predicates dropped,
    the other functions of the listing and cuobjdump's encoding lines left
    out."""
    listing = _sass(True, " " * 7, 4).replace(
        "Function : _ZN3_GN15empty_kernelEv\n",
        "Function : _ZN3_GN14idct8x8_kernelEPK4int4PS0_i\n"
        "        /*0000*/       VIMNMX.S32 R4, R4, 0x7fff, PT ;  /* 0x1 */\n"
        "                                                        /* 0x2 */\n"
        "        /*0010*/  @!P0 VIADDMNMX R5, R4, R3, R2, !PT ;  /* 0x3 */\n"
        "        /*0020*/       VIMNMX.S32 R6, R5, -0x8000, !PT ; /* 0x4 */\n")
    # the three instructions above, then the listing's own NOP, BRA, EXIT
    assert ab_kernel_times.sass_opcodes(listing, "idct8x8_kernel") == {
        "total": 6, "VIMNMX": 2, "VIADDMNMX": 1, "NOP": 1, "BRA": 1,
        "EXIT": 1}


# what ptxas -v says of one kernel, in the form of a newer ptxas (``stack
# size``) or an older one (``stack frame``)
_PTXAS = {
    "new": ("ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
            "ptxas info    : Function properties for {k}\n"
            "    0 bytes spill stores, 8 bytes spill loads\n"
            "ptxas info    : Used {r} registers, used 0 barriers, 16 bytes "
            "cumulative stack size, 380 bytes cmem[0]\n"),
    "old": ("ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
            "ptxas info    : Function properties for {k}\n"
            "    16 bytes stack frame, 0 bytes spill stores, 8 bytes spill "
            "loads\n"
            "ptxas info    : Used {r} registers, 380 bytes cmem[0]\n"),
}


@pytest.mark.parametrize("form", ["new", "old"])
def test_ptxas_report_reads_each_kernel(tmp_path, monkeypatch, form):
    """``ptxas_report`` compiles each listed source once and keeps, per
    kernel, the registers, stack bytes and spilled bytes ptxas printed."""
    nvcc = tmp_path / "nvcc"
    text = "".join(_PTXAS[form].format(k=f"_Z{k}", r=30 + k)
                   for k in range(2))
    nvcc.write_text("#!/bin/sh\ncat >&2 <<'X'\n" + text + "X\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(ab_kernel_times, "PTXAS_SOURCES", ("idct",))
    assert ab_kernel_times.ptxas_report(str(nvcc), REPO) == {
        f"_Z{k}": {"registers": 30 + k, "stack": 16, "spill": 8}
        for k in range(2)}


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


def _at_once(n: int, fn) -> list:
    """``fn()`` on ``n`` threads released together, under a short switch
    interval; the results in thread order.  Fails on an exception in a
    thread or on a thread still running after 120 s."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(i):
        try:
            barrier.wait(timeout=30)
            results[i] = fn()
        except Exception as e:  # reported below, from the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    return results


def test_tokenizer_loads_once_from_eight_threads(monkeypatch):
    """Eight threads each load the tokenizer (from a fresh module state,
    the build slowed so that all of them ask before the first has loaded)
    and tokenize a stream: one build, one library, and every thread's
    tokens equal to one thread's alone."""
    data = ipb_stream(np.random.default_rng(88), 4, 3, H.CHROMA_420)

    def tokenize():
        return MP2VDecoder(DecoderConfig(device="cpu", num_threads=1)
                           ).tokenize_stream(data)

    want = tokenize()
    builds = []
    real_build = native.build

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return real_build()

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", slow_build)
    results = _at_once(8, lambda: (native._load(), tokenize()))
    assert len(builds) == 1
    assert all(lib is native._lib for lib, _ in results)
    for _, got in results:
        assert len(got) == len(want)
        for (t, geom, _), (w, wgeom, _) in zip(got, want):
            n = w.n_coded_blocks
            assert geom == wgeom and t.n_coded_blocks == n
            for k, a in vars(w).items():
                if isinstance(a, np.ndarray):
                    # the coefficient rows past the coded blocks are not
                    # written
                    rows = n if k in ("cblk", "cblk_idx", "row_nnz") else None
                    np.testing.assert_array_equal(vars(t)[k][:rows],
                                                  a[:rows], err_msg=k)


def test_kernel_library_loads_once_from_eight_threads(monkeypatch):
    """Eight threads ask for the kernel library at once (a stand-in
    library, the build slowed): one build, one load, one library for all,
    every entry point declared."""
    builds, loads = [], []

    class Library:
        def __init__(self, path):
            loads.append(path)
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, types.SimpleNamespace())

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libstand-in.so"

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "C", types.SimpleNamespace(
        CDLL=Library, c_int=_build.C.c_int))
    libs = _at_once(8, _build.kernel_library)
    assert len(builds) == 1 and loads == ["libstand-in.so"]
    assert all(lib is libs[0] for lib in libs)
    assert set(libs[0].fns) == set(_build._SIGNATURES)
    assert all(fn.argtypes == _build._SIGNATURES[name]
               for name, fn in libs[0].fns.items())
