"""What the benchmark's modules import: nothing of JAX or the JAX package
anywhere (top-level names compared whole, since the port's name begins
with the JAX package's), and nothing of the port, nor torch, in the plain
reference and the stream generator."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BANNED = {"jax", "jaxlib", "flax", "tiny_mp2v_dec_tpu"}
# modules that import nothing of the program: the reference, the
# generator and the arithmetic that judges the program
APART = ("ref", "streams", "reference.py", "roofline.py", "control.py",
         "check.py", "spec.py", "trace.py", "metrics")
# ... and of those, the plain numpy ones, which import no torch either
PLAIN = ("ref", "streams", "reference.py", "roofline.py", "control.py")


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_top_names(path: str) -> set:
    """Top-level names of the absolute imports of a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not imported_top_names(path) & BANNED


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's, and is allowed
    assert "tiny_mp2v_dec_tpu_torch".split(".")[0] not in BANNED
    assert "tiny_mp2v_dec_tpu.ops".split(".")[0] in BANNED


def _under(dirs):
    return sorted(p for p in _modules()
                  if os.path.relpath(p, BENCH).split(os.sep)[0] in dirs)


@pytest.mark.parametrize("path", _under(APART),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_apart_from_the_program(path):
    assert "tiny_mp2v_dec_tpu_torch" not in imported_top_names(path)


@pytest.mark.parametrize("path", _under(PLAIN),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_and_generator_are_plain(path):
    assert "torch" not in imported_top_names(path)


def test_loaded_modules():
    """Importing the reference and the generator loads no torch and
    nothing of the port or of JAX (a fresh interpreter)."""
    code = ("import sys; import mp2v_bench.reference, mp2v_bench.control, "
            "mp2v_bench.streams.generate; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & (BANNED | {"torch", "tiny_mp2v_dec_tpu_torch"})
