"""Build the native tokenizer shared library (g++, no external deps).

The port compiles its own copy of the JAX package's C++ tokenizer
(``csrc/tokenizer.cpp`` and ``csrc/vlc_tables.inc`` beside this file, byte
for byte the JAX package's files; ``tests/test_torch_build.py`` holds them
equal) into the repository's ``build/tokenizer/`` directory, never next to
the sources.  The library is rebuilt when a source is newer (cheap mtime
check); ``python -m tiny_mp2v_dec_tpu_torch.tokenizer.build`` forces a
rebuild.
"""
from __future__ import annotations

import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
CSRC = os.path.join(_HERE, "csrc")
SRC = os.path.join(CSRC, "tokenizer.cpp")
INC = os.path.join(CSRC, "vlc_tables.inc")
BUILD_DIR = os.path.join(_REPO, "build", "tokenizer")
LIB = os.path.join(BUILD_DIR, "_tokenizer.so")

CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-march=native"]


def build(force: bool = False) -> str:
    """Path of an up-to-date library, compiling it first when needed.

    Compiles into a private temporary name and renames it into place, so
    concurrent test workers never load a half-written library."""
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) > max(os.path.getmtime(SRC),
                                            os.path.getmtime(INC))):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXXFLAGS, SRC, "-o", tmp, "-lpthread"],
                   check=True)
    os.replace(tmp, LIB)
    return LIB


if __name__ == "__main__":
    print(build(force=True))
