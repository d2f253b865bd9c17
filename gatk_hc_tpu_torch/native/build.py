"""Build libhcnative.so (the package's own copy of the C++ host library).

Flags matter for exactness: -ffp-contract=off prevents FMA fusion so the f32
PairHMM path matches the Python oracle and the CUDA kernel op-for-op; no
-ffast-math (reassociation would break bit-exactness).

The build is safe when several processes call it at once: each compiles to
a private temporary name and moves the result into place with os.replace.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "hc_native.cpp")
OUT = os.path.join(_DIR, "libhcnative.so")

CXXFLAGS = [
    "-std=c++17",
    "-O3",
    "-march=x86-64-v3",  # AVX2 autovectorization, portable across hosts
    # (unlike -march=native); -ffp-contract=off below keeps float
    # arithmetic unfused so PairHMM f32 results stay bit-exact
    "-fPIC",
    "-shared",
    "-ffp-contract=off",
    "-fno-math-errno",
    "-pthread",  # hc_sam_parse_mt block workers
    "-Wall",
]


_STAMP = OUT + ".flags"


def _is_fresh(flags: str) -> bool:
    if not (os.path.exists(OUT) and os.path.exists(_STAMP)):
        return False
    if os.path.getmtime(OUT) < os.path.getmtime(SRC):
        return False
    with open(_STAMP) as handle:
        return handle.read() == flags  # rebuild on flag changes too


def _replace_atomically(path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=_DIR, prefix=".tmp-")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(force: bool = False) -> str:
    flags = " ".join(CXXFLAGS)
    if not force and _is_fresh(flags):
        return OUT

    def compile_to(tmp: str) -> None:
        cmd = ["g++", *CXXFLAGS, SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True, text=True)

    def stamp_to(tmp: str) -> None:
        with open(tmp, "w") as handle:
            handle.write(flags)

    _replace_atomically(OUT, compile_to)
    _replace_atomically(_STAMP, stamp_to)
    return OUT


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
