"""Build the native host engine (g++ -O3 shared library) into the port's
build directory.  Importable and runnable:

    python -m mdcommunity_tpu_torch.native.build
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "mdc_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB = os.path.join(BUILD_DIR, "libmdc_native.so")


def build(force: bool = False) -> str:
    """Compile the shared library if missing or older than its source;
    returns its path.  The library is written under a temporary name and
    renamed, so concurrent builders never load a partial file."""
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= os.path.getmtime(SRC)
    ):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           "-o", tmp, SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, LIB)
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
