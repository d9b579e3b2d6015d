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
# the Louvain levels round as Python does: no fused multiply-add
LOUVAIN_SRC = os.path.join(_HERE, "src", "mdc_louvain.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB = os.path.join(BUILD_DIR, "libmdc_native.so")
_FLAGS = ["g++", "-O3", "-std=c++17", "-fPIC", "-march=native"]


def _run(cmd, src):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")


def build(force: bool = False) -> str:
    """Compile the shared library if missing or older than a source;
    returns its path.  The library is written under a temporary name and
    renamed, so concurrent builders never load a partial file."""
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= max(os.path.getmtime(s) for s in (SRC, LOUVAIN_SRC))
    ):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [tmp[:-3] + "_env.o", tmp[:-3] + "_louvain.o"]
    try:
        _run(_FLAGS + ["-c", "-o", objs[0], SRC], SRC)
        _run(_FLAGS + ["-ffp-contract=off", "-c", "-o", objs[1], LOUVAIN_SRC], LOUVAIN_SRC)
        _run(["g++", "-shared", "-o", tmp] + objs, LIB)
    except RuntimeError:
        os.unlink(tmp)
        raise
    finally:
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
    os.replace(tmp, LIB)
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
