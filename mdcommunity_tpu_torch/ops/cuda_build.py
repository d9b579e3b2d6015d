"""nvcc builds of the port's CUDA sources into plain-C shared libraries.

Each source under csrc/ is compiled for sm_90a at first use into the
package's _build/ directory (gitignored) and loaded with ctypes; it is
rebuilt when the source is newer than the library.  The ptxas report
(registers, shared memory, spills) is kept beside it as <name>_ptxas.log.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return path


def build_library(src: str, lib: str, force: bool = False) -> str:
    """Compile `src` into the shared library `lib` if it is missing or
    older than the source (or force); returns the library path."""
    if not force and os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, src,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    name = os.path.splitext(os.path.basename(src))[0]
    with open(os.path.join(BUILD_DIR, f"{name}_ptxas.log"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib
