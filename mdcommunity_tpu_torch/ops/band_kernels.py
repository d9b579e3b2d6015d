"""Band-operator kernels K1 and K2: CUDA wrappers, plain versions, counters.

K1 `spmm_band` computes   out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·mir_sub)
K2 `sage_step` computes   h' = l2n(relu(out_K1 @ A_w + h @ B_w))

over a DenseBandGraph (ops/dense_band.py): A_band is the int8 base's S band
rows, G the mirror one-hot (`slot_of_row`), and `mir_sub` [nb·C, D] the
mirror-space result that ops/dense_band.mirror_sub computes in PyTorch.  They
replace the JAX package's Pallas TPU kernel ops/band_pallas.py::_make_kernel
(modes sage=False and sage=True, precise); the CUDA sources are in
csrc/band.cu, which also says what bounds them on an H100.  K1 is also the
operator's backward: ops/dense_band.BandSpmm launches it with row and col
swapped, counted under `band_spmm_bwd`.

On a CPU tensor a wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.  Nothing falls back.  The kernels build with
nvcc for sm_90a at first use into the package's _build/ directory.  Each
wrapper adds one to `launches[name]` where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "band.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libmdc_band.so")

# kernel launches on CUDA tensors, by kernel name; band_spmm_bwd counts the
# launches of K1 that compute a gradient (ops/dense_band.BandSpmm.backward)
launches = {"band_spmm": 0, "band_sage": 0, "band_spmm_bwd": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the band kernels need the CUDA toolkit")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/band.cu for sm_90a if the library is missing or older
    than the source; returns the library path.  The ptxas report (registers,
    shared memory, spills) is kept in _build/band_ptxas.log."""
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= os.path.getmtime(SRC)
    ):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, SRC,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {SRC}:\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, "band_ptxas.log"), "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, LIB)  # atomic: concurrent builders never load a partial file
    return LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mdc_band_spmm.restype = i
        lib.mdc_band_spmm.argtypes = [p] * 7 + [i] * 5 + [p]
        lib.mdc_band_sage.restype = i
        lib.mdc_band_sage.argtypes = [p] * 9 + [i] * 5 + [p]
        _lib = lib
    return _lib


# ---------------------------------------------------------------- checks


def _check(dbg, row, col, h, mir_sub, ab=()) -> None:
    """Raise on what the kernels (and plain versions) do not take."""
    if h.dtype != torch.float32 and not (
        h.dtype == torch.float64 and h.device.type == "cpu"
    ):
        raise NotImplementedError(
            f"band kernels take f32 h (the plain versions also f64 on the "
            f"CPU), got {h.dtype} on {h.device}; the bf16 modes are not "
            "ported yet"
        )
    if dbg.base.dtype != torch.int8 or dbg.slot_of_row.dtype != torch.int32:
        raise NotImplementedError("band kernels take an int8 base and int32 slots")
    if h.dim() != 2 or h.shape[0] != dbg.pad_n:
        raise ValueError(f"h must be [pad_n={dbg.pad_n}, D], got {tuple(h.shape)}")
    D = h.shape[1]
    want = [
        ("row", row, (dbg.pad_n,), h.dtype),
        ("col", col, (dbg.pad_n,), h.dtype),
        ("mir_sub", mir_sub, (dbg.n_blocks * dbg.C, D), h.dtype),
    ] + [(f"w{i}", w, (D, D), h.dtype) for i, w in enumerate(ab)]
    for name, t, shape, dt in want:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(
                f"{name} must be {dt} {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    for name, t in [("base", dbg.base), ("slot_of_row", dbg.slot_of_row)] + [
        (w[0], w[1]) for w in want
    ]:
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {h.device}")


def _launch(fn, dbg, row, col, h, mir_sub, extra, name) -> torch.Tensor:
    tensors = [dbg.base, h, row, col, mir_sub, dbg.slot_of_row, *extra]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all operands must be contiguous")
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    with torch.cuda.device(h.device):
        rc = fn(
            *[t.data_ptr() for t in tensors], out.data_ptr(),
            dbg.n_blocks, dbg.S, dbg.B, dbg.C, h.shape[1], stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    launches[name] += 1
    return out


# ---------------------------------------------------------------- plain


def _windows(x: torch.Tensor, nb: int, S: int, B: int) -> torch.Tensor:
    """[pad_n, D] -> circular windows [nb, W2, D]: block i's window is rows
    [i·S − B, i·S + S + B) mod pad_n."""
    xb = x.reshape(nb, S, -1)
    prev = torch.roll(xb, 1, dims=0)
    nxt = torch.roll(xb, -1, dims=0)
    return torch.cat([prev[:, S - B:], xb, nxt[:, :B]], dim=1)


def spmm_band_plain(dbg, row, col, h, mir_sub) -> torch.Tensor:
    """K1's plain version (the JAX package's _spmm_band3 without the spill):
    one einsum over the materialised windows, then the mirror expansion and
    the row scale."""
    nb, S, B, C = dbg.n_blocks, dbg.S, dbg.B, dbg.C
    D = h.shape[1]
    hw = _windows(h * col[:, None], nb, S, B)
    out = torch.einsum("bsw,bwd->bsd", dbg.base[:, :S].to(h.dtype), hw)
    if C:
        slot = dbg.slot_of_row.to(torch.int64)
        flat = torch.arange(nb, device=h.device)[:, None] * C + slot
        exp = mir_sub[flat.clamp(min=0).reshape(-1)].reshape(nb, S, D)
        out = out + torch.where((slot >= 0)[..., None], exp, torch.zeros_like(exp))
    return out.reshape(dbg.pad_n, D) * row[:, None]


def sage_step_plain(dbg, row, col, h, mir_sub, A_w, B_w) -> torch.Tensor:
    """K2's plain version: the fused GraphSAGE step of sage_step_packed."""
    pool = spmm_band_plain(dbg, row, col, h, mir_sub)
    z = torch.relu(pool @ A_w + h @ B_w)
    return z * torch.rsqrt(torch.clamp(torch.sum(z * z, -1, keepdim=True), min=1e-24))


# ---------------------------------------------------------------- wrappers


def spmm_band(dbg, row, col, h, mir_sub, counter: str = "band_spmm") -> torch.Tensor:
    """K1: out = row ⊙ (A_band @ (col ⊙ h) + Gᵀ·mir_sub), f32 [pad_n, D].
    The spill COO is not part of it (ops/dense_band.spmm_dense_band adds it).
    A launch counts under launches[counter]."""
    _check(dbg, row, col, h, mir_sub)
    if h.device.type == "cpu":
        return spmm_band_plain(dbg, row, col, h, mir_sub)
    return _launch(_load().mdc_band_spmm, dbg, row, col, h, mir_sub, (), counter)


def sage_step(dbg, row, col, h, mir_sub, A_w, B_w) -> torch.Tensor:
    """K2: h' = l2n(relu(K1(h) @ A_w + h @ B_w)) in one pass, with
    A_w = W1 @ W3[:d] and B_w = W2 @ W3[d:] (concat-matmul algebra of the
    reference layer concat(pool @ W1, h @ W2) @ W3).  The l2n clamps Σz² at
    1e-24.  The graph's spill must be empty: its edges would have to land
    before the relu, and the kernel does not read them."""
    _check(dbg, row, col, h, mir_sub, (A_w, B_w))
    if dbg.spill.nnz:
        raise ValueError("sage_step needs an empty spill set")
    if h.device.type == "cpu":
        return sage_step_plain(dbg, row, col, h, mir_sub, A_w, B_w)
    return _launch(
        _load().mdc_band_sage, dbg, row, col, h, mir_sub, (A_w, B_w), "band_sage"
    )
