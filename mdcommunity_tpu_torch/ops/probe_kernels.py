"""The stream probe: a CUDA wrapper, its plain version and its counter.

`stream_sum(x, G, extra)` sums an int8 array x [nb, rows, width] over each
group of G consecutive blocks, f32 [nb / G]; with extra=True it adds each
block's parity-masked row reductions (the overlap probe's extra work).  It
replaces the JAX package's probe kernels scripts/probe_pallas_stream.py::
make_stream and scripts/probe_overlap.py::make (csrc/probe.cu says how, and
what bounds it).  Those write sum + s to one constant output block, so only
the last group's value survives there: stream_sum(x, G)[-1] + s is their
output.  The probe is a yardstick of the card's practical read rate, which
mdcommunity_tpu_torch/probe_hbm_roof.py reports beside the data sheet's.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (built with nvcc for sm_90a at first use into the
package's _build/) or raises, and adds one to `launches[name]`: stream_sum,
or stream_sum_extra with extra=True.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC, build_library

SRC = os.path.join(CSRC, "probe.cu")
LIB = os.path.join(BUILD_DIR, "libmdc_probe.so")

launches = {"stream_sum": 0, "stream_sum_extra": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build(force: bool = False) -> str:
    """Compile csrc/probe.cu for sm_90a if the library is missing or older
    than the source; returns the library path."""
    return build_library(SRC, LIB, force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mdc_stream_sum.restype = i
        lib.mdc_stream_sum.argtypes = [p, p] + [i] * 5 + [p]
        _lib = lib
    return _lib


def stream_sum_plain(x: torch.Tensor, G: int, extra: bool = False) -> torch.Tensor:
    """The plain version: per-block sums (plus, with extra, the masked
    reductions of rows i < 256 at lanes 2·(i mod 64) and 2·(i mod 64) + 1 of
    the first 128), summed over each group of G blocks; exact integer sums
    in int64, returned as f32."""
    nb, rows, width = x.shape
    per = x.to(torch.int64).sum(dim=(1, 2))
    if extra:
        r = min(rows, 256)
        i = torch.arange(r, device=x.device)
        k = torch.arange(min(width, 128), device=x.device)
        want = 2 * (i % 64)
        mask = ((k[None, :] == want[:, None]).to(torch.int64)
                + (k[None, :] == want[:, None] + 1).to(torch.int64))
        per = per + (x[:, :r, : k.numel()].to(torch.int64) * mask).sum(dim=(1, 2))
    return per.reshape(nb // G, G).sum(dim=1).to(torch.float32)


def stream_sum(x: torch.Tensor, G: int, extra: bool = False) -> torch.Tensor:
    """out[g] = Σ x over blocks [g·G, (g + 1)·G) (+ the masked reductions
    with extra), f32 [nb / G]."""
    if x.dtype != torch.int8 or x.dim() != 3:
        raise ValueError(f"stream_sum takes an int8 [nb, rows, width] array, got "
                         f"{x.dtype} {tuple(x.shape)}")
    nb, rows, width = x.shape
    if G < 1 or nb % G:
        raise ValueError(f"G={G} must divide nb={nb}")
    if x.device.type == "cpu":
        return stream_sum_plain(x, G, extra)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or width % 16 or x.data_ptr() % 16:
        raise ValueError("stream_sum needs a contiguous, 16-byte aligned x whose width "
                         "is a multiple of 16")
    out = torch.zeros(nb // G, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _load().mdc_stream_sum(x.data_ptr(), out.data_ptr(), nb, rows, width, G,
                                    int(extra), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stream_sum kernel launch failed with CUDA error {rc}")
    launches["stream_sum_extra" if extra else "stream_sum"] += 1
    return out
