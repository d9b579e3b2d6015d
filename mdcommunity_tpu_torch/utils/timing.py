"""Kernel timing on the card, for the probe entry points.

`cuda_ms` times a callable with CUDA events (median of `reps` launches after
`warm` warm-ups); it raises on a machine without a card, since a host-clock
time of the plain versions is no device number.  `gpu_line` is the card's
name and power limit as nvidia-smi reports them, to stand beside every
number; `PEAK_BYTES_S` is the data sheet's memory rate of an H100 SXM.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Optional

import torch

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet


def cuda_ms(fn: Callable[[], object], reps: int = 20, warm: int = 3) -> float:
    """Median device ms of one call of fn (CUDA events around each call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times on the card; there is none")
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def gpu_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def band_pass_bytes(dbg, D: int, store_bytes: int = 4) -> int:
    """Bytes one band-operator pass must move: the base's band rows (half of
    them in nibbles; the kernels read no mirror-lane row), h read and the
    output written at their storage width, the row and col scales, the
    mirror table and the slot map."""
    band = dbg.n_blocks * dbg.S * (dbg.W2 // 2 if dbg.nibble else dbg.W2)
    return (band + 2 * dbg.pad_n * D * store_bytes + 2 * dbg.pad_n * 4
            + dbg.n_blocks * dbg.C * D * 4 + dbg.pad_n * 4)
