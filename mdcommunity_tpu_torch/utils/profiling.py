"""Tracing and profiling helpers (the JAX package's utils/profiling.py).

The reference's observability is wall-clock prints around validation windows
(MultiDismantler_torch.py:497,510-523) and per-dataset solve-time CSVs.
Here: `span`, the host phases of the large-graph loops as seconds in their
rows (and as profiler ranges while a profiler runs), a timing context that
waits for the card's queued work at its exit, and throughput counters (fit
iterations a second for the training loop).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_timer(name: str, sink: Optional[Dict[str, float]] = None, log=None):
    """Wall-clock a block, synchronising the card at exit, so the time holds
    the device work the block queued (on the CPU, the block's own time)."""
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    if log:
        log(f"[timer] {name}: {dt:.3f}s")


@contextlib.contextmanager
def span(row: dict, key: str):
    """Add the block's host seconds to row[key] (a history row of one
    iteration or batch; spans nest, and a key may take several blocks).
    While a torch profiler runs, the block is also the profiler range
    "mdc.<key>", in the host records that share the device trace's clock;
    without one, no range is entered (two clock reads and a flag read)."""
    with (_profiler.record_function("mdc." + key) if _profiler._is_profiler_enabled
          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        yield
        row[key] = row.get(key, 0.0) + time.perf_counter() - t0


class ThroughputMeter:
    """Accumulates (units, seconds) and reports units/s: the trainer's fit
    iterations a second."""

    def __init__(self):
        self.units = 0.0
        self.seconds = 0.0

    def add(self, units: float, seconds: float):
        self.units += units
        self.seconds += seconds

    @property
    def rate(self) -> float:
        return self.units / self.seconds if self.seconds > 0 else 0.0
