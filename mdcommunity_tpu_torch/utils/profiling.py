"""Tracing and profiling helpers (the JAX package's utils/profiling.py).

The reference's observability is wall-clock prints around validation windows
(MultiDismantler_torch.py:497,510-523) and per-dataset solve-time CSVs.
Here: a torch.profiler trace, a timing context that waits for the card's
queued work at its exit, and throughput counters (fit iterations a second
for the training loop).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Optional

import torch


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
def trace(log_dir: str = "./runs/torch-trace"):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card), written to log_dir as a Chrome trace that TensorBoard's profiler
    plugin or chrome://tracing reads."""
    import os

    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class ThroughputMeter:
    """Accumulates (units, seconds) and reports units/s: the trainer's fit
    iterations a second."""

    def __init__(self, unit: str = "edges"):
        self.unit = unit
        self.units = 0.0
        self.seconds = 0.0

    def add(self, units: float, seconds: float):
        self.units += units
        self.seconds += seconds

    @property
    def rate(self) -> float:
        return self.units / self.seconds if self.seconds > 0 else 0.0

    def json(self, name: str) -> str:
        return json.dumps(
            {"metric": name, "value": round(self.rate, 1), "unit": f"{self.unit}/s"}
        )
