"""Device time by the program's profiler ranges: the traced stretch of
trace.py, plus, for named `mdc.<key>` ranges (utils/profiling.span), the
device seconds of the kernels launched inside them.

A kernel belongs to a range when the host call that launched it started
inside one of the range's host spans: the CUDA runtime or driver call with
the kernel's correlation id, else the PyTorch operation the profiler links
the kernel to.  Kernels run later than their launch, so the device's clock
cannot place them; the launch can.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Tuple

import torch

from mdbench.trace import Stretch, Tracer


def range_device_s(events, names: Iterable[str]) -> Tuple[Dict[str, float], int, int]:
    """({name: device seconds of the kernels launched inside mdc.<name>},
    kernels placed by a launch, kernels placed by neither link) over the
    profiler's raw records."""
    cuda = torch.autograd.DeviceType.CUDA
    names = list(names)
    spans: Dict[str, List[Tuple[int, int]]] = {k: [] for k in names}
    launch, ops, kernels = {}, {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                kernels.append(e)
            continue
        name = e.name()
        if name.startswith("mdc.") and name[4:] in spans:
            spans[name[4:]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    starts = {k: sorted(v) for k, v in spans.items()}
    out = {k: 0.0 for k in names}
    placed = lost = 0
    for e in kernels:
        t = launch.get(e.correlation_id())
        if t is None:
            t = ops.get(e.linked_correlation_id())
        if t is None:
            lost += 1
            continue
        placed += 1
        for k, iv in starts.items():
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                out[k] += e.duration_ns() / 1e9
    return out, placed, lost


class RangeTracer(Tracer):
    """trace.Tracer whose stop also reads the device seconds of the kernels
    launched inside the program's ranges `names` (range_s, placed, lost)."""

    def __init__(self, names: Iterable[str]):
        super().__init__()
        self.names = list(names)
        self.range_s: Dict[str, float] = {}
        self.placed = self.lost = 0

    def stop(self) -> Stretch:
        prof = self.prof
        out = super().stop()
        self.range_s, self.placed, self.lost = range_device_s(
            prof.profiler.kineto_results.events(), self.names)
        return out
