"""The traced stretch: torch.profiler over a bounded stretch of the window,
kept in memory, reduced to the device's busy time, the band kernels' time,
the device operations that took most time and the idle gaps labelled by
what the host was doing.

The profiler's raw records are read (the kineto result's events: name,
start, duration, device), not its FunctionEvent tree, whose building takes
minutes for a stretch of training.  The harness marks its own spans with
record_function ("mdbench.<name>"): the stretch, the host cascade.  An idle
gap is labelled by the harness span it falls in, else by the innermost host
operation running at its middle, else "host python".
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

BAND_KERNEL = "band_mma_kernel"


class Ev(NamedTuple):
    """One profiler record: times in microseconds."""

    name: str
    start: float
    end: float
    cuda: bool
    user: bool


@dataclasses.dataclass
class Stretch:
    """What one traced stretch gives."""

    wall_s: float                 # the stretch on the profiler's clock
    busy_s: float                 # union of device kernel and copy intervals
    band_s: float                 # summed device time of the band kernels
    band_events: int              # band kernel records the trace holds
    device_events: int
    device_ops: List[List]
    idle_gaps: List[List]


class Tracer:
    """Start and stop a profiler at two points of the window (hooks), with
    the stretch as a record_function span."""

    def __init__(self):
        self.prof = None
        self.span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.autograd.profiler.record_function("mdbench.stretch")
        self.span.__enter__()

    def stop(self) -> Stretch:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        out = reduce(raw_events(self.prof))
        self.prof = self.span = None
        return out


def raw_events(prof) -> List[Ev]:
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        out.append(Ev(e.name(), a, a + e.duration_ns() / 1e3, e.device_type() == cuda,
                      bool(e.is_user_annotation())))
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _label_gaps(gaps, spans: List[Ev], host: List[Ev]) -> Dict[str, float]:
    """Idle seconds by label: the harness span holding a gap's middle, else
    the innermost host record holding it (a sweep over the records sorted
    by start, a heap by duration), else "host python"."""
    idle: Dict[str, float] = {}
    host = sorted(host, key=lambda e: e.start)
    heap: List[Tuple[float, float, str]] = []
    i = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        label = next((e.name[len("mdbench."):] for e in spans if e.start <= mid <= e.end), None)
        while i < len(host) and host[i].start <= mid:
            e = host[i]
            heapq.heappush(heap, (e.end - e.start, e.end, e.name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        if label is None:
            label = heap[0][2] if heap else "host python"
        idle[label] = idle.get(label, 0.0) + (b - a)
    return idle


def reduce(events: List[Ev]) -> Stretch:
    stretch = [e for e in events if e.name == "mdbench.stretch" and not e.cuda]
    if not stretch:
        raise RuntimeError("the trace holds no stretch span")
    t0, t1 = stretch[0].start, stretch[0].end
    dev = [e for e in events if e.cuda and not e.user]
    iv = _union([(max(e.start, t0), min(e.end, t1)) for e in dev if min(e.end, t1) > max(e.start, t0)])
    busy = sum(b - a for a, b in iv)
    band = [e for e in dev if BAND_KERNEL in e.name]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = [e for e in events if not e.cuda and e.name != "mdbench.stretch"]
    spans = [e for e in host if e.name.startswith("mdbench.")]
    others = [e for e in host if not e.name.startswith("mdbench.")]
    gaps, prev = [], t0
    for a, b in iv + [(t1, t1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle = _label_gaps(gaps, spans, others)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Stretch(
        wall_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
        band_s=sum(e.end - e.start for e in band) / 1e6,
        band_events=len(band), device_events=len(dev),
        device_ops=[[_short(k), v / 1e6] for k, v in ops],
        idle_gaps=[[_short(k), v / 1e6] for k, v in top],
    )


def band_time(st: Stretch, launched: int) -> Optional[float]:
    """The band kernels' device seconds over the stretch, the records a
    session lost made up at the mean of those it kept (a session can lose
    a kernel's last launch); None when it lost more than a tenth."""
    if launched <= 0 or st.band_events == 0 or st.band_events < 0.9 * launched:
        return None
    return st.band_s * launched / st.band_events
