"""Kernel timing on the card, for the probe entry points.

`cuda_ms` times a callable with CUDA events (median of `reps` calls after
`warm` warm-ups, an event pair around each call); the window holds the
caller's host work before the launch too, so for a kernel of a few
microseconds it measures the host's enqueue.  `device_ms` is the device's
own time: the kernels (and copies) one call launches, summed, from
torch.profiler over `reps` calls.  Both raise on a machine without a card,
since a host-clock time of the plain versions is no device number.
`kernel_names` lists the kernels a call launches.  `gpu_line` is the card's
name and power limit as nvidia-smi reports them, to stand beside every
number; `PEAK_BYTES_S` is the data sheet's memory rate of an H100 SXM.
"""

from __future__ import annotations

import subprocess
from typing import Callable, List, Optional

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


def device_ms(fn: Callable[[], object], reps: int = 20, warm: int = 3,
              tries: int = 5) -> float:
    """Mean device ms of one call of fn: the device time of every kernel and
    copy one call launches, summed (torch.profiler over `reps` calls, after
    `warm` warm-ups).  Host work between launches is not in it.

    fn must launch the same kernels on every call.  A profiling session
    can lose device records: on an H100 with torch 2.11 a session often
    lacked a kernel's last launch (99 of 100, 3,599 of 3,600), now and then
    a quarter of them or all.  So each kernel counts at the mean duration of
    the launches the session saw, times its launches a call (its records
    over reps, rounded); a session in which some kernel has fewer than half
    of one launch a call's records, or that saw none, runs again, and after
    `tries` such sessions this raises."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times on the card; there is none")
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # device work only: user ranges also appear on the device timeline
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation]
        per_call = [round(e.count / reps) for e in seen]
        if seen and min(per_call) >= 1:
            us = sum(e.self_device_time_total / e.count * n for e, n in zip(seen, per_call))
            return us / 1e3
    raise RuntimeError(f"device_ms: {tries} profiling sessions lost most device records")


def kernel_names(fn: Callable[[], object], tries: int = 5) -> List[str]:
    """The names of the device kernels one call of fn launches, in order
    of their first launch (torch.profiler, after one warm-up call; a
    session that saw no device record runs again, up to `tries`, and then
    the list is empty: a long-lived process's sessions can lose every
    device record, as device_ms says)."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_names reads the card's profile; there is none")
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = list(dict.fromkeys(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation))
        if names:
            return names
    return []


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
