"""utils/profiling.span: host seconds in a row, and a profiler range
"mdc.<key>" only while a torch profiler runs."""

import time

import torch
from torch.profiler import ProfilerActivity, profile

from mdcommunity_tpu_torch.utils.profiling import span


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler running")


def test_span_adds_seconds_and_enters_no_range_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    row = {}
    with span(row, "t_outer_s"):
        with span(row, "t_inner_s"):
            time.sleep(0.002)
        with span(row, "t_inner_s"):
            time.sleep(0.001)
    assert row["t_inner_s"] >= 0.003
    assert row["t_outer_s"] >= row["t_inner_s"]


def test_span_is_a_nested_profiler_range_under_a_profiler(monkeypatch):
    row = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(row, "t_outer_s"):
            with span(row, "t_inner_s"):
                torch.ones(64).sum()
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    outer, inner = ev["mdc.t_outer_s"], ev["mdc.t_inner_s"]
    assert outer.start_ns() <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.start_ns() + outer.duration_ns()
    assert 0 < row["t_inner_s"] <= row["t_outer_s"]
    # the profiler has stopped: no range again
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    with span(row, "t_after_s"):
        pass
    assert "t_after_s" in row

