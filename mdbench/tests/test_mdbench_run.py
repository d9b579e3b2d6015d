"""Whole runs rehearsed on the CPU at a small size: the result line's keys,
the checks last on standard error, no JAX loaded, the faults that must
come out not correct, the exits without a card or the program, and the
reduction of a trace."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mdbench import faults, trace
from mdbench.common import Ctx
from mdbench.manifest import Manifest

CELLS = ["degree_cost.dismantle_banded_1m", "unit_cost.train_1m",
         "degree_cost.train_banded_1m"]
N = 4096


def _run(root, cell, pre="pass", seconds=3, cwd=None):
    args = ["--workload", cell, "--seed", "2200000011", "--seconds", str(seconds),
            "--trace", "0", "--rehearse", str(N)]
    code = f"import sys; {pre}; from mdbench.run import main; sys.exit(main({args!r}))"
    env = dict(os.environ, PYTHONPATH=root if cwd is None else "", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd or root, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_result_line(root, cell):
    p = _run(root, cell, seconds=10)     # three fits and five checked batches under load
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and res["correct"] is True and res["failed"] == 0
    man = Manifest.load(root)
    assert set(res["metrics"]) == {m["name"] for m in man.end_to_end(cell)}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = p.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in tail)


@pytest.mark.parametrize("pre", ["import jax", "import mdcommunity_tpu.utils"])
def test_refuses_jax(root, pre):
    pytest.importorskip(pre.split()[1].split(".")[0])
    p = _run(root, CELLS[0], pre=pre)
    assert p.returncode == 4 and not p.stdout.strip()
    assert "JAX" in p.stderr


def test_no_result_without_the_program(root, tmp_path):
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "mdbench"), tmp_path / "mdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(str(tmp_path), CELLS[0], cwd=str(tmp_path))
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_result_without_a_card(root):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    code = ("import sys; from mdbench.run import main; sys.exit(main(['--workload', "
            f"'{CELLS[0]}', '--seed', '1', '--seconds', '1', '--trace', '0']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=root))
    assert p.returncode == 3 and not p.stdout.strip()


def _ctx(root, cell, seed=2200000021):
    man = Manifest.load(root)
    w = man.cell(cell)
    return man, Ctx(root=root, cell=w, config=man.config(w["config"]),
                    traffic=man.traffic(w["traffic"]), seed=seed, seconds=3.0, trace=False,
                    device=torch.device("cpu"), n=N, t_process=0.0,
                    limits=man.limits(cell))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_is_not_correct(root, cell, fault):
    """The timed path broken underneath: the run must come out not correct
    (or fail outright)."""
    man, ctx = _ctx(root, cell)
    try:
        with faults.planted(fault, ctx.traffic["kind"]):
            man.kind(ctx.traffic).run(ctx)
    except Exception:
        return
    assert not ctx.correct, ctx.checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The program's own lower precision (precise=False) fails a limit."""
    man, ctx = _ctx(root, cell)
    ctx.traffic = dict(ctx.traffic, precise=False)
    man.kind(ctx.traffic).run(ctx)
    assert not ctx.correct, ctx.checks


def test_model_calls_outside_the_traced_stretch(root):
    """model_call_ms.dismantle reads every call of the window but those
    made under the profiler."""
    man, ctx = _ctx(root, "degree_cost.dismantle_banded_1m")
    ctx.trace = True
    man.kind(ctx.traffic).run(ctx)
    lay = ctx.layer
    assert lay["traced_calls"] > 0
    assert len(lay["call_s"]) + lay["traced_calls"] == ctx.attempted + 1
    assert ctx.correct, ctx.checks


@pytest.mark.parametrize("cell", ["unit_cost.train_1m", "degree_cost.train_banded_1m"])
def test_train_window_opens_after_the_first_iteration(root, cell):
    """The loop's set-up and first iteration are set-up; the window counts
    the iterations after it; the first selection's Q and greedy picks are
    judged."""
    man, ctx = _ctx(root, cell)
    man.kind(ctx.traffic).run(ctx)
    warm = dict((name, at) for name, _, at in ctx.phases)["warm-up"]
    assert ctx.e2e["setup_s"] > warm - ctx.t_process
    assert ctx.attempted == len(ctx.layer["rows"]) >= 3
    assert all(r["iter"] >= 1 for r in ctx.layer["rows"])
    checks = {c["name"]: c for c in ctx.checks}
    assert {"q_err", "pick_gap"} <= set(checks) and ctx.correct, ctx.checks


def _ev(name, a, b, cuda=False, user=False):
    return trace.Ev(name, a, b, cuda, user)


def test_trace_reduction():
    ev = [_ev("mdbench.stretch", 0, 1000, user=True),
          _ev("mdbench.cascade", 100, 400, user=True),
          _ev("aten::to", 550, 950),
          _ev("aten::copy_", 600, 900),
          _ev("band_mma_kernel<true>", 0, 100, cuda=True),
          _ev("band_mma_kernel<true>", 50, 90, cuda=True),
          _ev("gemm", 400, 600, cuda=True),
          _ev("mdbench.cascade", 100, 400, cuda=True, user=True),
          _ev("band_mma_kernel<false>", 900, 1000, cuda=True)]
    st = trace.reduce(ev)
    assert st.wall_s == pytest.approx(1e-3)
    assert st.busy_s == pytest.approx(400e-6)          # [0,100] + [400,600] + [900,1000]
    assert st.band_events == 3 and st.band_s == pytest.approx(240e-6)
    assert dict(st.idle_gaps) == pytest.approx({"cascade": 300e-6, "aten::copy_": 300e-6})
    assert st.device_ops[0][0] == "gemm"
    assert trace.band_time(st, 3) == pytest.approx(240e-6)
    assert trace.band_time(st, 4) is None
