"""scaling_bench across two OS processes (torch.distributed.run, gloo, the
CPU): under parallel/mesh.init_distributed its gp = 2 and 4 meshes span the
processes (gp = 1 runs in each process alone), and both engines still give
gp = 1's results: the band engine bit for bit, the edge partition within
1e-6 of max (scaling_bench raises otherwise)."""

import json
import os
import subprocess
import sys

from torch_one_thread import one_torch_thread  # noqa: F401

from mdcommunity_tpu_torch import multihost_smoke as mh


def test_scaling_bench_spans_two_processes():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(mh.free_port()), "-m", "mdcommunity_tpu_torch.scaling_bench",
         "--cpu", "--nodes", "2048", "--edges", "8192"],
        capture_output=True, text=True, timeout=180, cwd=mh.REPO, env=env)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1  # rank 0 prints
    line = lines[0]
    assert line["processes"] == 2 and line["cards"] == 0
    for engine in ("band", "coo"):
        assert [(r["gp"], r["processes"]) for r in line[engine]] == [(1, 1), (2, 2), (4, 2)]
        assert line[engine][0]["collective_bytes"] == 0 < line[engine][1]["collective_bytes"]
    assert line["vs_gp1"]["band_gp2"] == 0.0 and line["vs_gp1"]["band_gp4"] == 0.0
    assert line["vs_gp1"]["coo_gp2"] <= 1e-6 and line["vs_gp1"]["coo_gp4"] <= 1e-6
