"""The dp agent and the multi-process CLI of the port: DQNAgent(mesh=dp)
across OS processes, the command-line smoke and a dp × gp mesh over four
processes (the gp engine across processes is tests/test_torch_multihost.py).

mdcommunity_tpu_torch.multihost_smoke spawns gloo CPU processes, each
importing the port only; they write their results into tmp_path and this
process holds them against the JAX package on its 8-device CPU mesh:

* dp = 2: three fits of DQNAgent(mesh=dp 2), uniform and prioritized
  replay, from the JAX agent DQNAgent(mesh=make_mesh(dp=2, gp=1))'s weights,
  replay and generator state, against that agent's three fits: losses to
  rtol 1e-5, the same replay indices, and parameters and indices the same on
  both processes;
* the command-line smoke's OK line; a dp × gp mesh over four processes.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu.utils.config import Config as JaxConfig  # noqa: E402
from mdcommunity_tpu_torch import multihost_smoke as mh  # noqa: E402

SMOKE = dict(n_train=6, n_valid=4, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _save_state(agent, path):
    """The JAX agent's params, replay and numpy generator, as
    multihost_smoke's dp_agent phase loads them."""
    arrays = {f"param.{k}": v for k, v in _flat(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), agent.params)).items()}
    for k, v in vars(agent.replay).items():
        if k == "tree":
            arrays["replay.tree"] = v.tree
        elif isinstance(v, (np.ndarray, int, float)) and not isinstance(v, bool):
            arrays[f"replay.{k}"] = np.asarray(v)
    arrays["nprng"] = np.array(json.dumps(agent.nprng.bit_generator.state))
    np.savez(path, **arrays)


@pytest.mark.parametrize("prioritized", [False, True])
def test_dp_agent_fits_match_jax(tmp_path, prioritized):
    """Three fits of the port's dp = 2 agent (two processes) and of the JAX
    agent on a dp = 2 mesh from the same state: the same losses to rtol
    1e-5 and the same replay draws."""
    jcfg = JaxConfig(**dict(SMOKE, use_prioritized=prioritized))
    ja = jdqn.DQNAgent(jcfg, seed=0, mesh=jax_mesh(dp=2, gp=1, devices=jax.devices()[:2]))
    ja.gen_new_graphs()
    ja.play_games(SMOKE["warmup_traj"], 1.0)
    ja.take_snapshot()
    state = str(tmp_path / "state.npz")
    _save_state(ja, state)
    picked = []
    if prioritized:
        draw = ja.replay.sample_prioritized
        ja.replay.sample_prioritized = lambda *a, **k: (lambda pb: (
            picked.append(pb.tree_idx.tolist()), pb)[1])(draw(*a, **k))
    else:
        gather = ja.replay._gather
        ja.replay._gather = lambda idx: (picked.append(np.asarray(idx).tolist()),
                                         gather(idx))[1]
    jlosses = [float(ja.fit()) for _ in range(3)]

    cfg = dict(phases=["dp_agent"], agent=dict(
        config=dict(SMOKE, use_prioritized=prioritized), state=state, fits=3))
    results, _ = mh.run("cpu", "gloo", cfg, str(tmp_path / "run"), timeout=120)
    mh.check_agreement(results)  # losses, replay draws and parameters
    d = results[0]["dp_agent"]
    np.testing.assert_allclose(d["losses"], jlosses, rtol=1e-5)
    assert d["picked_digest"] == mh.hashlib.sha256(
        json.dumps(picked).encode()).hexdigest()[:16]
    assert d["picked_same_as_single"]


def test_cli_smoke(tmp_path):
    """python -m mdcommunity_tpu_torch.multihost_smoke --device cpu: the dp
    step and the gp phase on the JAX smoke's ring, one OK line."""
    out = subprocess.run(
        [sys.executable, "-m", "mdcommunity_tpu_torch.multihost_smoke", "--device", "cpu",
         "--out", str(tmp_path)], capture_output=True, text=True, timeout=240, cwd=mh.REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "multihost_smoke OK: 2 processes (cpu, gloo)" in out.stdout, out.stdout
    assert "gp=4 spanning both processes" in out.stdout, out.stdout


def test_dp_by_gp_mesh_over_four_processes(tmp_path):
    """dp = 2 replicas of gp = 4 shards over four processes (each axis its
    own process group): halos, gathers and shard-order sums as in one
    process, an all-reduce over dp."""
    results, _ = mh.run("cpu", "gloo", dict(processes=4, dp=2, phases=["mesh"]),
                        str(tmp_path), timeout=120)
    assert [(r["mesh"]["dp_rank"], r["mesh"]["gp_rank"], r["mesh"]["local"])
            for r in results] == [(0, 0, [0, 1]), (0, 1, [2, 3]), (1, 0, [0, 1]),
                                  (1, 1, [2, 3])]
