"""The variants' large-graph training loop against the JAX package, on the
CPU at 400 nodes (tests/variant_cases.py's demo graph) with the committed
degree-cost and CE checkpoints.

* train_banded_loop(variant=) against the JAX loop (packed=False) at
  eps = 1 with gamma = 0, so the fit's targets are the rewards: the first
  iteration's actions identical, its rewards identical (degree cost: the
  cost factors from the build's band-order weights, which the host envs
  hold too), its loss to rtol 1e-5.
* The loop gp-sharded (two shards on the CPU) against the unsharded one:
  the same removals, the first loss to rtol 1e-5, the same AUDC.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import N, ckpt, load_kw, write_graph  # noqa: E402

from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.io import load_real_duplex as jax_load  # noqa: E402
from mdcommunity_tpu.rl.big_trainer import train_banded_loop as jax_train_loop  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mdcommunity_tpu_torch.rl import big_trainer  # noqa: E402
from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop  # noqa: E402

QUIET = dict(log_every=100, log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Per variant: the JAX and the port's banded builds of the demo graph
    with the variant's columns, both packages' band-order edges and the
    band-order weights."""
    d = write_graph(str(tmp_path_factory.mktemp("banded_train")))
    path = os.path.join(d, "g.edges")
    raw = read_multiplex_edges(path, N)
    out = {}
    for variant in ("degree_cost", "ce"):
        g = jax_load(path, N, (1, 2), max_rank=0, **load_kw(variant))
        w = np.asarray(g.weights) if variant == "degree_cost" else None
        nf = np.asarray(g.node_feat)[:, :N] if variant == "ce" else None
        jb, _, jedges = jax_build(N, raw[1], raw[2], weights=w, node_feat=nf)
        tb, _, tedges = build_banded_duplex(N, raw[1], raw[2], weights=w, node_feat=nf,
                                            device="cpu")
        np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
        np.testing.assert_array_equal(tb.node_feat.numpy(), np.asarray(jb.node_feat))
        bw = tb.weights.numpy()[:, :N] if variant == "degree_cost" else None
        out[variant] = (jb, tb, jedges, tedges, bw)
    return out


class Recorder:
    """A host env that records each step_many's actions and flags, and the
    rank and max rank after it."""

    def __init__(self, env):
        self._env = env
        self.calls, self.after = [], []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_many(self, actions, *args, **kw):
        self.calls.append((np.array(actions), args, kw))
        out = self._env.step_many(actions, *args, **kw)
        self.after.append((self._env.rank, self._env.max_rank))
        return out


@pytest.mark.parametrize("variant", ["degree_cost", "ce"])
def test_train_banded_loop_first_iteration_matches_jax(builds, variant, monkeypatch):
    """The JAX loop's rewards are -norm·cost[acts] (rl/big_trainer.py:240-244,
    278-280): cost from its build's weights in band order, norm its env's
    rank after the step; its fit is jitted, so the rewards are formed here
    from its build and env by that formula and held, exactly, to the
    targets the port's first fit receives (gamma = 0)."""
    jb, tb, jedges, tedges, bw = builds[variant]
    params = load_params(ckpt(variant))
    kw = dict(iters=1, k=16, eps_start=1.0, eps_end=1.0, gamma=0.0, target_update=5,
              lr=1e-4, seed=3, variant=variant, **QUIET)
    jenv = Recorder(jax_make_env(N, *jedges, weights=bw))
    _, jhist = jax_train_loop(jax.tree_util.tree_map(jnp.asarray, params), jb, jenv,
                              packed=False, **kw)
    fits = []
    real = big_trainer.banded_train_loss

    def record(net, bdx, covered, actions, targets, *a, **k):
        fits.append((actions.numpy().copy(), targets.numpy().copy()))
        return real(net, bdx, covered, actions, targets, *a, **k)

    monkeypatch.setattr(big_trainer, "banded_train_loss", record)
    tenv = Recorder(make_host_env(N, *tedges, weights=bw, engine="native"))
    _, thist = train_banded_loop(from_jax_params(params, device="cpu"), tb, tenv, **kw)
    (ja, _, jkw), (ta, _, tkw) = jenv.calls[0], tenv.calls[0]
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(fits[0][0], ta)
    assert jkw == tkw == dict(degree_cost=variant == "degree_cost")
    assert jenv.after[0] == tenv.after[0]
    w = np.asarray(jb.weights)[:, :N]
    if variant == "degree_cost":
        cost = 0.5 * (w[0] / max(w[0].sum(), 1e-9) + w[1] / max(w[1].sum(), 1e-9))
        assert np.ptp(cost[ja]) > 0
    else:
        cost = np.full(N, 1.0 / N)
    rank, max_rank = jenv.after[0]
    rewards = (-(rank / max(max_rank, 1)) * cost[ja]).astype(np.float32)
    np.testing.assert_array_equal(fits[0][1], rewards)
    jrows = [h for h in jhist if "loss" in h]
    trows = [h for h in thist if "loss" in h]
    assert jrows[0]["removed"] == trows[0]["removed"] == len(ta) == 16
    np.testing.assert_allclose(trows[0]["loss"], jrows[0]["loss"], rtol=1e-5)
    assert tenv.score == pytest.approx(jenv.score, rel=1e-12)


@pytest.mark.parametrize("variant", ["degree_cost", "ce"])
def test_train_banded_loop_with_mesh_matches_unsharded(builds, variant):
    _, tb, _, tedges, bw = builds[variant]
    net = load_model(ckpt(variant), device="cpu")
    kw = dict(iters=3, k=16, eps_start=1.0, eps_end=1.0, target_update=2, packed=False,
              variant=variant, **QUIET)
    runs = []
    for mesh in (None, make_mesh(2, "cpu")):
        env = Recorder(make_host_env(N, *tedges, weights=bw, engine="native"))
        _, hist = train_banded_loop(net, tb, env, mesh=mesh, **kw)
        runs.append(([c[0] for c in env.calls], [h["loss"] for h in hist if "loss" in h],
                     env.score))
    (au, lu, su), (as_, ls, ss) = runs
    assert len(au) == 3 and all(np.array_equal(a, b) for a, b in zip(au, as_))
    assert np.isfinite(lu[0]) and abs(ls[0] - lu[0]) <= 1e-5 * abs(lu[0])
    assert ss == su
