"""The port's 10^6-scale banded training loop (rl/big_trainer.py), run small
on the CPU: the loop mechanics of tests/test_big_trainer.py, the loop
against the JAX package's train_banded_loop at eps = 1 (identical actions,
removals and losses), that every fit reads the pre-step state s_t, that a
sever between a loss and its backward raises, and the de-duplication of the
eps-mixed batch where the JAX package keeps a duplicate."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.rl.big_trainer import train_banded_loop as jax_train_loop  # noqa: E402
from mdcommunity_tpu.rl.dqn import DQNAgent  # noqa: E402
from mdcommunity_tpu.utils.config import Config  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex, fork_banded  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward, from_jax_params, to_jax_params  # noqa: E402
from mdcommunity_tpu_torch.ops.dense_band import build_dense_band  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mdcommunity_tpu_torch.rl import big_trainer  # noqa: E402
from mdcommunity_tpu_torch.rl.big_trainer import sync_env_severs, train_banded_loop  # noqa: E402

N = 400
QUIET = dict(log_every=100, log=lambda *a, **k: None)


class Recorder:
    """An env that records each step_many's actions and the state before
    it (covered mask and sever masks: s_t).  live_below, when given, makes
    alive_nodes report only nodes below it in layer 1."""

    def __init__(self, env, live_below=None):
        self._env = env
        self.live_below = live_below
        self.actions, self.before = [], []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def alive_nodes(self, layer):
        alive = self._env.alive_nodes(layer)
        if layer == 1 and self.live_below is not None:
            alive[self.live_below:] = False
        return alive

    def step_many(self, actions, *args, **kw):
        self.actions.append(np.array(actions))
        self.before.append((self._env.covered.copy(),
                            [s.copy() for s in self._env.sever]))
        return self._env.step_many(actions, *args, **kw)


@pytest.fixture(scope="module")
def setup():
    e0, e1 = synth_duplex_edges(N, 6, np.random.default_rng(0))
    banded, _, (o0, o1) = build_banded_duplex(N, e0, e1, device="cpu")
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    params = jax.tree_util.tree_map(np.asarray, agent.params)
    return (e0, e1), banded, o0, o1, params


def _env(o0, o1):
    return make_host_env(N, o0, o1, engine="native")


def _rows(hist):
    return [h for h in hist if "loss" in h]


# ------------------------------------------- mechanics (test_big_trainer.py)


def test_loop_runs_and_learns_shapes(setup):
    _, banded, o0, o1, params = setup
    env = _env(o0, o1)
    net = from_jax_params(params, device="cpu")
    net2, hist = train_banded_loop(net, banded, env, iters=8, k=16,
                                   target_update=4, **QUIET)
    rows = _rows(hist)
    assert len(rows) == 8
    full = [h for h in rows if h["removed"] == 16]
    assert full and all(np.isfinite(h["loss"]) for h in full)
    assert rows[-1]["norm"] < rows[0]["norm"]
    delta = sum(float((a - b.detach()).abs().sum())
                for a, b in zip(net.parameters(), net2.parameters()))
    assert delta > 0
    assert not any(p.requires_grad for p in net.parameters())  # caller's net untouched
    assert env.t == sum(h["removed"] for h in rows)
    for h in rows:
        split = sum(h[k] for k in ("t_select_s", "t_env_s", "t_sever_s",
                                   "t_target_s", "t_fit_s"))
        assert 0 < split <= h["t_iter_s"] + 1e-3


def test_episode_terminal_reset_and_audc(setup):
    _, banded, o0, o1, params = setup
    env = _env(o0, o1)
    _, hist = train_banded_loop(from_jax_params(params, device="cpu"), banded, env,
                                iters=6, k=128, target_update=3, **QUIET)
    ep_rows = [h for h in hist if "episode_end" in h]
    assert ep_rows, "no episode completed"
    assert ep_rows[0]["audc"] > 0 and ep_rows[0]["removals"] > 0
    assert env.t <= sum(h["removed"] for h in _rows(hist))


def test_reward_contract_matches_env_score(setup):
    _, banded, o0, o1, params = setup
    env = _env(o0, o1)
    train_banded_loop(from_jax_params(params, device="cpu"), banded, env,
                      iters=5, k=16, eps_start=0.0, eps_end=0.0,
                      target_update=100, **QUIET)
    assert env.score > 0
    assert env.t == 5 * 16


# --------------------------------------------------------- against JAX


def test_loop_matches_jax_at_eps_1(setup):
    """eps = 1: every action is drawn from the same rng stream over the same
    pool, so both loops take identical actions and removals; the fitted
    losses agree to rtol 1e-3 and the final weights to 2·lr per fit (the
    most Adam's sign-like steps can split a coordinate)."""
    (e0, e1), banded, o0, o1, params = setup
    jb, _, (j0, j1) = jax_build(N, e0, e1)
    kw = dict(iters=6, k=16, eps_start=1.0, eps_end=1.0, target_update=3,
              lr=1e-4, seed=3, **QUIET)
    jenv = Recorder(jax_make_env(N, j0, j1))
    jparams, jhist = jax_train_loop(jax.tree_util.tree_map(jax.numpy.asarray, params),
                                    jb, jenv, packed=False, **kw)
    tenv = Recorder(_env(o0, o1))
    net, thist = train_banded_loop(from_jax_params(params, device="cpu"), banded,
                                   tenv, **kw)
    assert len(jenv.actions) == len(tenv.actions) == 6
    for a, b in zip(jenv.actions, tenv.actions):
        np.testing.assert_array_equal(a, b)
    jrows, trows = _rows(jhist), _rows(thist)
    assert [h["removed"] for h in jrows] == [h["removed"] for h in trows]
    jl = np.array([h["loss"] for h in jrows])
    tl = np.array([h["loss"] for h in trows])
    fits = int(np.isfinite(jl).sum())
    assert fits >= 4
    np.testing.assert_array_equal(np.isfinite(tl), np.isfinite(jl))
    np.testing.assert_allclose(tl[np.isfinite(tl)], jl[np.isfinite(jl)], rtol=1e-3)
    ours = to_jax_params(net)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jparams),
                                 jax.tree_util.tree_leaves_with_path(ours)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2 * 1e-4 * fits,
                                   err_msg=str(path))


def test_fit_reads_the_pre_step_state(setup, monkeypatch):
    """Every fit's covered mask and band operands equal a fresh copy of the
    build synced to the env's state before that iteration's step (s_t),
    not after it (s_{t+1})."""
    _, banded, o0, o1, params = setup
    env = Recorder(_env(o0, o1))
    real_loss = big_trainer.banded_train_loss
    checked = []

    def loss_on_s_t(net, bdx, covered, *a, **kw):
        cov_t, sever_t = env.before[-1]
        want = np.pad(cov_t, (0, bdx.pad_n - N), constant_values=True)
        np.testing.assert_array_equal(covered.numpy(), want)
        ref = sync_env_severs(fork_banded(banded),
                              type("S", (), dict(edges=env.edges, sever=sever_t)))
        for layer in range(2):
            got, exp = bdx.dbg(layer), ref.dbg(layer)
            for name in ("base", "w_cov", "w_spill"):
                assert torch.equal(getattr(got, name), getattr(exp, name)), name
        checked.append(int(sum(s.sum() for s in env.sever) - sum(s.sum() for s in sever_t)))
        return real_loss(net, bdx, covered, *a, **kw)

    monkeypatch.setattr(big_trainer, "banded_train_loss", loss_on_s_t)
    train_banded_loop(from_jax_params(params, device="cpu"), banded, env,
                      iters=6, k=16, **QUIET)
    assert len(checked) >= 4
    # the check has teeth: the steps it covered severed new edges
    assert sum(checked) > 0


def test_sever_before_backward_raises(setup, monkeypatch):
    """A loop that severed the fit's operands between the loss and its
    backward (the in-place transcription of the JAX package's order) is
    stopped by the operand guard."""
    _, banded, o0, o1, params = setup
    real_loss = big_trainer.banded_train_loss

    def loss_then_sever(net, bdx, covered, *a, **kw):
        loss = real_loss(net, bdx, covered, *a, **kw)
        e = bdx.dbg0.ccoo.d_src.new_tensor([[0, 1]])
        big_trainer.apply_severs(bdx, 0, e[:, 0], e[:, 1],
                                 torch.ones(1, dtype=torch.bool))
        return loss

    monkeypatch.setattr(big_trainer, "banded_train_loss", loss_then_sever)
    with pytest.raises(RuntimeError, match="edited"):
        train_banded_loop(from_jax_params(params, device="cpu"), banded,
                          _env(o0, o1), iters=2, k=16, **QUIET)


def test_eps_mix_dedup_differs_from_jax(setup):
    """The eps-mix pool smaller than the mix count.  On a cascade fixed
    point every active node is live in both layers, so the pool always
    covers the mix; this iteration is built with an env that reports only
    nodes below 300 as live in layer 1.  With k = every active node and
    eps = 1, the JAX loop keeps the unmixed tail slots, which repeat
    replacements: the env removes each node once, and the fit counts the
    duplicates twice.  The port keeps the first occurrence of each node,
    takes the same removals, and skips the fit of the now-short batch."""
    (e0, e1), banded, o0, o1, params = setup
    probe = _env(o0, o1)
    b = sync_env_severs(fork_banded(banded), probe)
    covered = torch.from_numpy(np.pad(probe.covered, (0, b.pad_n - N),
                                      constant_values=True))
    net = from_jax_params(params, device="cpu")
    k = int(torch.isfinite(banded_test_forward(net, b, covered)).sum())
    assert k > 300
    kw = dict(iters=1, k=k, eps_start=1.0, eps_end=1.0, seed=0, **QUIET)

    jb, _, (j0, j1) = jax_build(N, e0, e1)
    jenv = Recorder(jax_make_env(N, j0, j1), live_below=300)
    _, jhist = jax_train_loop(jax.tree_util.tree_map(jax.numpy.asarray, params),
                              jb, jenv, packed=False, **kw)
    tenv = Recorder(_env(o0, o1), live_below=300)
    _, thist = train_banded_loop(net, banded, tenv, **kw)

    ja, ta = jenv.actions[0], tenv.actions[0]
    assert len(ja) == k and len(np.unique(ja)) < k  # JAX: duplicates
    _, first = np.unique(ja, return_index=True)
    np.testing.assert_array_equal(ta, ja[np.sort(first)])  # port: deduped
    assert _rows(jhist)[0]["removed"] == _rows(thist)[0]["removed"] == len(ta)
    assert np.isfinite(_rows(jhist)[0]["loss"])  # JAX fitted the duplicates
    assert np.isnan(_rows(thist)[0]["loss"])     # the port skipped the short batch


def test_loop_refuses_what_is_not_ported(setup):
    """The degree-cost variant and the bf16 fit are not ported; the sharded
    loop (mesh=) refuses a build with spill edges and one whose band blocks
    its shards do not divide, as the JAX package's does."""
    (e0, _), banded, o0, o1, params = setup
    net = from_jax_params(params, device="cpu")
    for kw in (dict(variant="degree_cost"), dict(precise=False)):
        with pytest.raises(NotImplementedError):
            train_banded_loop(net, banded, _env(o0, o1), iters=1, **kw, **QUIET)
    ss, dd = np.concatenate([o0[:, 0], o0[:, 1]]), np.concatenate([o0[:, 1], o0[:, 0]])
    spilled = dataclasses.replace(banded, dbg0=build_dense_band(
        ss, dd, N, S=64, B=32, max_mirror=1, device="cpu"))
    assert spilled.dbg0.spill.nnz and banded.dbg0.n_blocks == 2
    for b, gp, what in ((spilled, 2, "spill"), (banded, 3, "divisible")):
        with pytest.raises(ValueError, match=what):
            train_banded_loop(net, b, _env(o0, o1), iters=1, mesh=make_mesh(gp, "cpu"),
                              **QUIET)


def main(argv=None):
    """Both loops (the JAX package's with packed=False, and the port's) on
    one large_graph_demo graph from the fine-tuning checkpoint, with the
    same seed and eps schedule; prints each iteration's removals, loss and
    max Q side by side:

        PYTHONPATH=. python tests/test_torch_big_trainer.py --n 18222 --k 18 --iters 12
    """
    import argparse

    from mdcommunity_tpu_torch.models.checkpoint import load_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18222)
    ap.add_argument("--k", type=int, default=18)
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    n, kw = args.n, dict(iters=args.iters, k=args.k, **QUIET)
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    params = load_params("models_tpu/unit_cost_full_r4/best_model.ckpt")
    jb, _, (j0, j1) = jax_build(n, e0, e1)
    _, jhist = jax_train_loop(jax.tree_util.tree_map(jax.numpy.asarray, params), jb,
                              jax_make_env(n, j0, j1), packed=False, **kw)
    tb, _, (t0, t1) = build_banded_duplex(n, e0, e1, device="cpu")
    _, thist = train_banded_loop(from_jax_params(params, device="cpu"), tb,
                                 make_host_env(n, t0, t1), **kw)
    print("iter removed(jax port) loss(jax port) maxq(jax port)")
    for a, b in zip(_rows(jhist), _rows(thist)):
        print(a["iter"], a["removed"], b["removed"], f"{a['loss']:.5e} {b['loss']:.5e}",
              a["maxq"], b["maxq"])


if __name__ == "__main__":
    main()
