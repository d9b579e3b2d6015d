"""rl/big_trainer.train_banded_loop(mesh=...), the gp-sharded trainer loop,
against the port's unsharded loop at eps = 1 (which
tests/test_torch_big_trainer.py holds to the JAX package's loop)."""

import numpy as np

from mdcommunity_tpu_torch.env.host_env import make_host_env
from mdcommunity_tpu_torch.graphs.banded import ShardedBandedDuplex, build_banded_duplex
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
from mdcommunity_tpu_torch.models.checkpoint import load_params
from mdcommunity_tpu_torch.models.net import from_jax_params
from mdcommunity_tpu_torch.parallel.mesh import make_mesh
from mdcommunity_tpu_torch.rl import big_trainer

from torch_one_thread import one_torch_thread  # noqa: F401

CKPT = "models_tpu/unit_cost_full_r4/best_model.ckpt"
QUIET = dict(log_every=100, log=lambda *a, **k: None)


class Recorder:
    """An env that records each step_many's actions."""

    def __init__(self, env):
        self._env = env
        self.actions = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_many(self, actions, *args, **kw):
        self.actions.append(np.array(actions))
        return self._env.step_many(actions, *args, **kw)


def _flat(net):
    return {k: p.detach().numpy().copy() for k, p in net.named_parameters()}


def test_sharded_loop_matches_unsharded_loop_at_eps_1(monkeypatch):
    """n = 2,048 unshuffled (no spill), gp = 2 (4 blocks a shard), 4
    iterations of k = 32 at eps = 1 (a target snapshot after the third): the actions come from the same rng
    stream over the same pool, so both loops remove the same nodes; the
    unsharded loop runs unfused (packed=False), as the sharded one must, so
    the first fit's loss is the same to rtol 1e-5 (the regularizer's f32
    sums add per-shard partials) and the final weights
    agree to 2·lr per fit (the most Adam's sign-like steps can split a
    coordinate; the sharded parameter gradients sum in another order).
    Every forward of the sharded loop runs sharded and precise (f32 Q), and
    every fit reads a sharded operand set."""
    n = 2048
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0), shuffle=False)
    tb, _, (o0, o1) = build_banded_duplex(n, e0, e1, reorder=False, device="cpu")
    assert tb.spill_free
    params = load_params(CKPT)
    seen = []
    real_fwd, real_loss = big_trainer.banded_test_forward, big_trainer.banded_train_loss

    def fwd(net, bdx, covered, **kw):
        seen.append(("forward", type(bdx), kw.get("precise", True), kw.get("fuse_sage")))
        return real_fwd(net, bdx, covered, **kw)

    def loss(net, bdx, *a, **kw):
        seen.append(("fit", type(bdx)))
        return real_loss(net, bdx, *a, **kw)

    runs = {}
    for mesh in (None, make_mesh(2, "cpu")):
        monkeypatch.setattr(big_trainer, "banded_test_forward", fwd)
        monkeypatch.setattr(big_trainer, "banded_train_loss", loss)
        seen.clear()
        env = Recorder(make_host_env(n, o0, o1, engine="native"))
        net, hist = big_trainer.train_banded_loop(
            from_jax_params(params, device="cpu"), tb, env, iters=4, k=32,
            eps_start=1.0, eps_end=1.0, target_update=3, lr=1e-4, seed=3,
            packed=False, mesh=mesh, **QUIET)
        runs[mesh is not None] = (env.actions, [h for h in hist if "loss" in h], _flat(net), list(seen))
    (ja, jrows, jp, _), (ta, trows, tp, tseen) = runs[False], runs[True]
    assert len(ja) == len(ta) == 4
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(a, b)
    assert [h["removed"] for h in jrows] == [h["removed"] for h in trows]
    jl, tl = (np.array([h["loss"] for h in r]) for r in (jrows, trows))
    fits = int(np.isfinite(jl).sum())
    assert fits >= 3 and np.array_equal(np.isfinite(tl), np.isfinite(jl))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl[np.isfinite(tl)], jl[np.isfinite(jl)], rtol=1e-3)
    for name, a in jp.items():
        np.testing.assert_allclose(tp[name], a, rtol=0, atol=2 * 1e-4 * fits, err_msg=name)
    assert all(s[1] is ShardedBandedDuplex for s in tseen)
    assert all(s[2] is True and not s[3] for s in tseen if s[0] == "forward")
    assert sum(s[0] == "fit" for s in tseen) == fits
