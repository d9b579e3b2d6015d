"""The CE agent against the JAX package, on the CPU at a small size: the
rollout at eps = 0 with CE's action pruning, validate(return_extras=True)
with and without action_pruning_test (the VC within 1e-6 of the JAX
agent's, lmcc_final and audc to 1e-6), and the SMOKE agent with its
LMCC-DEBUG and CE-PRIOR lines (CE-PRIOR the JAX agent's, character for
character) and its resume.

Trajectories: identical histories at every step whose actions agree; a
step whose actions differ must be a near-tie of the pruned Q under
eval/metrics.tie_scale in both packages (variant_cases.is_near_tie), and
the JAX side then continues from the port's carry.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import TRAIN_B, ckpt, is_near_tie, train_pools  # noqa: E402

from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import prune_q_to_boundary as jax_prune  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu.utils.config import Config as JaxConfig  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset, prune_q_to_boundary  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.rl import dqn  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config  # noqa: E402

SMOKE = dict(n_train=6, n_valid=3, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)


def quiet(*a, **k):
    pass


def test_ce_rollout_with_pruning_matches_jax_up_to_near_ties():
    """The committed CE checkpoint on a 16-graph CE pool, 24 one-step chunks
    at eps = 0 with ce_prune, resets pinned to slot 2: every history field
    identical at every step whose actions agree, and every action a
    boundary node while the graph has a live one.  A step whose actions
    differ must be a near-tie of the pruned Q in both packages; the JAX side
    then continues from the port's carry."""
    params = load_params(ckpt("ce"))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    net = load_model(ckpt("ce"), device="cpu")
    jg, tg = train_pools("ce", count=16, seed=9)
    js0, ts0 = jax_reset(jg), batched_reset(tg)
    gids = np.arange(TRAIN_B)
    jstate = jax.tree_util.tree_map(lambda x: x[gids], js0)
    tstate = ts0.map(lambda x: x[torch.from_numpy(gids)])
    tcur = tg.map(lambda x: x[torch.from_numpy(gids)])
    tgids = torch.from_numpy(gids)
    gen = torch.Generator().manual_seed(0)
    kw = dict(n_steps=1, variant="ce", ce_prune=True)
    agreed, partings, pruned = 0, 0, 0
    for s in range(24):
        jcur = jax.tree_util.tree_map(lambda x: x[jnp.asarray(tgids.numpy())], jg)
        (_, _, jstate2), jh = jdqn.rollout_autoreset(
            jparams, jg, js0, jnp.asarray(tgids.numpy(), jnp.int32), jcur, jstate,
            jax.random.PRNGKey(s), jnp.float32(0.0), gid_lo=jnp.int32(2),
            gid_hi=jnp.int32(3), **kw)
        (tgids2, tcur2, tstate2), th = dqn.rollout_autoreset(
            net, tg, ts0, tgids, tcur, tstate, gen, 0.0, gid_lo=2, gid_hi=3, **kw)
        th, _ = dqn.fetch_history(th, tgids2)
        jh = jax.tree_util.tree_map(np.asarray, jh)
        ja, ta = jh["actions"][0], th["actions"][0]
        q = dqn.predict_q(net, tcur, tstate.covered, tstate.sever, "ce")
        qp = prune_q_to_boundary(q, tcur.boundary).numpy()
        live_b = (np.isfinite(q.numpy()) & tcur.boundary.numpy()).any(1)
        assert tcur.boundary.numpy()[np.arange(TRAIN_B), ta][live_b].all()
        pruned += int(live_b.sum())
        if np.array_equal(ja, ta):
            for k in ("covered", "sever", "valid", "done"):
                np.testing.assert_array_equal(jh[k].astype(th[k].dtype), th[k], err_msg=k)
            np.testing.assert_allclose(th["rewards"], jh["rewards"], rtol=1e-6)
            agreed += 1
        else:
            qj = np.asarray(jax_prune(jdqn.predict_q(jparams, jcur, jstate.covered,
                                                     jstate.sever, "ce"), jcur.boundary))
            for b in np.flatnonzero(ja != ta):
                a, p = int(ja[b]), int(ta[b])
                assert is_near_tie(qj[b, a], qj[b, p], qj[b], qp[b, a], qp[b, p], qp[b], a, p)
            partings += 1
        tcur, tstate, tgids = tcur2, tstate2, tgids2
        jstate = type(jstate2)(**{f.name: jnp.asarray(getattr(tstate, f.name).numpy(),
                                                      getattr(jstate2, f.name).dtype)
                                  for f in dataclasses.fields(jstate2)})
    assert agreed >= 16 and pruned > 0, (agreed, partings, pruned)


@pytest.mark.parametrize("prune_test", [False, True])
def test_ce_validate_extras_match_jax(tmp_path, prune_test):
    """A JAX CE agent's parameters in the port's agent (weights_only=True):
    the same validation pool from the same seed, the same VC (to 1e-6) and
    per-graph lmcc_final and audc, with and without action_pruning_test."""
    cfg = dict(SMOKE, n_valid=8, action_pruning_test=prune_test)
    ja = jdqn.DQNAgent(dataclasses.replace(JaxConfig(variant="ce"), **cfg), seed=0)
    ja.prepare_valid_data()
    jpath = str(tmp_path / "jax.ckpt")
    ja.save(jpath)
    ta = dqn.DQNAgent(Config(variant="ce", **cfg), seed=0, device="cpu")
    ta.load(jpath, weights_only=True)
    ta.prepare_valid_data()
    jvc, jfinal, jaudc = ja.validate(return_extras=True)
    vc, final, audc = ta.validate(return_extras=True)
    assert abs(vc - jvc) <= 1e-6
    assert abs(ta.validate() - vc) == 0
    np.testing.assert_allclose(final, jfinal, rtol=0, atol=1e-6)
    np.testing.assert_allclose(audc, jaudc, rtol=0, atol=1e-6)
    assert ta._ce_prior_diagnostics() == ja._ce_prior_diagnostics()


def test_ce_smoke_train_and_resume(tmp_path):
    """The SMOKE CE agent: the files, the LMCC-DEBUG and CE-PRIOR lines at
    each validation (CE-PRIOR equal to the JAX agent's on the same seed's
    pool), and a resume that restores the state and continues."""
    cfg = Config(variant="ce", **SMOKE)
    agent = dqn.DQNAgent(cfg, seed=0, device="cpu")
    lines = []
    d = str(tmp_path / "ce")
    agent.train(save_dir=d, log=lines.append)
    assert sum(x.startswith("LMCC-DEBUG mean_final=") for x in lines) == 2
    prior = [x for x in lines if x.startswith("CE-PRIOR")]
    ja = jdqn.DQNAgent(dataclasses.replace(JaxConfig(variant="ce"), **SMOKE), seed=0)
    ja.prepare_valid_data()
    assert prior == [ja._ce_prior_diagnostics()] * 2
    for f in ("latest.ckpt", "best_model.ckpt", "nrange_12_16_iter_6.ckpt"):
        assert os.path.isfile(os.path.join(d, f)), f
    back = dqn.DQNAgent(cfg, seed=5, device="cpu")
    back.load(os.path.join(d, "latest.ckpt"))
    assert back.iteration == cfg.max_iteration
    assert back.nprng.bit_generator.state == agent.nprng.bit_generator.state
    again = dqn.DQNAgent(dataclasses.replace(cfg, max_iteration=14), device="cpu")
    again.train(save_dir=d, resume=True, log=quiet)
    assert again.iteration == 14
    assert int(again.optimizer.state_dict()["state"][0]["step"]) == 14
