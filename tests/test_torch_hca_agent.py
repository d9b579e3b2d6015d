"""HCA's optimizer step and agent against the JAX package, on the CPU at a
small size: one Adam update on an HCA batch against optax, the rollout
with the bridge reward at eps = 0, the SMOKE agent with its resume and JAX's
agent reading the port's file, and `cli train --variant hca`.  The
train-step rule it leans on is tests/test_torch_hca_train.py's.

Trajectories: identical histories at every step whose actions agree; a
step whose actions differ must be a near-tie under eval/metrics.tie_scale
in both packages (variant_cases.is_near_tie), and the JAX side then
continues from the port's carry.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import optax  # noqa: E402
from gradient_rules import hca_leaf_tolerances  # noqa: E402
from variant_cases import (  # noqa: E402
    TRAIN_B,
    ckpt,
    flat,
    hca_port_step,
    hca_step_nets,
    is_near_tie,
    jax_step_args,
    port_step_args,
    step_case,
    train_pools,
)

from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import batched_step as jax_step  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu.utils.config import Config as JaxConfig  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset  # noqa: E402
from mdcommunity_tpu_torch.models import hca  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import from_jax_params, to_jax_params  # noqa: E402
from mdcommunity_tpu_torch.rl import dqn  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config  # noqa: E402

SMOKE = dict(n_train=6, n_valid=3, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)


def quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def nets():
    return hca_step_nets() + (step_case("hca"),)


def test_hca_adam_step_matches_optax(nets):
    """One HCA step through optax.adam and torch.optim.Adam (lr 1e-4) from
    the same parameters and batch.  The first step moves each element by
    lr·g/(|g| + 1e-8).  Where both gradients have one sign and |g| > 1e-2
    (most elements: the leaves are ~1e7-1e17) that is lr·sign(g) to 1e-6,
    and the updated parameters are equal to f32 rounding (an ulp a side, the
    f32 drift of optax's bias corrections, 1.5e-5 of the step, and 1e-6 of
    lr).  Elsewhere the gradient is at its leaf's noise floor (within the
    train-step rule's tolerance of 0 in JAX) and the two steps may differ by
    up to 2·lr; every element whose referee gradient exceeds twice that
    tolerance is of the first kind (about 6% of the elements are not).
    The first moments, 0.1·g, are held as the gradients are:
    within twice the train-step rule, against the referee's gradient."""
    params, target, c = nets
    lr = 1e-4
    opt = optax.adam(lr)
    args, kw = jax_step_args(c, False)
    jnew, jstate = jdqn.train_step(params, target, opt.init(params), *args,
                                   variant="hca", optimizer=opt, **kw)[:2]
    net = from_jax_params(params, "cpu").requires_grad_(True)
    topt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    dqn.train_step(net, from_jax_params(target, "cpu"), topt, **port_step_args(c, False),
                   variant="hca")
    _, net64, terms = hca_port_step(params, target, c, False, {}, torch.float64)
    g64 = {k: p.grad.numpy() for k, p in net64.named_parameters()}
    g_tols = hca_leaf_tolerances(g64, terms.sums())
    mu = flat(jstate[0].mu)
    st = topt.state_dict()["state"]
    names = [k for k, _ in net.named_parameters()]
    got, ref, before = flat(to_jax_params(net)), flat(jnew), flat(params)
    resolved, total = 0, 0
    for i, k in enumerate(names):
        m_port, m_jax = st[i]["exp_avg"].double().numpy(), mu[k].astype(np.float64)
        g_tol = g_tols[k]
        assert np.abs(m_port - m_jax).max() <= 0.1 * 2 * g_tol, k
        decided = ((np.sign(m_port) == np.sign(m_jax))
                   & (np.minimum(np.abs(m_port), np.abs(m_jax)) > 0.1 * 1e-2))
        ulp = np.spacing(np.abs(ref[k]).astype(np.float32))
        step = np.abs(ref[k] - before[k])
        d = np.abs(got[k] - ref[k])
        assert (d[decided] <= 2 * ulp[decided] + 1.5e-5 * step[decided] + 1e-6 * lr).all(), k
        assert (np.abs(m_jax[~decided]) <= 0.1 * 2 * g_tol).all(), k
        assert (d[~decided] <= 2 * lr + 2 * ulp[~decided]).all(), k
        # an element whose referee gradient clears its leaf's noise floor
        # twice over is decided in both packages
        clear = np.abs(g64[k]) > np.maximum(2 * g_tol, 1e-2)
        assert decided[clear].all(), k
        resolved += int(clear.sum())
        total += int((g64[k] != 0).sum())
    assert resolved > 0.5 * total, (resolved, total)


def test_hca_rollout_with_bridge_matches_jax_up_to_near_ties():
    """The committed HCA checkpoint on a 16-graph pool, 24 one-step chunks
    at eps = 0 with hca_bridge (beta 0.5, tau 0.5), resets pinned to slot
    2: identical actions, rewards (bonus included, to 1e-6) and states at
    every step whose actions agree.  A step whose actions differ must be a
    near-tie under eval/metrics.tie_scale in both packages (HCA's
    unselected nodes part at their sentinel); the JAX side then continues
    from the port's carry."""
    params = load_params(ckpt("hca"))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    net = load_model(ckpt("hca"), device="cpu")
    jg, tg = train_pools("hca", count=16, seed=9)
    js0, ts0 = jax_reset(jg), batched_reset(tg)
    gids = np.arange(TRAIN_B)
    jstate = jax.tree_util.tree_map(lambda x: x[gids], js0)
    tstate = ts0.map(lambda x: x[torch.from_numpy(gids)])
    tcur = tg.map(lambda x: x[torch.from_numpy(gids)])
    tgids = torch.from_numpy(gids)
    gen = torch.Generator().manual_seed(0)
    kw = dict(n_steps=1, variant="hca", hca_bridge=True, hca_beta=0.5, hca_tau=0.5)
    agreed, partings, bonus_steps = 0, 0, 0
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
        if np.array_equal(ja, ta):
            for k in ("covered", "sever", "valid", "done"):
                np.testing.assert_array_equal(jh[k].astype(th[k].dtype), th[k], err_msg=k)
            np.testing.assert_allclose(th["rewards"], jh["rewards"], rtol=1e-6)
            base = jax_step(jcur, jstate, jnp.asarray(ja))[1]
            bonus_steps += int((np.abs(jh["rewards"][0] - np.asarray(base)) > 0).sum())
            agreed += 1
        else:
            qj = np.asarray(jdqn.predict_q(jparams, jcur, jstate.covered, jstate.sever, "hca"))
            qt = dqn.predict_q(net, tcur, tstate.covered, tstate.sever, "hca").numpy()
            for b in np.flatnonzero(ja != ta):
                a, p = int(ja[b]), int(ta[b])
                assert is_near_tie(qj[b, a], qj[b, p], qj[b], qt[b, a], qt[b, p], qt[b], a, p)
            partings += 1
        tcur, tstate, tgids = tcur2, tstate2, tgids2
        jstate = type(jstate2)(**{f.name: jnp.asarray(getattr(tstate, f.name).numpy(),
                                                      getattr(jstate2, f.name).dtype)
                                  for f in dataclasses.fields(jstate2)})
    assert agreed >= 16 and bonus_steps > 0, (agreed, partings, bonus_steps)


def test_hca_smoke_train_resume_and_jax_reads_the_file(tmp_path):
    """The SMOKE agent for HCA trains, saves and resumes (the iteration, the
    Adam state of every leaf, both generators); find_model picks the JAX
    package's checkpoint of the run, an HcaQNet; the JAX agent reads the
    port's best_model.ckpt with weights_only=True and gives the port's Q;
    load_model gives an HcaQNet from it."""
    cfg = Config(variant="hca", **SMOKE)
    agent = dqn.DQNAgent(cfg, seed=0, device="cpu")
    assert isinstance(agent.net, hca.HcaQNet)
    d = str(tmp_path / "hca")
    agent.train(save_dir=d, log=quiet)
    vc = open(os.path.join(d, "ModelVC_12_16.csv")).read().split()
    assert len(vc) == 2 and all(0.0 < float(v) < 3.0 for v in vc)
    back = dqn.DQNAgent(cfg, seed=5, device="cpu")
    back.load(os.path.join(d, "latest.ckpt"))
    assert back.iteration == cfg.max_iteration
    assert torch.equal(back.generator.get_state(), agent.generator.get_state())
    sa, sb = agent.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    assert len(sa) == len(list(agent.net.parameters()))
    for i in sa:
        assert torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"])
    again = dqn.DQNAgent(dataclasses.replace(cfg, max_iteration=14), device="cpu")
    again.train(save_dir=d, resume=True, log=quiet)
    assert again.iteration == 14
    picked = dqn.find_model(d, 12, 16, save_frequency=6)
    assert picked == jdqn.find_model(d, 12, 16, save_frequency=6) and os.path.isfile(picked)
    assert isinstance(load_model(picked, device="cpu"), hca.HcaQNet)

    best = os.path.join(d, "best_model.ckpt")
    assert isinstance(load_model(best, device="cpu"), hca.HcaQNet)
    jagent = jdqn.DQNAgent(dataclasses.replace(JaxConfig(variant="hca"), **SMOKE), seed=1)
    jagent.load(best, weights_only=True)
    g = agent.valid_pool.stacked
    s = batched_reset(g)
    from mdcommunity_tpu.graphs.duplex import DuplexGraph as JaxGraph

    jg = JaxGraph(**{f.name: jnp.asarray(getattr(g, f.name).numpy())
                     for f in dataclasses.fields(JaxGraph)})
    qj = np.asarray(jdqn.predict_q(jagent.params, jg, jnp.asarray(s.covered.numpy()),
                                   jnp.asarray(s.sever.numpy()), "hca"), np.float64)
    ported = dqn.DQNAgent(cfg, device="cpu")
    ported.load(best, weights_only=True)
    qt = dqn.predict_q(ported.net, g, s.covered, s.sever, "hca").double().numpy()
    fin = np.isfinite(qj)
    np.testing.assert_array_equal(np.isfinite(qt), fin)
    sel = fin & (qj > -1e8)
    np.testing.assert_array_equal(fin & (qt > -1e8), sel)
    np.testing.assert_allclose(qt[sel], qj[sel], rtol=0, atol=1e-5 * np.abs(qj[sel]).max())
    np.testing.assert_allclose(qt[fin & ~sel], qj[fin & ~sel], rtol=2e-5)


def test_cli_train_hca_smoke_cpu(tmp_path, monkeypatch, capsys):
    from mdcommunity_tpu_torch.cli import main

    for k, v in (("SMOKE_TRAIN", "4"), ("SMOKE_VALID", "2"), ("SMOKE_ITER", "3"),
                 ("SMOKE_WARMUP_TRAJ", "4")):
        monkeypatch.setenv(k, v)
    main(["train", "--smoke", "--cpu", "--save-dir", str(tmp_path / "run"),
          "--variant", "hca"])
    d = str(tmp_path / "run") + "_SMOKE"
    assert os.path.isfile(os.path.join(d, "latest.ckpt"))
    assert "iter 0, eps 1.0000, mean vc" in capsys.readouterr().out
    assert isinstance(load_model(os.path.join(d, "best_model.ckpt"), device="cpu"), hca.HcaQNet)
