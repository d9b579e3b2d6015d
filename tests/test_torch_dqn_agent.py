"""The port's DQN agent against the JAX package's, on the CPU at a small
size: the auto-resetting rollout, the SMOKE training run with its resume
and prioritized variants (JAX tests/test_dqn_smoke.py and
tests/test_checkpoint.py:49-72), the iteration-0 validation VC with the
JAX-initialised parameters (to 1e-6), the JAX agent reading a port-written
checkpoint, find_model and `cli train --smoke --cpu`; and the agent's Adam
against optax's: the JAX gradients fed to optax.adam and to
torch.optim.Adam give the same parameters after 3 steps to f32 rounding
(an ulp's half a step on each side, and the f32 rounding of optax's bias
corrections).

rollout_autoreset runs at eps = 0 with gid_hi = gid_lo + 1, so that the JAX
package's reset draw is deterministic: identical histories (actions,
rewards, covered, packed sever bits, valid, done, gid) at every step whose
actions agree; a parting must be a decision between two Q values within
TIE of max|Q| in both packages.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import batched_step as jax_step  # noqa: E402
from mdcommunity_tpu.env.env import batched_valid_mask as jax_valid  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.graphs.gmm import generate_pool as jax_pool  # noqa: E402
from mdcommunity_tpu.models.net import init_params  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu.utils.config import Config as JaxConfig  # noqa: E402
from mdcommunity_tpu_torch.env.env import (  # noqa: E402
    EnvState,
    batched_random_actions,
    batched_reset,
    batched_step,
    batched_valid_mask,
    is_terminal,
)
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.gmm import generate_pool  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import from_jax_params, to_jax_params  # noqa: E402
from mdcommunity_tpu_torch.rl import dqn  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"
PAD_N, PAD_E, B = 32, 256, 8
TIE = 1e-5  # of max|Q|
SMOKE = dict(n_train=6, n_valid=3, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)


def quiet(*a, **k):
    pass


def _state_np(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


def _to_jax(tree, like):
    """A port dataclass (EnvState, DuplexGraph) as the JAX package's `like`."""
    return type(like)(**{f.name: jnp.asarray(getattr(tree, f.name).numpy(),
                                             getattr(like, f.name).dtype)
                         for f in dataclasses.fields(like)})


def _check_tie(qj, qt, b, a, c):
    """Env b: JAX takes a, the port c; each ranks its own pick first, and
    both gaps lie within TIE of max|Q|."""
    tie = TIE * np.abs(qj[b][np.isfinite(qj[b])]).max()
    assert qj[b, a] >= qj[b, c] and qt[b, c] >= qt[b, a]
    assert qj[b, a] - qj[b, c] <= tie and qt[b, c] - qt[b, a] <= tie


def test_rollout_autoreset_matches_jax_up_to_near_ties():
    """The committed unit-cost checkpoint on a 16-graph pool, 32 one-step
    chunks at eps = 0 (greedy), resets pinned to slot 2: every history field
    identical at every step whose actions agree.  A step whose actions
    differ must be a decision between two Q values within TIE of max|Q| in
    both packages (a parting); the JAX side then continues from the port's
    carry, so the comparison runs on to the end."""
    params = load_params(CKPT)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    net = from_jax_params(params, "cpu")
    P = 16
    jg, tg = (jax_stack(jax_pool(np.random.default_rng(9), P, 16, 24, PAD_N, PAD_E)),
              stack_graphs(generate_pool(np.random.default_rng(9), P, 16, 24, PAD_N, PAD_E,
                                         device="cpu")))
    js0, ts0 = jax_reset(jg), batched_reset(tg)
    gids = np.arange(B)
    jstate = jax.tree_util.tree_map(lambda x: x[gids], js0)
    tstate = ts0.map(lambda x: x[torch.from_numpy(gids)])
    jcur = jax.tree_util.tree_map(lambda x: x[gids], jg)
    tcur = tg.map(lambda x: x[torch.from_numpy(gids)])
    jgids, tgids = jnp.asarray(gids, jnp.int32), torch.from_numpy(gids)
    gen = torch.Generator().manual_seed(0)
    agreed, partings, resets = 0, 0, 0
    for s in range(32):
        (jgids2, jcur2, jstate2), jh = jdqn.rollout_autoreset(
            jparams, jg, js0, jgids, jcur, jstate, jax.random.PRNGKey(s), jnp.float32(0.0),
            gid_lo=jnp.int32(2), gid_hi=jnp.int32(3), n_steps=1)
        (tgids, tcur2, tstate2), th = dqn.rollout_autoreset(
            net, tg, ts0, tgids, tcur, tstate, gen, 0.0, gid_lo=2, gid_hi=3, n_steps=1)
        th, _ = dqn.fetch_history(th, tgids)
        jh = jax.tree_util.tree_map(np.asarray, jh)
        ja, ta = jh["actions"][0], th["actions"][0]
        if np.array_equal(ja, ta):
            for k in ("gid", "covered", "sever", "valid", "done"):
                np.testing.assert_array_equal(jh[k].astype(th[k].dtype), th[k], err_msg=k)
            np.testing.assert_allclose(th["rewards"], jh["rewards"], rtol=1e-6)
            np.testing.assert_array_equal(np.asarray(jgids2), tgids.numpy())
            agreed += 1
        else:
            qj = np.asarray(jdqn.predict_q(jparams, jcur, jstate.covered, jstate.sever))
            qt = dqn.predict_q(net, tcur, tstate.covered, tstate.sever).numpy()
            for b in np.flatnonzero(ja != ta):
                _check_tie(qj, qt, b, ja[b], ta[b])
            partings += 1
        resets += int(th["done"].sum())
        tcur, tstate = tcur2, tstate2
        jgids = jnp.asarray(tgids.numpy(), jnp.int32)
        jcur, jstate = _to_jax(tcur, jcur2), _to_jax(tstate, jstate2)
    assert agreed >= 24 and resets >= 4, (agreed, partings, resets)


def test_rollout_chunk_equals_one_step_chunks():
    """One 8-step chunk against eight 1-step chunks from the same generator
    state at eps = 0.5 (the exploration and reset draws line up): the same
    histories and carry."""
    params = init_params(jax.random.PRNGKey(4))
    net = from_jax_params(params, "cpu")
    tg = stack_graphs(generate_pool(np.random.default_rng(2), 6, 16, 24, PAD_N, PAD_E,
                                    device="cpu"))
    s0 = batched_reset(tg)
    gids = torch.arange(4)
    start = (gids, tg.map(lambda x: x[gids]), s0.map(lambda x: x[gids]))
    (g8, _, st8), h8 = dqn.rollout_autoreset(net, tg, s0, *start, torch.Generator().manual_seed(1),
                                             0.5, n_steps=8)
    h8, _ = dqn.fetch_history(h8, g8)
    assert h8["done"].any()  # the chunk auto-resets some env
    # one chunk of 8 draws 8 rows of 1 + 2B uniforms; a 1-step chunk draws one
    # row, so eight of them from the same generator state draw the same numbers
    gen = torch.Generator().manual_seed(1)
    carry, rows = start, []
    for _ in range(8):
        carry, h = dqn.rollout_autoreset(net, tg, s0, *carry, gen, 0.5, n_steps=1)
        rows.append(dqn.fetch_history(h, carry[0])[0])
    for k in h8:
        np.testing.assert_array_equal(h8[k], np.concatenate([r[k] for r in rows]), err_msg=k)
    for k, v in _state_np(st8).items():
        np.testing.assert_array_equal(v, _state_np(carry[2])[k], err_msg=k)
    assert isinstance(st8, EnvState)


def test_smoke_train_and_resume(tmp_path):
    """JAX test_dqn_smoke's configuration: the files, two validations at
    iterations 0 and 6, then a resume that restores the iteration, the Adam
    state and both generators' states, and a second train() with
    resume=True that continues from the saved iteration and appends to the
    VC file (JAX tests/test_checkpoint.py:49-72)."""
    cfg = Config(**SMOKE)
    agent = dqn.DQNAgent(cfg, seed=0, device="cpu")
    d = str(tmp_path / "models")
    agent.train(save_dir=d, log=quiet)
    for f in ("latest.ckpt", "best_model.ckpt", "nrange_12_16_iter_0.ckpt",
              "nrange_12_16_iter_6.ckpt"):
        assert os.path.isfile(os.path.join(d, f)), f
    vc = open(os.path.join(d, "ModelVC_12_16.csv")).read().split()
    assert len(vc) == 2 and all(0.0 < float(v) < 3.0 for v in vc)

    back = dqn.DQNAgent(cfg, seed=5, device="cpu")
    back.load(os.path.join(d, "latest.ckpt"))
    assert back.iteration == cfg.max_iteration
    assert back.nprng.bit_generator.state == agent.nprng.bit_generator.state
    assert torch.equal(back.generator.get_state(), agent.generator.get_state())
    sa, sb = agent.optimizer.state_dict()["state"], back.optimizer.state_dict()["state"]
    assert int(sb[0]["step"]) == int(sa[0]["step"]) == cfg.max_iteration
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k])
    for (k, p), q in zip(agent.net.named_parameters(), back.net.parameters()):
        assert torch.equal(p, q), k

    more = dataclasses.replace(cfg, max_iteration=14)
    again = dqn.DQNAgent(more, device="cpu")
    again.train(save_dir=d, resume=True, log=quiet)
    assert again.iteration == 14
    # appended, not truncated: iteration 12 validates once more
    assert open(os.path.join(d, "ModelVC_12_16.csv")).read().split()[:2] == vc
    assert len(open(os.path.join(d, "ModelVC_12_16.csv")).read().split()) == 3
    assert int(again.optimizer.state_dict()["state"][0]["step"]) == 14


def test_smoke_train_prioritized(tmp_path):
    """Prioritized sampling in the loop: the sum-tree adds, staleness-
    filtered draws, IS-weighted fits and the deferred priority updates
    (JAX test_smoke_train_prioritized)."""
    cfg = dataclasses.replace(Config(**SMOKE), use_prioritized=True)
    agent = dqn.DQNAgent(cfg, seed=0, device="cpu")
    agent.train(save_dir=str(tmp_path / "prio"), log=quiet)
    leaves = agent.replay.tree.tree[agent.replay.tree.capacity - 1:]
    used = leaves[: agent.replay.count]
    assert (used > 0).all() and np.unique(np.round(used, 6)).size > 1
    assert agent._pending_prio is None


def test_iteration0_vc_and_jax_reading_the_port_file(tmp_path):
    """A JAX agent's parameters loaded into the port's agent
    (weights_only=True reads the JAX file): the same validation pool from
    the same seed and the same VC to 1e-6; then the JAX agent reads the
    port's best_model.ckpt with weights_only=True and gives the port's Q."""
    jcfg = dataclasses.replace(JaxConfig(), **SMOKE)
    ja = jdqn.DQNAgent(jcfg, seed=0)
    ja.prepare_valid_data()
    jpath = str(tmp_path / "jax.ckpt")
    ja.save(jpath)
    ta = dqn.DQNAgent(Config(**SMOKE), seed=0, device="cpu")
    ta.load(jpath, weights_only=True)
    ta.prepare_valid_data()
    assert abs(ta.validate() - ja.validate()) <= 1e-6
    with pytest.raises(ValueError, match="weights_only"):
        ta.load(jpath)

    ta.net.requires_grad_(False)
    for p in ta.net.parameters():
        p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    tpath = str(tmp_path / "best_model.ckpt")
    ta.save(tpath)
    jb = jdqn.DQNAgent(jcfg, seed=1)
    jb.load(tpath, weights_only=True)
    g = ta.valid_pool.stacked
    s = batched_reset(g)
    jg = jax_stack([ja.valid_pool.get(i) for i in range(len(ja.valid_pool))])
    js = jax_reset(jg)
    qj = np.asarray(jdqn.predict_q(jb.params, jg, js.covered, js.sever))
    qt = dqn.predict_q(ta.net, g, s.covered, s.sever).numpy()
    fin = np.isfinite(qj)
    np.testing.assert_array_equal(fin, np.isfinite(qt))
    np.testing.assert_allclose(qt[fin], qj[fin], rtol=1e-5, atol=1e-5 * np.abs(qj[fin]).max())


def test_find_model_matches_jax(tmp_path):
    for n_rows, burn_in in ((40, 33), (10, 33), (5, 0)):
        d = tmp_path / f"r{n_rows}"
        d.mkdir()
        vc = np.random.default_rng(n_rows).random(n_rows)
        (d / "ModelVC_30_50.csv").write_text("".join(f"{v:.16f}\n" for v in vc))
        assert dqn.find_model(str(d), burn_in=burn_in) == jdqn.find_model(str(d),
                                                                           burn_in=burn_in)


def test_cli_train_smoke_cpu(tmp_path, monkeypatch, capsys):
    from mdcommunity_tpu_torch.cli import main

    for k, v in (("SMOKE_TRAIN", "4"), ("SMOKE_VALID", "2"), ("SMOKE_ITER", "3"),
                 ("SMOKE_WARMUP_TRAJ", "4")):
        monkeypatch.setenv(k, v)
    main(["train", "--smoke", "--cpu", "--save-dir", str(tmp_path / "run"),
          "--variant", "degree_cost"])
    d = str(tmp_path / "run") + "_SMOKE"
    assert os.path.isfile(os.path.join(d, "latest.ckpt"))
    assert "iter 0, eps 1.0000, mean vc" in capsys.readouterr().out
    # every variant trains: CE writes its LMCC-DEBUG and CE-PRIOR lines
    main(["train", "--smoke", "--cpu", "--save-dir", str(tmp_path / "ce"),
          "--variant", "ce"])
    out = capsys.readouterr().out
    assert "LMCC-DEBUG mean_final=" in out and "CE-PRIOR feature=boundary" in out
    assert os.path.isfile(os.path.join(str(tmp_path / "ce") + "_SMOKE", "latest.ckpt"))


def test_random_actions_are_uniform_over_the_jax_valid_set():
    """batched_valid_mask equals the JAX package's on mid-episode states;
    batched_random_actions draws only valid actions, each graph's valid
    nodes about equally often (the JAX categorical's distribution), from a
    CPU torch.Generator: the same generator state gives the same draws; a
    graph with no valid action gets node 0."""
    jg, tg = (jax_stack(jax_pool(np.random.default_rng(4), B, 16, 24, PAD_N, PAD_E)),
              stack_graphs(generate_pool(np.random.default_rng(4), B, 16, 24, PAD_N, PAD_E,
                                         device="cpu")))
    js, ts = jax_reset(jg), batched_reset(tg)
    gen = torch.Generator().manual_seed(3)
    for _ in range(4):
        mask = batched_valid_mask(tg, ts).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jax_valid(jg, js)))
        np.testing.assert_array_equal(is_terminal(ts).numpy(), ~mask.any(1))
        state = gen.get_state()
        draws = np.stack([batched_random_actions(tg, ts, gen).numpy() for _ in range(400)])
        gen.set_state(state)
        np.testing.assert_array_equal(draws[0], batched_random_actions(tg, ts, gen).numpy())
        for b in range(B):
            valid = np.flatnonzero(mask[b])
            if not valid.size:
                assert (draws[:, b] == 0).all()
                continue
            assert np.isin(draws[:, b], valid).all()
            counts = np.bincount(draws[:, b], minlength=PAD_N)[valid]
            expect = 400 / valid.size
            assert counts.min() > expect / 3 and counts.max() < 3 * expect
        a = draws[0]
        js, _ = jax_step(jg, js, jnp.asarray(a))
        ts, _ = batched_step(tg, ts, torch.from_numpy(a))


def _bias_correction_drift(steps, b1=0.9, b2=0.999):
    """The largest relative difference, over the first `steps` Adam steps,
    between the update scale sqrt(1 - b2^t)/(1 - b1^t) formed in f32 (as
    optax forms it) and in f64 (as torch.optim.Adam does)."""
    t = np.arange(1, steps + 1)
    f32 = (np.sqrt(np.float32(1) - np.float32(b2) ** t.astype(np.float32))
           / (np.float32(1) - np.float32(b1) ** t.astype(np.float32)))
    f64 = np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    return float(np.abs(f32 / f64 - 1).max())




def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_adam_matches_optax():
    """optax.adam and torch.optim.Adam (betas 0.9/0.999, eps 1e-8) fed the
    same gradients: the same parameters after 3 steps, to f32 rounding:
    half an ulp a step on each side, plus 1.5x the f32 drift of the bias
    corrections times the sum of the steps' moves, since optax forms
    1 - beta^t in f32 (1 - f32(0.999) is 1.3e-5 off 1e-3) where torch forms
    it in f64."""
    steps = 3
    params = init_params(jax.random.PRNGKey(0))
    opt = optax.adam(1e-4)
    state = opt.init(params)
    net = from_jax_params(params, "cpu").requires_grad_(True)
    topt = torch.optim.Adam(net.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    names = dict(net.named_parameters())

    @jax.jit
    def step(grads, state, p):
        upd, state = opt.update(grads, state, p)
        return optax.apply_updates(p, upd), state

    jp, prev = params, _flat(params)
    moved = {k: np.zeros_like(v) for k, v in prev.items()}
    for i in range(steps):
        grads = jax.tree_util.tree_map(
            lambda x, k=i: jax.random.normal(jax.random.PRNGKey(10 + k), x.shape) * 0.1, jp)
        jp, state = step(grads, state, jp)
        for k, g in _flat(grads).items():
            names[k].grad = torch.from_numpy(np.array(g))
        topt.step()
        cur = _flat(jp)
        for k in moved:
            moved[k] += np.abs(cur[k] - prev[k])
        prev = cur
    got = _flat(to_jax_params(net))
    drift = 1.5 * _bias_correction_drift(steps)  # 1.5e-5
    for k, ref in _flat(jp).items():
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(got[k] - ref) <= steps * ulp + drift * moved[k]).all(), k
