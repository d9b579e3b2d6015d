"""The variants' environment terms and the agent's options against the
JAX package, on the CPU at a small size: CE's action pruning and
boundary-first random draws, HCA's bridge bonus, on fixed states and
through the agent, and the agent in every fusion mode.

* env/env.prune_q_to_boundary and env/env.hca_bridge_bonus: exactly the
  JAX package's.
* The boundary-first random draws: the draws' support equal to the JAX
  package's on each state (its boundary candidates while any remain), the
  counts uniform on it (the port draws from a torch.Generator, not JAX's
  key stream, so the distribution is held, not the numbers).
* DQNAgent.play_games forms the bonus exactly when hca_bridge_effective
  is set, and then equal to the JAX package's on the agent's own states.
* DQNAgent trains, saves and resumes in every additive fusion mode (the
  attention leaves' Adam moments stay 0: their gradient is exactly 0), and
  the JAX agent reads the port's file with weights_only=True.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import TRAIN_B, train_pools, walk  # noqa: E402

from mdcommunity_tpu.env.env import batched_random_actions as jax_random  # noqa: E402
from mdcommunity_tpu.env.env import hca_bridge_bonus as jax_bonus  # noqa: E402
from mdcommunity_tpu.env.env import prune_q_to_boundary as jax_prune  # noqa: E402
from mdcommunity_tpu.models.fusion import FUSION_INITS as JAX_FUSION  # noqa: E402
from mdcommunity_tpu.rl import dqn as jdqn  # noqa: E402
from mdcommunity_tpu.utils.config import Config as JaxConfig  # noqa: E402
from mdcommunity_tpu_torch.env.env import (  # noqa: E402
    batched_random_actions,
    hca_bridge_bonus,
    prune_q_to_boundary,
    valid_action_mask,
)
from mdcommunity_tpu_torch.rl import dqn  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config  # noqa: E402

SMOKE = dict(n_train=6, n_valid=3, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)
ATTENTION = ("attention", "cos_attention", "sem_W", "sem_b", "sem_q")


def test_prune_q_to_boundary_matches_jax():
    """Seeded Q with -inf at some nodes and seeded boundary flags, with rows
    that have no finite boundary node: exactly the JAX package's."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    q[rng.random(q.shape) < 0.3] = -np.inf
    boundary = rng.random(q.shape) < 0.2
    boundary[:8] = False
    boundary[8:16] = np.isinf(q[8:16])  # boundary nodes all dead: nothing pruned
    ref = np.asarray(jax_prune(jnp.asarray(q), jnp.asarray(boundary)))
    got = prune_q_to_boundary(torch.from_numpy(q), torch.from_numpy(boundary)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (np.isinf(got) & ~np.isinf(q)).any()
    np.testing.assert_array_equal(got[:16], q[:16])


def test_boundary_first_draws_match_the_jax_support():
    """On the reset state and along a seeded walk of a CE pool: 600
    boundary-first draws of each package (JAX keys, the port's
    torch.Generator) give the same set of actions on every graph, the
    boundary candidates while any remain (checked on the port's valid mask
    and boundary flags), and the port's counts are uniform on it."""
    jg, tg = train_pools("ce", seed=4)
    draws_j = jax.jit(jax.vmap(lambda k, g, s: jax_random(g, s, k, True), in_axes=(0, None, None)))
    gen = torch.Generator().manual_seed(3)
    fallback = 0
    for steps in (0, 3, 6):
        js, ts, _ = walk(jg, tg, steps, np.random.default_rng(5))
        ref = np.asarray(draws_j(jax.random.split(jax.random.PRNGKey(steps), 600), jg, js))
        got = np.stack([batched_random_actions(tg, ts, gen, boundary_first=True).numpy()
                        for _ in range(600)])
        valid = valid_action_mask(tg, ts).numpy()
        boundary = tg.boundary.numpy()
        for b in range(TRAIN_B):
            if not valid[b].any():
                continue
            cand = valid[b] & boundary[b]
            support = np.flatnonzero(cand if cand.any() else valid[b])
            fallback += int(not cand.any())
            assert set(np.unique(got[:, b])) == set(np.unique(ref[:, b])) == set(support)
            counts = np.bincount(got[:, b], minlength=tg.pad_n)[support]
            expect = 600 / support.size
            assert counts.min() > expect / 3 and counts.max() < 3 * expect
    assert fallback < 3 * TRAIN_B  # most states still have boundary candidates


def test_hca_bridge_bonus_matches_jax_on_fixed_states():
    """env/env.hca_bridge_bonus against the JAX package's, vmapped: every
    node of every graph as the action, on the reset state and after 2 and
    4 steps of a seeded walk, at tau 0, 0.5 and 0.9: exactly equal."""
    jg, tg = train_pools("hca", seed=5)
    batched = jax.jit(jax.vmap(jax_bonus, in_axes=(0, 0, 0, None)), static_argnums=3)
    n = tg.pad_n
    hits = 0
    for steps in (0, 2, 4):
        js, ts, _ = walk(jg, tg, steps, np.random.default_rng(9))
        for tau in (0.0, 0.5, 0.9):
            for a in range(n):
                acts = np.full(TRAIN_B, a)
                ref = np.asarray(batched(jg, js, jnp.asarray(acts), tau))
                got = hca_bridge_bonus(tg, ts, torch.from_numpy(acts), tau).numpy()
                np.testing.assert_array_equal(got, ref)
                hits += int((ref > 0).sum())
    assert hits > 100


@pytest.mark.parametrize("effective", [True, False])
def test_hca_bridge_through_the_agent(effective, monkeypatch):
    """DQNAgent.play_games passes hca_bridge = hca_bridge_effective (the
    JAX agent's rule): with True every step's bonus is the JAX package's on
    the same pre-step states and actions, exactly, and the rewards carry
    hca_beta times it; with False no bonus is formed."""
    seen = []
    real = dqn.hca_bridge_bonus

    def record(g, state, actions, tau):
        out = real(g, state, actions, tau)
        seen.append((g, state, actions.clone(), tau, out))
        return out

    monkeypatch.setattr(dqn, "hca_bridge_bonus", record)
    cfg = Config(variant="hca", hca_bridge_effective=effective, hca_beta=0.7, hca_tau=0.4,
                 **SMOKE)
    agent = dqn.DQNAgent(cfg, device="cpu")
    agent.play_games(4, 1.0)
    if not effective:
        assert not seen
        return
    assert seen
    batched = jax.vmap(jax_bonus, in_axes=(0, 0, 0, None))
    from mdcommunity_tpu.env.env import EnvState as JaxState
    from mdcommunity_tpu.graphs.duplex import DuplexGraph as JaxGraph

    positive = 0
    for g, state, acts, tau, out in seen:
        assert tau == 0.4
        jg = JaxGraph(**{f.name: jnp.asarray(getattr(g, f.name).numpy())
                         for f in dataclasses.fields(JaxGraph)})
        js = JaxState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                         for f in dataclasses.fields(JaxState)})
        ref = np.asarray(batched(jg, js, jnp.asarray(acts.numpy()), tau))
        np.testing.assert_array_equal(out.numpy(), ref)
        positive += int((ref > 0).sum())
    assert positive > 0


@pytest.mark.parametrize("fusion", ["layer_node_attention", "cosine", "semantic"])
def test_agent_trains_and_resumes_each_fusion_mode(fusion, tmp_path):
    cfg = Config(fusion=fusion, **SMOKE)
    agent = dqn.DQNAgent(cfg, seed=0, device="cpu")
    d = str(tmp_path / fusion)
    agent.train(save_dir=d, log=lambda *a: None)
    names = [k for k, _ in agent.net.named_parameters()]
    att = [i for i, k in enumerate(names) if k.split(".")[-1] in ATTENTION]
    st = agent.optimizer.state_dict()["state"]
    assert att and all(not st[i]["exp_avg"].any() for i in att)
    back = dqn.DQNAgent(cfg, seed=5, device="cpu")
    back.load(os.path.join(d, "latest.ckpt"))
    for (k, p), q in zip(agent.net.named_parameters(), back.net.parameters()):
        assert torch.equal(p, q), k
    again = dqn.DQNAgent(dataclasses.replace(cfg, max_iteration=14), device="cpu")
    again.train(save_dir=d, resume=True, log=lambda *a: None)
    assert again.iteration == 14
    jagent = jdqn.DQNAgent(dataclasses.replace(JaxConfig(fusion=fusion), **SMOKE), seed=1)
    jagent.load(os.path.join(d, "latest.ckpt"), weights_only=True)
    assert set(jagent.params["fusion"]) == set(JAX_FUSION[fusion](jax.random.PRNGKey(0), 64))
