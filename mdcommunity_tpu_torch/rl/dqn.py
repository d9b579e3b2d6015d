"""Greedy Q rollouts and validation over batches of padded graphs.

The JAX package's rl/dqn.py, its evaluation part: `predict_q` (batch
operands + forward, reference Predict :247-302), `greedy_rollout` (every
env to terminal with argmax actions, reference Test :738-755) and
`validate`, the agent's validation score over a seeded pool (score +
remaining/(max_rank·N), DQNAgent.validate).  The trainer, the replay and the
agent class come with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch

from mdcommunity_tpu_torch.env.batch import make_batch_inputs
from mdcommunity_tpu_torch.env.env import EnvState, batched_reset, batched_step
from mdcommunity_tpu_torch.graphs.duplex import GraphPool
from mdcommunity_tpu_torch.graphs.gmm import generate_pool
from mdcommunity_tpu_torch.models.net import test_forward
from mdcommunity_tpu_torch.utils.config import Config
from mdcommunity_tpu_torch.utils.device import resolve_device, set_precise_matmul


@torch.no_grad()
def predict_q(net, g, covered, sever, variant: str = "unit_cost", dense: bool = True,
              max_bp_iter: int = 3, aggregate_fn=None) -> torch.Tensor:
    """Batched Q(s, ·) [B, N] with dead and covered nodes at -inf;
    aggregate_fn replaces the dense or segment aggregation
    (models/net.make_blocked_aggregate)."""
    inputs = make_batch_inputs(g, covered, sever, dense=dense, variant=variant)
    return test_forward(net, g, inputs, max_bp_iter=max_bp_iter, aggregate_fn=aggregate_fn)


def greedy_rollout(net, g, state: EnvState, variant: str = "unit_cost",
                   degree_cost: bool = False, max_steps: int = 0) -> EnvState:
    """Roll every env of the batch to terminal with greedy argmax actions
    (the lowest index among equal maxima, as jnp.argmax); a Python loop in
    place of the JAX package's lax.while_loop, one host sync a step."""
    max_steps = max_steps or g.pad_n
    for _ in range(max_steps):
        if bool(state.terminal.all()):
            break
        q = predict_q(net, g, state.covered, state.sever, variant)
        state, _ = batched_step(g, state, torch.argmax(q, dim=1), degree_cost)
    return state


def make_valid_pool(cfg: Config, device=None) -> GraphPool:
    """The validation pool of cfg: n_valid GMM graphs drawn from
    np.random.default_rng(cfg.seed), as DQNAgent seeds and draws it
    (DQNAgent.__init__ then prepare_valid_data), on `device`."""
    if cfg.variant not in ("unit_cost", "degree_cost"):
        raise NotImplementedError(f"variant {cfg.variant!r}: its prior is not ported yet")
    device = resolve_device(device)
    pool = GraphPool()
    for g in generate_pool(
        np.random.default_rng(cfg.seed), cfg.n_valid, cfg.num_min, cfg.num_max,
        cfg.pad_nodes, cfg.pad_edges, cfg.variant == "degree_cost",
        g_corr=cfg.gmm_g, device=device,
    ):
        pool.insert(g)
    return pool


def validate(net, pool: GraphPool, variant: str = "unit_cost") -> float:
    """Mean normalised dismantling cost over the pool: a batched greedy
    rollout, score + remaining/(max_rank·N) per graph (reference Test
    :738-755; the JAX package's DQNAgent.validate), in true f32."""
    set_precise_matmul()
    g = pool.stacked
    state = greedy_rollout(net, g, batched_reset(g), variant,
                           degree_cost=variant == "degree_cost")
    covered_cnt = torch.sum(state.covered & g.node_mask, dim=1)
    remain = (g.n_nodes - covered_cnt).to(torch.float32)
    n_f = g.n_nodes.to(torch.float32)
    score = state.score + remain / (g.max_rank.to(torch.float32) * n_f)
    return float(torch.mean(score))
