"""The duplex-dismantling MDP over padded graphs, batched.

Reference: MvcEnv (mvc_env.py:8-162); the JAX package's env/env.py.  State
is a dataclass of masks with static shapes, for a batch of environments on
one device:

* Reset runs the cascade on the intact graph: the two layers' partitions
  usually disagree already, so edges are severed at t=0 exactly as the
  reference's s0 -> getMaxConnectedNodesNum -> Mcc.MCC call chain does
  (mvc_env.py:31-52,140-162).
* Terminal <=> some layer has no live edge, where live = not severed and
  both endpoints uncovered (mvc_env.py:128-131).
* reward = -(rank / max_rank) * cost(a) with cost(a) = 1/N for the unit
  variant (mvc_env.py:133-138) and (w0[a]/Σw0 + w1[a]/Σw1)/2 for the degree
  cost variant (MultiDismantler_degree_cost/mvc_env.py:127-133), in f32.
  Severed edges persist.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mdcommunity_tpu_torch.env.cascade import (
    cascade,
    cascade_from_scratch,
    endpoints_alive,
)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Environment state of a batch (leading axis B) or, from env_reset and
    env_step, of one graph.

    covered  : bool[B, N]    removed nodes
    sever    : bool[B, 2, E] cascade-severed directed edges (persistent)
    rank     : int64[B]      current LMCC size
    score    : f32[B]        accumulated Σ rank_t/(max_rank·N)
    t        : int64[B]      steps taken
    terminal : bool[B]
    """

    covered: torch.Tensor
    sever: torch.Tensor
    rank: torch.Tensor
    score: torch.Tensor
    t: torch.Tensor
    terminal: torch.Tensor

    def map(self, fn) -> "EnvState":
        return EnvState(**{f.name: fn(getattr(self, f.name))
                           for f in dataclasses.fields(self)})


def _live_layer_any(g, covered, sever) -> torch.Tensor:
    """bool[B, 2]: does layer l still have a live edge?"""
    live = g.edge_mask & ~sever & endpoints_alive(g.src, g.dst, covered)
    return live.any(dim=-1)


def batched_reset(g) -> EnvState:
    """Fresh states on a batch of graphs, with the t=0 cascade."""
    covered = torch.zeros_like(g.node_mask)
    res = cascade_from_scratch(g, covered)
    has_live = _live_layer_any(g, covered, res.sever)
    B = covered.shape[0]
    return EnvState(
        covered=covered,
        sever=res.sever,
        rank=res.rank,
        score=torch.zeros(B, dtype=torch.float32, device=covered.device),
        t=torch.zeros(B, dtype=torch.int64, device=covered.device),
        terminal=~has_live.all(dim=-1),
    )


def removal_cost(g, a: torch.Tensor, degree_cost: bool) -> torch.Tensor:
    """Per-action cost factor in the reward, f32[B] (module docstring);
    g batched, a int[B]."""
    if degree_cost:
        # summed in f64 (exact for these weights) and rounded once, so the
        # card and the CPU give the same bits whatever their sum order
        wsum = torch.sum(g.weights * g.node_mask[:, None, :], dim=-1,
                         dtype=torch.float64).to(torch.float32)  # [B, 2]
        wa = torch.gather(g.weights, 2, a.reshape(-1, 1, 1).expand(-1, 2, 1))[..., 0]
        return 0.5 * (wa[:, 0] / wsum[:, 0] + wa[:, 1] / wsum[:, 1])
    return 1.0 / g.n_nodes.to(torch.float32)


def batched_step(
    g, state: EnvState, actions: torch.Tensor, degree_cost: bool = False
) -> Tuple[EnvState, torch.Tensor]:
    """Remove node actions[b] in each graph b, run the cascade, return
    (new_state, reward f32[B]).  Stepping a terminal env is a masked no-op
    with reward 0, so a batch keeps running after some members finish."""
    actions = torch.as_tensor(actions, device=g.device).to(torch.int64)
    B = actions.shape[0]
    covered = state.covered.clone()
    covered[torch.arange(B, device=g.device), actions] = True
    res = cascade(g, covered, state.sever)
    norm = res.rank.to(torch.float32) / g.max_rank.to(torch.float32)
    reward = -norm * removal_cost(g, actions, degree_cost)
    has_live = _live_layer_any(g, covered, res.sever)
    new = EnvState(
        covered=covered,
        sever=res.sever,
        rank=res.rank,
        score=state.score - reward,
        t=state.t + 1,
        terminal=~has_live.all(dim=-1),
    )
    keep = state.terminal

    def pick(old, nw):
        k = keep.reshape((B,) + (1,) * (old.dim() - 1))
        return torch.where(k, old, nw)

    new = EnvState(**{f.name: pick(getattr(state, f.name), getattr(new, f.name))
                      for f in dataclasses.fields(EnvState)})
    return new, torch.where(keep, torch.zeros_like(reward), reward)


def _one(g):
    return g.map(lambda t: t[None])


def env_reset(g) -> EnvState:
    """Fresh state on one graph (fields without the batch axis)."""
    return batched_reset(_one(g)).map(lambda t: t[0])


def env_step(g, state: EnvState, a, degree_cost: bool = False) -> Tuple[EnvState, torch.Tensor]:
    """batched_step on one graph and one action."""
    a = torch.as_tensor(a, device=g.device).reshape(1)
    new, r = batched_step(_one(g), state.map(lambda t: t[None]), a, degree_cost)
    return new.map(lambda t: t[0]), r[0]


def valid_action_mask(g, state: EnvState) -> torch.Tensor:
    """bool[B, N]: uncovered nodes with a live edge in both layers
    (reference randomAction, mvc_env.py:89-101)."""
    live = g.edge_mask & ~state.sever & endpoints_alive(g.src, g.dst, state.covered)
    deg = torch.zeros(live.shape[:-1] + (g.pad_n,), dtype=torch.int64, device=g.device)
    deg.scatter_add_(-1, g.src, live.to(torch.int64))
    return (~state.covered) & g.node_mask & (deg[:, 0] > 0) & (deg[:, 1] > 0)


def batched_valid_mask(g, state: EnvState) -> torch.Tensor:
    """valid_action_mask of a batch (the JAX package's vmapped form; the
    port's valid_action_mask is batched already)."""
    return valid_action_mask(g, state)


def is_terminal(state: EnvState) -> torch.Tensor:
    return state.terminal


def random_action(g, state: EnvState, u: torch.Tensor,
                  boundary_first: bool = False) -> torch.Tensor:
    """Uniform over each graph's valid actions (reference randomAction,
    mvc_env.py:89-101), int64[B]: graph b takes its floor(u[b]·count)-th
    valid node in index order, for draws u f32/f64[B] in [0, 1) on g's
    device; a graph with no valid action gets node 0 (a masked no-op on a
    terminal env).  boundary_first=True draws from the graph's CE boundary
    candidates (valid and g.boundary) while any remain (reference
    CEMultiDismantler/mvc_env.getValidActions :85-100).

    The JAX package draws with jax.random.categorical over 0/-inf logits
    from a jax.random key.  The port does not import JAX and cannot
    reproduce that key stream: its draws are uniforms from a
    torch.Generator (batched_random_actions), the same distribution with
    other numbers."""
    mask = valid_action_mask(g, state)
    if boundary_first:
        cand = mask & g.boundary
        mask = torch.where(cand.any(dim=1, keepdim=True), cand, mask)
    cnt = mask.sum(dim=1)
    k = torch.minimum((u * cnt).to(torch.int64), (cnt - 1).clamp(min=0))
    pos = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    return torch.argmax((mask & (pos == k[:, None])).to(torch.int8), dim=1)


def batched_random_actions(g, state: EnvState, generator: torch.Generator,
                           boundary_first: bool = False) -> torch.Tensor:
    """random_action with one uniform a graph drawn from `generator`, a
    torch.Generator on the CPU: the draws are made there and moved to g's
    device, so a run on the card and one on the CPU take the same actions
    from the same generator state."""
    u = torch.rand(state.covered.shape[0], generator=generator, dtype=torch.float64)
    return random_action(g, state, u.to(g.device), boundary_first)


def hca_bridge_bonus(g, state: EnvState, a: torch.Tensor, tau: float = 0.5) -> torch.Tensor:
    """HCA's bridge-reward shaping term of a batch, f32[B] (the JAX
    package's hca_bridge_bonus, vmapped), from the PRE-step state: the live
    directed edges out of a[b] whose endpoints lie in different communities
    of their layer, over a[b]'s live directed edges (+1e-6), both layers
    counted, and 0 unless f_het(a[b]) > tau (reference
    HCA-Dismantler/mvc_env.getReward :258-300, with the pre-removal
    neighbourhood that Config.hca_bridge_effective asks for)."""
    a = torch.as_tensor(a, device=g.device).to(torch.int64)
    live = g.edge_mask & ~state.sever & endpoints_alive(g.src, g.dst, state.covered)
    at_a = live & (g.src == a[:, None, None])                    # [B, 2, E]
    inter = at_a & (torch.gather(g.comm_id, 2, g.src) != torch.gather(g.comm_id, 2, g.dst))
    deg = at_a.sum(dim=(1, 2)).to(torch.float32)
    bonus = inter.sum(dim=(1, 2)).to(torch.float32) / (deg + 1e-6)
    f_het = torch.gather(g.hca_feat[..., 0], 1, a[:, None])[:, 0]
    return torch.where(f_het > tau, bonus, torch.zeros_like(bonus))


def prune_q_to_boundary(q: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """CE's divide-and-conquer action pruning (the JAX package's
    prune_q_to_boundary; reference CEMultiDismantler/MultiDismantler_torch.
    _apply_action_pruning :159-175): while a graph has a boundary node with
    finite Q, every other node goes to -inf.  q [B, N] with invalid actions
    at -inf already; boundary bool [B, N]."""
    cand = boundary & torch.isfinite(q)
    has = cand.any(dim=1, keepdim=True)
    return torch.where(has & ~cand, torch.full_like(q, -float("inf")), q)
