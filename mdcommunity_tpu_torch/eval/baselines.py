"""Adaptive heuristic dismantling baselines: HDA / HBA / HCA / CI / PageRank.

Reference: the standalone scripts under baseline/{HDA,HBA,HCA,CI}/ of each
variant (hda_2max.py, hda_add.py, ci_max.py, hba_2max.py, hca_2max.py,
hda_2max_protect.py), as the JAX package's eval/baselines.py runs them:

  * adaptive: every step recomputes each layer's centrality on the current
    (cascade-reduced) live graphs;
  * the two layers' scores combine by max (``max2``) or sum (``add``);
  * the first node of highest score is removed (numpy's argmax rule; degree
    scores tie everywhere), the MCC cascade runs, and score += rank /
    (max_rank · N) with the rank after the cascade;
  * the run stops when the LMCC rank reaches 1, or with ``syn_stop`` the
    `_syn` scripts' sqrt(N) (hda_2max_syn.py:78-81);
  * ``protect_frac`` makes the top fraction of nodes by initial combined
    degree immune (hda_2max_protect.py:61-68), taken by numpy's argsort as
    the JAX package takes it (torch.sort orders ties otherwise).

The environment runs on the graph's device (env/env.py).  Degree and CI are
computed there from the live masks in float64: their values are integers, so
any summation order gives the same result.  Betweenness, closeness and
PageRank run on the host on the live subgraph, by graphs/centrality.py (the
algorithms of networkx 3.6.1, whose scores they equal bit for bit), with the
masks pulled to the host once a step.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.env.env import batched_reset, batched_step
from mdcommunity_tpu_torch.graphs.centrality import CENTRALITIES, adjacency
from mdcommunity_tpu_torch.graphs.duplex import DuplexGraph, stack_graphs

METHODS = ("degree", "betweenness", "closeness", "ci", "pagerank")
COMBINES = ("max2", "add")


def _live(g: DuplexGraph, covered: torch.Tensor, sever: torch.Tensor) -> torch.Tensor:
    """bool[2, E]: real, unsevered edges with both endpoints uncovered."""
    return g.edge_mask & ~sever & ~covered[g.src] & ~covered[g.dst]


def _degrees(g: DuplexGraph, live: torch.Tensor) -> torch.Tensor:
    """f64[2, pad_n]: each node's count of `live` (f64[2, E]) out-edges."""
    deg = torch.zeros((2, g.pad_n), dtype=torch.float64, device=g.device)
    return deg.scatter_add_(1, g.src, live)


def _live_degrees(g: DuplexGraph, covered: torch.Tensor, sever: torch.Tensor) -> torch.Tensor:
    """f64[2, pad_n] live degrees, on the graph's device."""
    return _degrees(g, _live(g, covered, sever).to(torch.float64))


def _ci_scores(g: DuplexGraph, covered: torch.Tensor, sever: torch.Tensor) -> torch.Tensor:
    """Collective influence CI(u) = (k_u - 1) · Σ_{v ∈ N(u)} (k_v - 1) per
    layer (reference: MultiDismantler_torch.py:845-861, ci_max.py), -1 where
    k_u = 0 (basic_ci :849-850); f64[2, pad_n] on the graph's device."""
    live = _live(g, covered, sever).to(torch.float64)
    deg = _degrees(g, live)
    acc = torch.zeros_like(deg).scatter_add_(
        1, g.dst, (torch.gather(deg, 1, g.src) - 1.0) * live)
    out = (deg - 1.0) * acc
    return torch.where(deg == 0, torch.full_like(out, -1.0), out)


def _centrality(g: DuplexGraph, covered: np.ndarray, sever: np.ndarray,
                kind: str) -> np.ndarray:
    """f64[2, pad_n] scores of each layer's live subgraph (uncovered nodes
    v < n in ascending order, live edges in stored order), 0 elsewhere."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    em = g.edge_mask.cpu().numpy()
    live = em & ~sever & ~covered[src] & ~covered[dst]
    n = int(g.n_nodes)
    nodes = [v for v in range(n) if not covered[v]]
    out = np.zeros((2, g.pad_n), np.float64)
    for l in range(2):
        adj = adjacency(nodes, zip(src[l][live[l]].tolist(), dst[l][live[l]].tolist()))
        for v, val in CENTRALITIES[kind](adj).items():
            out[l, v] = val
    return out


def heuristic_dismantle(
    g: DuplexGraph,
    method: str = "degree",
    combine: str = "max2",
    protect_frac: float = 0.0,
    syn_stop: bool = False,
) -> Tuple[List[int], float, List[float]]:
    """One adaptive heuristic dismantling of an unbatched DuplexGraph, on its
    device.

    syn_stop=True uses the `_syn` scripts' convention: stop once the LMCC
    rank falls to sqrt(N) (hda_2max_syn.py:78-81) instead of 1.

    Returns (solution, score, MaxCCList curve starting at 1.0)."""
    if method not in METHODS or combine not in COMBINES:
        raise ValueError(f"method must be one of {METHODS} and combine one of "
                         f"{COMBINES}, got {method!r}, {combine!r}")
    gb = stack_graphs([g])
    state = batched_reset(gb)
    n = int(g.n_nodes)
    dev = g.device

    blocked = ~g.node_mask  # padding nodes are never picked
    if protect_frac > 0:
        deg0 = _live_degrees(g, torch.zeros_like(g.node_mask),
                             torch.zeros_like(g.edge_mask)).cpu().numpy()
        comb0 = deg0.max(0) if combine == "max2" else deg0.sum(0)
        k = max(1, int(protect_frac * n))
        protected = np.zeros(g.pad_n, bool)
        protected[np.argsort(-comb0[:n])[:k]] = True
        blocked = blocked | torch.from_numpy(protected).to(dev)

    sol: List[int] = []
    curve: List[float] = [1.0]
    score = 0.0
    max_rank = float(g.max_rank)
    stop_rank = float(np.sqrt(n)) if syn_stop else 1.0
    neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)

    while float(state.rank[0]) > stop_rank and len(sol) < n:
        covered, sever = state.covered[0], state.sever[0]
        if method == "degree":
            c = _live_degrees(g, covered, sever)
        elif method == "ci":
            c = _ci_scores(g, covered, sever)
        else:
            c = torch.from_numpy(_centrality(
                g, covered.cpu().numpy(), sever.cpu().numpy(), method)).to(dev)
        comb = c.max(0).values if combine == "max2" else c.sum(0)
        comb = torch.where(covered | blocked, neg_inf, comb).cpu().numpy()
        a = int(np.argmax(comb))
        if not np.isfinite(comb[a]):
            break
        state, _ = batched_step(gb, state, torch.tensor([a], device=dev))
        sol.append(a)
        r = float(state.rank[0])
        curve.append(r / max_rank)
        score += r / (max_rank * n)
    return sol, score, curve


def hxa(g: DuplexGraph, method: str = "HDA") -> Tuple[float, List[int]]:
    """The agent-side heuristic comparator of the reference
    (MultiDismantler_torch.HXA :821-843): 'HDA', 'HBA', 'HCA' and 'HPRA' map
    onto the adaptive duplex heuristics above, combined by max; returns
    (robustness score, solution)."""
    name = {
        "HDA": "degree",
        "HBA": "betweenness",
        "HCA": "closeness",
        "HPRA": "pagerank",
    }[method]
    sol, score, _ = heuristic_dismantle(g, method=name, combine="max2")
    return score, sol
