"""Batch state -> model operands (the counterpart of PrepareBatchGraph).

The JAX package's env/batch.py, written as batched tensor operations (its
vmapped `_single_inputs`).  Nothing is renumbered: the batch keeps its
padded [B, N] layout, dead nodes are masked, and the operators are
live-edge weights (segment path) or dense adjacency matrices (dense path).

Feature parity notes (vs get_status_info / Setup_graph_input):
  * active node   = uncovered and has a live edge (the survivor sets of both
    layers coincide after the cascade, PrepareBatchGraph.py:73)
  * node_input[l] = live degree / max live degree of the graph, duplicated
    to 2 channels (net :102-111); the degree-cost variant uses [weight, 1]
    (degree_cost/PrepareBatchGraph.py:133-136); CE appends its prior.
  * aux[l] = [ |covered|/N, covered_edges_l/|E_l|, wedges_l/N², 1.0 ]
    (PrepareBatchGraph.py:92-101), covered_edges counting unsevered edges
    with a covered endpoint, wedges = Σ_v d_v(d_v-1)/2.
Degrees and edge counts are integer-valued, so every sum here is exact in
f32 in any order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mdcommunity_tpu_torch.env.cascade import endpoints_alive
from mdcommunity_tpu_torch.ops.aggregate import dense_adjacency


@dataclasses.dataclass(frozen=True)
class BatchInputs:
    """Model operands for a batch of dismantling states (leading axis B).

    adj       : f32[B, 2, N, N]  live adjacency (dense path; None for sparse)
    live_w    : f32[B, 2, E]     live-edge weights (sparse path)
    deg       : f32[B, 2, N]     live degrees
    active    : bool[B, N]       surviving (model-visible) nodes
    node_input: f32[B, 2, N, F]  input features per layer
    aux       : f32[B, 2, 4]     per-graph aux features
    n_dir_live: f32[B, 2]        directed live-edge counts (Laplacian loss denom)
    """

    adj: Optional[torch.Tensor]
    live_w: torch.Tensor
    deg: torch.Tensor
    active: torch.Tensor
    node_input: torch.Tensor
    aux: torch.Tensor
    n_dir_live: torch.Tensor


def make_batch_inputs(
    g,
    covered: torch.Tensor,
    sever: torch.Tensor,
    dense: bool = True,
    variant: str = "unit_cost",
) -> BatchInputs:
    """Operands of a batched DuplexGraph in states (covered [B, N],
    sever [B, 2, E]); variant "unit_cost", "degree_cost" or "ce"."""
    if variant not in ("unit_cost", "degree_cost", "ce"):
        raise NotImplementedError(f"variant {variant!r} has no batch inputs here")
    pad_n = g.pad_n
    ep_alive = endpoints_alive(g.src, g.dst, covered)
    live = g.edge_mask & ~sever & ep_alive                     # [B, 2, E]
    w = live.to(torch.float32)
    deg = torch.zeros(w.shape[:-1] + (pad_n,), device=w.device)
    deg.scatter_add_(-1, g.src, w)                              # [B, 2, N]
    active = (~covered) & g.node_mask & (deg[:, 0] > 0)         # [B, N]
    act2 = active[:, None, :]
    zero = torch.zeros((), device=w.device)

    if variant == "degree_cost":
        base = torch.stack([g.weights, torch.ones_like(g.weights)], dim=-1)
        node_input = torch.where(act2[..., None], base, zero)
    else:
        maxdeg = torch.amax(torch.where(act2, deg, zero), dim=-1)       # [B, 2]
        nd = deg / torch.clamp(maxdeg, min=1e-12)[..., None]
        nd = torch.where(act2, nd, zero)
        feats = [nd, nd]
        if variant == "ce":
            feats.append(torch.where(act2, g.node_feat, zero))
        node_input = torch.stack(feats, dim=-1)                         # [B, 2, N, F]

    n_f = g.n_nodes.to(torch.float32)                                   # [B]
    cov_frac = torch.sum(covered & g.node_mask, dim=-1).to(torch.float32) / n_f
    cov_edge = g.edge_mask & ~sever & ~ep_alive
    counter = torch.sum(cov_edge, dim=-1).to(torch.float32) / 2.0      # [B, 2]
    e_cnt = torch.clamp(g.n_edges.to(torch.float32), min=1.0)
    wedges = torch.sum(deg * (deg - 1.0) / 2.0, dim=-1)               # [B, 2]
    aux = torch.stack(
        [
            cov_frac[:, None].expand(-1, 2),
            counter / e_cnt,
            wedges / (n_f * n_f)[:, None],
            torch.ones_like(wedges),
        ],
        dim=-1,
    )                                                                   # [B, 2, 4]
    adj = dense_adjacency(g.src, g.dst, w, pad_n) if dense else None
    return BatchInputs(
        adj=adj,
        live_w=w,
        deg=deg,
        active=active,
        node_input=node_input,
        aux=aux,
        n_dir_live=torch.sum(w, dim=-1),
    )
