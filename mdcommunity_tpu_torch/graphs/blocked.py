"""Blocked large-graph duplex container: the pair-slot edge order is the
graph's own edge order.

For large single graphs the model can aggregate through the blocked-pair
kernel K4 (ops/blocked_kernels.py), whose weight operand is w [P, T] in
pair-slot order.  Rather than permute live-edge weights every step, this
module builds a DuplexGraph whose src/dst/edge_mask arrays are already in
slot order (padding slots are masked-out (0, 0) edges), so

  * the cascade, the environment and the batch inputs run on slot-ordered
    arrays unchanged (they do not depend on edge order), and
  * the kernel's weight operand is live_w.reshape(P, T), a view: nothing on
    the path permutes it.

Node ids are RCM-reordered first (graphs/ordering.py): pair fill is a
locality property of the numbering.  The JAX package's graphs/blocked.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.graphs.duplex import DuplexGraph, build_duplex
from mdcommunity_tpu_torch.graphs.ordering import apply_order, rcm_order
from mdcommunity_tpu_torch.ops.blocked_kernels import BlockCOO, build_block_coo
from mdcommunity_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BlockedDuplex:
    """A large padded duplex graph in blocked-pair edge order.

    g    : DuplexGraph whose per-layer edge arrays are slot-ordered; pad_e =
           the larger layer's slot count (the shorter layer padded)
    bcoo : per-layer BlockCOO kernel layout
    perm : int64[n] new position -> original node id (identity if unordered)
    """

    g: DuplexGraph
    bcoo: Tuple[BlockCOO, BlockCOO]
    perm: np.ndarray

    @property
    def pad_n(self) -> int:
        return self.g.pad_n


def build_blocked_duplex(
    n_nodes: int,
    edges0: np.ndarray,
    edges1: np.ndarray,
    S: int = 512,
    T: int = 512,
    reorder: bool = True,
    weights: Optional[np.ndarray] = None,
    node_feat: Optional[np.ndarray] = None,
    max_rank: Optional[int] = None,
    device=None,
) -> BlockedDuplex:
    """A blocked duplex graph from undirected edge arrays [M, 2], on
    `device` (CUDA unless named).  Per-node attributes (indexed by original
    id) are permuted into the blocked order.  max_rank None computes it by
    the cascade on the intact graph, on `device`."""
    device = resolve_device(device)
    edges0 = np.asarray(edges0, np.int64).reshape(-1, 2)
    edges1 = np.asarray(edges1, np.int64).reshape(-1, 2)
    if reorder:
        perm = rcm_order(
            [edges0[:, 0], edges1[:, 0]], [edges0[:, 1], edges1[:, 1]], n_nodes
        )
    else:
        perm = np.arange(n_nodes, dtype=np.int64)
    pad_n = ((n_nodes + S - 1) // S) * S

    layers = []
    for e in (edges0, edges1):
        s, d = apply_order(perm, e[:, 0], e[:, 1])
        sd = np.concatenate([s, d])  # both orientations
        dd = np.concatenate([d, s])
        layers.append(build_block_coo(sd, dd, pad_n, S, T, device=device))

    pad_e = max(max(len(l[1]) for l in layers), 1)
    src = np.zeros((2, pad_e), np.int64)
    dst = np.zeros((2, pad_e), np.int64)
    mask = np.zeros((2, pad_e), bool)
    for l, (_, ss, dd, mm) in enumerate(layers):
        src[l, : len(ss)] = ss
        dst[l, : len(dd)] = dd
        mask[l, : len(mm)] = mm

    if weights is not None:
        weights = np.asarray(weights, np.float32)[..., perm]
    if node_feat is not None:
        node_feat = np.asarray(node_feat, np.float32)[..., perm]
    g = build_duplex(
        n_nodes, np.zeros((0, 2), np.int64), np.zeros((0, 2), np.int64),
        pad_nodes=pad_n, pad_edges=pad_e, weights=weights, node_feat=node_feat,
        max_rank=0, device=device,
    )
    # swap in the slot-ordered edge arrays (build_duplex made everything
    # node-indexed; edge arrays and counts are replaced wholesale)
    g = dataclasses.replace(
        g,
        src=torch.from_numpy(src).to(device),
        dst=torch.from_numpy(dst).to(device),
        edge_mask=torch.from_numpy(mask).to(device),
        n_edges=torch.tensor([len(edges0), len(edges1)], device=device),
    )
    if max_rank is None:
        from mdcommunity_tpu_torch.env.cascade import intact_max_rank

        rank = intact_max_rank(g)
    else:
        rank = torch.tensor(int(max_rank), device=device)
    g = dataclasses.replace(g, max_rank=rank)
    return BlockedDuplex(g=g, bcoo=tuple(l[0] for l in layers), perm=perm)
