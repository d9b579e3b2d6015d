"""Banded large-graph duplex container: dense-band aggregation state.

For large single graphs (real multiplex nets, 10^4–10^6+ nodes) the model's
neighbourhood aggregation runs through the block-banded dense engine
(ops/dense_band.py) after a locality ordering, and the dismantling
environment runs on the host (env/host_env.py).  Liveness is rank-1
(covered mask -> row/col scales) and cascade-severed edges are base edits
(apply_severs), applied incrementally by the eval loop as the host env
reports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.graphs.ordering import apply_order, best_band_order
from mdcommunity_tpu_torch.ops.dense_band import (
    DenseBandGraph,
    build_dense_band,
    sever_edges,
)
from mdcommunity_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class BandedDuplex:
    """Large padded duplex graph backed by per-layer dense-band adjacency.

    dbg0/dbg1 : DenseBandGraph per layer (symmetric storage, ordered ids)
    node_mask : bool [pad_n] real-node mask
    n_nodes   : real node count
    n_edges   : undirected edge count per layer
    max_rank  : intact LMCC size
    """

    dbg0: DenseBandGraph
    dbg1: DenseBandGraph
    node_mask: torch.Tensor
    n_nodes: int
    n_edges: Tuple[int, int]
    max_rank: int

    @property
    def pad_n(self) -> int:
        return self.dbg0.pad_n

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    def dbg(self, layer: int) -> DenseBandGraph:
        return self.dbg0 if layer == 0 else self.dbg1

    @property
    def spill_free(self) -> bool:
        """True when neither layer has spill edges: the fused SAGE step
        (kernel K2) applies."""
        return self.dbg0.spill.nnz == 0 and self.dbg1.spill.nnz == 0


def build_banded_duplex(
    n_nodes: int,
    edges0: np.ndarray,
    edges1: np.ndarray,
    S: int = 256,
    B: int = 128,
    reorder: bool = True,
    max_rank: Optional[int] = None,
    device=None,
) -> Tuple[BandedDuplex, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Build from undirected edge arrays [M, 2] (original node ids).

    Returns (banded, perm, (ordered_edges0, ordered_edges1)): perm maps new
    position -> original id, and the ordered edge arrays (new ids) feed the
    host environment.  The ordering, the mirror capacity and the spill are
    chosen exactly as the JAX package's build_banded_duplex chooses them."""
    device = resolve_device(device)
    edges0 = np.asarray(edges0, np.int64).reshape(-1, 2)
    edges1 = np.asarray(edges1, np.int64).reshape(-1, 2)
    if reorder:
        # fewest band misses among input order, RCM and (when both miss the
        # band badly) circular seriation
        perm = best_band_order(
            [edges0[:, 0], edges1[:, 0]], [edges0[:, 1], edges1[:, 1]],
            n_nodes, B,
        )
    else:
        perm = np.arange(n_nodes, dtype=np.int64)

    ordered, sym = [], []
    for e in (edges0, edges1):
        s, d = apply_order(perm, e[:, 0], e[:, 1])
        ordered.append(np.stack([s, d], axis=1))
        sym.append((np.concatenate([s, d]), np.concatenate([d, s])))
    # adaptive mirror capacity: grow C (one schedule for both layers) until
    # spill is < 0.2% of edges or the cap is reached
    for mm in (64, 128, 256):
        dbgs = [
            build_dense_band(ss, dd, n_nodes, S=S, B=B, max_mirror=mm, device=device)
            for ss, dd in sym
        ]
        n_spill = sum(g.spill.nnz for g in dbgs)
        n_all = max(sum(len(ss) for ss, _ in sym), 1)
        if n_spill / n_all < 0.002:
            break
    pad_n = dbgs[0].pad_n
    node_mask = torch.zeros(pad_n, dtype=torch.bool, device=device)
    node_mask[:n_nodes] = True

    if max_rank is None:
        from mdcommunity_tpu_torch.env.host_env import make_host_env

        max_rank = make_host_env(n_nodes, ordered[0], ordered[1]).max_rank

    banded = BandedDuplex(
        dbg0=dbgs[0],
        dbg1=dbgs[1],
        node_mask=node_mask,
        n_nodes=int(n_nodes),
        n_edges=(len(edges0), len(edges1)),
        max_rank=int(max_rank),
    )
    return banded, perm, (ordered[0], ordered[1])


def apply_severs(
    banded: BandedDuplex,
    layer: int,
    sev_src: torch.Tensor,
    sev_dst: torch.Tensor,
    valid: torch.Tensor,
) -> BandedDuplex:
    """Zero newly severed undirected edges in one layer's band (both
    directed copies), in place.  sev_src/sev_dst: int [K], valid: bool [K]."""
    sever_edges(
        banded.dbg(layer),
        torch.cat([sev_src, sev_dst]),
        torch.cat([sev_dst, sev_src]),
        torch.cat([valid, valid]),
    )
    return banded
