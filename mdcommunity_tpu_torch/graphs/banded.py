"""Banded large-graph duplex container: dense-band aggregation state.

For large single graphs (real multiplex nets, 10^4–10^6+ nodes) the model's
neighbourhood aggregation runs through the block-banded dense engine
(ops/dense_band.py) after a locality ordering, and the dismantling
environment runs on the host (env/host_env.py).  Liveness is rank-1
(covered mask -> row/col scales) and cascade-severed edges are base edits
(apply_severs), applied incrementally by the eval loop as the host env
reports them.  Severs edit the band in place, so a BandedDuplex serves one
rollout; fork_banded copies what they edit.  shard_banded_duplex splits a
BandedDuplex over a gp mesh (parallel/); severs, fork_banded and
restore_banded work on the sharded duplex too.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.graphs.ordering import apply_order, best_band_order
from mdcommunity_tpu_torch.ops.dense_band import (
    DenseBandGraph,
    build_dense_band,
    sever_edges,
)
from mdcommunity_tpu_torch.parallel.band_partition import (
    ShardedBandGraph,
    fork_sharded,
    restore_sharded,
    sever_sharded,
    shard_band_graph,
)
from mdcommunity_tpu_torch.parallel.mesh import GpMesh, split_nodes
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


@dataclasses.dataclass
class ShardedBandedDuplex:
    """A BandedDuplex split over a gp mesh (shard_banded_duplex): both
    layers' operators as ShardedBandGraphs and node_mask as its shard
    pieces.  It has no spill (the sharded operator refuses it)."""

    mesh: GpMesh
    dbg0: ShardedBandGraph
    dbg1: ShardedBandGraph
    node_mask: List[torch.Tensor]
    n_nodes: int
    n_edges: Tuple[int, int]
    max_rank: int

    @property
    def pad_n(self) -> int:
        return self.dbg0.pad_n

    @property
    def device(self) -> torch.device:
        """The first shard's device (where Q and the loss are gathered)."""
        return self.mesh.devices[0]

    def dbg(self, layer: int) -> ShardedBandGraph:
        return self.dbg0 if layer == 0 else self.dbg1

    @property
    def spill_free(self) -> bool:
        return True


def shard_banded_duplex(mesh: GpMesh, banded: BandedDuplex) -> ShardedBandedDuplex:
    """Split a BandedDuplex over the mesh's shards for the gp-sharded
    forward, loss and trainer (the JAX package's shard_banded_duplex):
    views of banded's tensors where a shard shares its device.  Raises
    ValueError on spill edges or a block count the shards do not divide."""
    return ShardedBandedDuplex(
        mesh=mesh,
        dbg0=shard_band_graph(mesh, banded.dbg0),
        dbg1=shard_band_graph(mesh, banded.dbg1),
        node_mask=split_nodes(mesh, banded.node_mask),
        n_nodes=banded.n_nodes,
        n_edges=banded.n_edges,
        max_rank=banded.max_rank,
    )


def build_banded_duplex(
    n_nodes: int,
    edges0: np.ndarray,
    edges1: np.ndarray,
    S: int = 256,
    B: int = 128,
    reorder: bool = True,
    max_rank: Optional[int] = None,
    device=None,
    nibble: bool = False,
) -> Tuple[BandedDuplex, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Build from undirected edge arrays [M, 2] (original node ids).

    Returns (banded, perm, (ordered_edges0, ordered_edges1)): perm maps new
    position -> original id, and the ordered edge arrays (new ids) feed the
    host environment.  The ordering, the mirror capacity and the spill are
    chosen exactly as the JAX package's build_banded_duplex chooses them.
    nibble=True stores both layers' bases in nibbles (ops/dense_band.py; the
    counterpart of the JAX package's pack_duplex(nibble=True), the port
    having no pack step): a band value above 7 raises ValueError.  Severs,
    shard_banded_duplex, fork_banded and restore_banded carry it."""
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
            build_dense_band(ss, dd, n_nodes, S=S, B=B, max_mirror=mm, device=device,
                             nibble=nibble)
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
    banded,
    layer: int,
    sev_src: torch.Tensor,
    sev_dst: torch.Tensor,
    valid: torch.Tensor,
) -> BandedDuplex:
    """Zero newly severed undirected edges in one layer's band (both
    directed copies), in place, on a BandedDuplex or a ShardedBandedDuplex.
    sev_src/sev_dst: int [K], valid: bool [K]."""
    dbg = banded.dbg(layer)
    sever = sever_sharded if isinstance(dbg, ShardedBandGraph) else sever_edges
    sever(
        dbg,
        torch.cat([sev_src, sev_dst]),
        torch.cat([sev_dst, sev_src]),
        torch.cat([valid, valid]),
    )
    return banded


def fork_banded(banded):
    """A copy whose severs leave `banded` as it is: the tensors that
    sever_edges edits (base, w_cov, w_spill) are cloned, the graph
    constants (index arrays, COOs, mask) shared.  Also for a
    ShardedBandedDuplex."""

    def fork(dbg):
        if isinstance(dbg, ShardedBandGraph):
            return fork_sharded(dbg)
        return dataclasses.replace(
            dbg, base=dbg.base.clone(), w_cov=dbg.w_cov.clone(),
            w_spill=dbg.w_spill.clone(),
        )

    return dataclasses.replace(banded, dbg0=fork(banded.dbg0), dbg1=fork(banded.dbg1))


def restore_banded(dst, src):
    """Copy the severable tensors of `src` (a build, or fork_banded of the
    same build) into `dst`, in place: undoes every sever made on dst.  Both
    BandedDuplex, or both ShardedBandedDuplex of one mesh."""
    for layer in range(2):
        d, s = dst.dbg(layer), src.dbg(layer)
        if isinstance(d, ShardedBandGraph):
            restore_sharded(d, s)
            continue
        d.base.copy_(s.base)
        d.w_cov.copy_(s.w_cov)
        d.w_spill.copy_(s.w_spill)
    return dst
