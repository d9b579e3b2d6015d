"""Duplex (two-layer interdependent) graph containers with static, padded shapes.

Every graph is padded once to a (pad_nodes, pad_edges) envelope and node
death is a mask, never a reshape (the JAX package's graphs/duplex.py).  A
batch of graphs is the same dataclass with a leading batch axis on every
field; the cascade, the environment and the model take batches.

Edges are stored as directed pairs (both orientations of each undirected
edge), so neighbourhood aggregation is one segment sum or one dense matmul,
and the undirected edge count of a layer is edge_mask.sum() / 2.  Padding
edges point at node 0 with edge_mask False.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DuplexGraph:
    """A (possibly batched) padded duplex graph; torch tensors on one device.

    Unbatched shapes (a batch adds a leading axis B to each):
      src, dst    : int64[2, E]  directed endpoints; padding rows point at node 0
      edge_mask   : bool[2, E]   True for real directed edges
      node_mask   : bool[N]      True for real nodes
      n_nodes     : int64[]      true node count
      n_edges     : int64[2]     true undirected edge counts per layer
      max_rank    : int64[]      LMCC size of the intact duplex graph
      weights     : f32[2, N]    per-layer node removal-cost weights
      node_feat   : f32[2, N]    static per-layer node prior feature (CE)
      boundary    : bool[N]      CE boundary-node flag
      comm_id     : int64[2, N]  HCA per-layer community index
      n_comms     : int64[2]     HCA community counts per layer
      hca_feat    : f32[N, 3]    HCA node features
    """

    src: torch.Tensor
    dst: torch.Tensor
    edge_mask: torch.Tensor
    node_mask: torch.Tensor
    n_nodes: torch.Tensor
    n_edges: torch.Tensor
    max_rank: torch.Tensor
    weights: torch.Tensor
    node_feat: torch.Tensor
    boundary: torch.Tensor
    comm_id: torch.Tensor
    n_comms: torch.Tensor
    hca_feat: torch.Tensor

    @property
    def pad_n(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def pad_e(self) -> int:
        return self.src.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.node_mask.device

    @property
    def batched(self) -> bool:
        return self.node_mask.dim() == 2

    def map(self, fn) -> "DuplexGraph":
        """The graph with `fn` applied to every field."""
        return DuplexGraph(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})

    def degrees(self) -> torch.Tensor:
        """Structural (intact-graph) per-layer degrees, f32[..., 2, N]."""
        w = self.edge_mask.to(torch.float32)
        out = torch.zeros(w.shape[:-1] + (self.pad_n,), device=self.device)
        return out.scatter_add_(-1, self.src, w)


def _pad_edges_np(edges: np.ndarray, pad_e: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """edges: int array [M, 2] of undirected pairs -> directed padded (src, dst, mask)."""
    if len(edges) == 0:
        return np.zeros(pad_e, np.int64), np.zeros(pad_e, np.int64), np.zeros(pad_e, bool)
    e = np.asarray(edges, np.int64)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    m = len(src)
    if m > pad_e:
        raise ValueError(f"graph has {m} directed edges > pad_edges={pad_e}")
    pad = pad_e - m
    src = np.concatenate([src, np.zeros(pad, np.int64)])
    dst = np.concatenate([dst, np.zeros(pad, np.int64)])
    mask = np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])
    return src, dst, mask


def _clean(e: np.ndarray) -> np.ndarray:
    """Drop self loops and duplicate undirected edges (sorted (lo, hi) rows)."""
    if len(e) == 0:
        return e
    e = e[e[:, 0] != e[:, 1]]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    return np.unique(np.stack([lo, hi], 1), axis=0)


def _padded(x: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    """x copied into the leading corner of zeros(shape); zeros when None."""
    out = np.zeros(shape, dtype)
    if x is not None:
        x = np.asarray(x, dtype)
        out[tuple(slice(0, k) for k in x.shape)] = x
    return out


def build_duplex(
    n_nodes: int,
    edges0: Sequence[Tuple[int, int]],
    edges1: Sequence[Tuple[int, int]],
    pad_nodes: int,
    pad_edges: int,
    weights: Optional[np.ndarray] = None,
    node_feat: Optional[np.ndarray] = None,
    boundary: Optional[np.ndarray] = None,
    max_rank: Optional[int] = None,
    comm_id: Optional[np.ndarray] = None,
    n_comms: Optional[np.ndarray] = None,
    hca_feat: Optional[np.ndarray] = None,
    device=None,
) -> DuplexGraph:
    """A padded DuplexGraph from undirected edge lists, on `device` (CUDA
    unless the caller names one).

    Self loops and duplicate edges are dropped.  If max_rank is None it is
    computed by the cascade on the intact graph, on `device`."""
    device = resolve_device(device)
    if pad_nodes < n_nodes:
        raise ValueError(f"pad_nodes={pad_nodes} < n_nodes={n_nodes}")
    e0 = _clean(np.asarray(list(edges0), np.int64).reshape(-1, 2))
    e1 = _clean(np.asarray(list(edges1), np.int64).reshape(-1, 2))
    s0, d0, m0 = _pad_edges_np(e0, pad_edges)
    s1, d1, m1 = _pad_edges_np(e1, pad_edges)
    if weights is None:
        weights = np.ones((2, pad_nodes), np.float32)
    else:
        weights = _padded(weights, (2, pad_nodes), np.float32)
    if node_feat is not None:
        node_feat = np.asarray(node_feat, np.float32)
        if node_feat.ndim == 1:
            node_feat = np.stack([node_feat, node_feat])
    arrays = dict(
        src=np.stack([s0, s1]),
        dst=np.stack([d0, d1]),
        edge_mask=np.stack([m0, m1]),
        node_mask=np.arange(pad_nodes) < n_nodes,
        n_nodes=np.int64(n_nodes),
        n_edges=np.asarray([len(e0), len(e1)], np.int64),
        max_rank=np.int64(0 if max_rank is None else max_rank),
        weights=weights,
        node_feat=_padded(node_feat, (2, pad_nodes), np.float32),
        boundary=_padded(boundary, (pad_nodes,), bool),
        comm_id=_padded(comm_id, (2, pad_nodes), np.int64),
        n_comms=_padded(n_comms, (2,), np.int64),
        hca_feat=_padded(hca_feat, (pad_nodes, 3), np.float32),
    )
    g = DuplexGraph(**{k: torch.as_tensor(v).to(device) for k, v in arrays.items()})
    if max_rank is None:
        from mdcommunity_tpu_torch.env.cascade import intact_max_rank

        g = dataclasses.replace(g, max_rank=intact_max_rank(g))
    return g


def stack_graphs(graphs: List[DuplexGraph]) -> DuplexGraph:
    """Stack same-padding graphs into a batched DuplexGraph (leading axis B)."""
    return DuplexGraph(**{
        f.name: torch.stack([getattr(g, f.name) for g in graphs])
        for f in dataclasses.fields(DuplexGraph)
    })


def index_graphs(batched: DuplexGraph, idx) -> DuplexGraph:
    """A sub-batch of a batched DuplexGraph by integer indices."""
    idx = torch.as_tensor(idx, device=batched.device)
    return batched.map(lambda t: t[idx])


class GraphPool:
    """Train/valid graph pools (reference: GSet, graph.py:49-67): a list of
    graphs, stacked into one batch on first use."""

    def __init__(self):
        self._graphs: List[DuplexGraph] = []
        self._stacked: Optional[DuplexGraph] = None
        self._stacked_s0 = None

    def insert(self, g: DuplexGraph):
        self._graphs.append(g)
        self._stacked = None
        self._stacked_s0 = None

    def clear(self):
        self._graphs = []
        self._stacked = None
        self._stacked_s0 = None

    def __len__(self):
        return len(self._graphs)

    @property
    def stacked(self) -> DuplexGraph:
        if self._stacked is None:
            if not self._graphs:
                raise ValueError("empty GraphPool")
            self._stacked = stack_graphs(self._graphs)
        return self._stacked

    @property
    def stacked_s0(self):
        """Batched reset EnvState of every pool graph, computed once."""
        if self._stacked_s0 is None:
            from mdcommunity_tpu_torch.env.env import batched_reset

            self._stacked_s0 = batched_reset(self.stacked)
        return self._stacked_s0

    def get(self, gid: int) -> DuplexGraph:
        return self._graphs[gid]
