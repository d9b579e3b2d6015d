"""Community priors of the community-enhanced (CE) variant (the JAX
package's graphs/community.py).

Reference: CEMultiDismantler/dataset.py: a Louvain partition per layer,
the participation coefficient P(u) = 1 - Σ_c (k_c/k)², boundary flags, and
the union boundary-node set used for action pruning; cached as .npz
(_attach_static_comm_prior, CEMultiDismantler/MultiDismantler_torch.py:177-240).

The partition is graphs/louvain.py's, which gives networkx's
louvain_communities exactly, so the features equal the JAX package's: P
sums its (k_c/k)² terms in the order of each node's neighbours in the
networkx graph, as the JAX package does.  The cache file keeps the JAX
package's name (comm_prior_<id>_<feature>.npz) and keys (n, feats,
boundary): a cache written by either package is read by the other.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Set, Tuple

import numpy as np

from mdcommunity_tpu_torch.graphs.louvain import Adj, graph_adjacency, louvain_communities


def louvain_partition(n: int, edges: Sequence, seed: int = 0) -> Dict[int, int]:
    """node -> community index of networkx's Louvain on the graph of
    `edges` over nodes 0..n-1."""
    part = {}
    for cid, nodes in enumerate(louvain_communities(n, edges, seed=seed)):
        for v in nodes:
            part[v] = cid
    return part


def participation_and_boundary(adj: Adj, part: Dict[int, int], n: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Participation coefficient and boundary flag per node, f32 [n] each,
    over the graph's adjacency (graphs/louvain.graph_adjacency)."""
    P = np.zeros(n, np.float32)
    boundary = np.zeros(n, np.float32)
    for u in range(n):
        u_comm = part.get(u, 0)
        neigh = list(adj[u])
        k = len(neigh)
        if k == 0:
            continue
        counts: Dict[int, int] = {}
        is_b = False
        for v in neigh:
            c = part.get(v, 0)
            counts[c] = counts.get(c, 0) + 1
            if c != u_comm:
                is_b = True
        P[u] = 1.0 - sum((c / k) ** 2 for c in counts.values())
        boundary[u] = 1.0 if is_b else 0.0
    return P, boundary


def compute_prior(n: int, edges: Sequence, feature: str = "boundary", seed: int = 0
                  ) -> Tuple[np.ndarray, Set[int]]:
    """(feature array [n] in [0, 1], boundary node set) of one layer;
    feature is "boundary", "participation" or "none"."""
    if feature == "none":
        return np.zeros(n, np.float32), set()
    part = louvain_partition(n, edges, seed=seed)
    P, boundary = participation_and_boundary(graph_adjacency(n, edges), part, n)
    feat = P if feature == "participation" else boundary
    feat = np.clip(np.nan_to_num(feat), 0.0, 1.0).astype(np.float32)
    return feat, set(np.where(boundary > 0.5)[0].tolist())


def duplex_prior(n: int, edges0: Sequence, edges1: Sequence, feature: str = "boundary",
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-layer prior features [2, n] and the union boundary mask [n]."""
    if feature == "none":
        return np.zeros((2, n), np.float32), np.zeros(n, bool)
    feats = np.zeros((2, n), np.float32)
    bset: Set[int] = set()
    for layer, edges in enumerate((edges0, edges1)):
        feats[layer], b = compute_prior(n, edges, feature, seed)
        bset |= b
    bmask = np.zeros(n, bool)
    bmask[sorted(bset)] = True
    return feats, bmask


def cached_duplex_prior(cache_dir: str, cache_id: str, n: int, edges0: Sequence,
                        edges1: Sequence, feature: str = "boundary", seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """duplex_prior through the npz cache <cache_dir>/comm_prior_<id>_<feature>.npz
    (reference cache/comm_prior_<id>_<feature>.npz); a file for another n is
    recomputed and overwritten."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"comm_prior_{cache_id}_{feature}.npz")
    if os.path.isfile(path):
        d = np.load(path)
        if int(d["n"]) == n:
            return d["feats"].astype(np.float32), d["boundary"].astype(bool)
    feats, bmask = duplex_prior(n, edges0, edges1, feature, seed)
    np.savez_compressed(path, n=np.int64(n), feats=feats, boundary=bmask)
    return feats, bmask

