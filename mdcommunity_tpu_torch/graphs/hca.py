"""HCA-Dismantler graph-side structures: per-layer communities and node
features (the JAX package's graphs/hca.py).

Reference: HCA-Dismantler/mvc_env.calculate_hca_features (:39-136), on the
intact graph at episode reset:
  * per-layer community partitions (Leiden in the reference; the JAX
    package uses networkx's Louvain, and the port graphs/louvain.py, which
    gives networkx's partition exactly)
  * f_het(u)    = 1 - Jaccard(C1(u), C2(u))
  * f_impact(u) = log(|C1(u)|+1) · log(|C2(u)|+1)
  * f_roi(u)    = f_het·f_impact / (deg1(u)+deg2(u)+eps)
stored as [N, 3] node features; community memberships become the model's
virtual-node rows with f_roi+1e-6 pooling weights (HCA
PrepareBatchGraph.subg_construct :430-473).

Every feature is formed in f64 with the JAX package's operations (math.log
of the sizes, IEEE +, -, *, /) and rounded to f32 once, so it is the JAX
package's value bit for bit; the intersection of two communities is a count
over the pairs (C1(u), C2(u)).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from mdcommunity_tpu_torch.graphs.louvain import louvain_labels


def _degrees(n: int, edges: Sequence) -> np.ndarray:
    """Each node's degree in `nx.Graph(); add_nodes_from(range(n));
    add_edges_from(edges)`: a repeated edge counts once, a self loop twice."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    keys = np.unique(np.minimum(e[:, 0], e[:, 1]) * n + np.maximum(e[:, 0], e[:, 1]))
    return np.bincount(keys // n, minlength=n) + np.bincount(keys % n, minlength=n)


def hca_communities_and_features(n: int, edges0: Sequence, edges1: Sequence, seed: int = 0,
                                 stats: Optional[dict] = None
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (comm_id [2, n] int32, n_comms [2] int32, hca_feat [n, 3] f32).
    With `stats`, louvain_labels' lists (a layer) and hca_feat_s, the host
    seconds of the features."""
    comm_id = np.zeros((2, n), np.int32)
    n_comms = np.zeros(2, np.int32)
    for layer, edges in enumerate((edges0, edges1)):
        comm_id[layer], n_comms[layer] = louvain_labels(n, edges, seed=seed, stats=stats)
    if n == 0:
        return comm_id, n_comms, np.zeros((0, 3), np.float32)
    t0 = time.perf_counter()
    sizes = [np.bincount(comm_id[layer], minlength=n_comms[layer]).astype(np.int64)
             for layer in range(2)]
    deg = _degrees(n, edges0) + _degrees(n, edges1)
    c0, c1 = comm_id[0].astype(np.int64), comm_id[1].astype(np.int64)
    _, pair, count = np.unique(c0 * int(n_comms[1]) + c1, return_inverse=True,
                               return_counts=True)
    inter = count[pair]
    s0, s1 = sizes[0][c0], sizes[1][c1]
    union = s0 + s1 - inter
    eps = 1e-6
    f_het = 1.0 - inter / (union + eps)
    log0 = np.array([math.log(s + 1) for s in sizes[0]])[c0]
    log1 = np.array([math.log(s + 1) for s in sizes[1]])[c1]
    f_impact = log0 * log1
    f_roi = (f_het * f_impact) / (deg + eps)
    feat = np.stack([f_het, f_impact, f_roi], axis=1).astype(np.float32)
    if stats is not None:
        stats["hca_feat_s"] = time.perf_counter() - t0
    return comm_id, n_comms, feat
