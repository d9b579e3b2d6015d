"""Plain reference of the hca configuration's inputs (the reference's
HCA-Dismantler, mvc_env.calculate_hca_features :39-136): static node
features from each layer's communities on the intact graph, shared by both
layers, and every removal costing 1/n.

  f_het(u)    = 1 - |C0(u) ∩ C1(u)| / (|C0(u) ∪ C1(u)| + 1e-6)
  f_impact(u) = log(|C0(u)| + 1) · log(|C1(u)| + 1)
  f_roi(u)    = f_het · f_impact / (deg0(u) + deg1(u) + 1e-6)

deg_l is the intact layer's degree over its distinct pairs.  Formed in
float64 (the program rounds them to float32 once)."""

import numpy as np


def hca_features(n: int, edges, labels: np.ndarray) -> np.ndarray:
    """edges: per layer [M, 2] original ids; labels [2, n] each node's
    community a layer -> [n, 3] (f_het, f_impact, f_roi)."""
    c0, c1 = (np.asarray(labels[layer], np.int64) for layer in range(2))
    s0 = np.bincount(c0)[c0].astype(np.float64)
    s1 = np.bincount(c1)[c1].astype(np.float64)
    pair = c0 * (int(c1.max()) + 1) + c1
    _, inv, cnt = np.unique(pair, return_inverse=True, return_counts=True)
    inter = cnt[inv].astype(np.float64)
    deg = np.zeros(n, np.float64)
    for e in edges:
        e = np.asarray(e, np.int64).reshape(-1, 2)
        keys = np.unique(e.min(1) * n + e.max(1))
        deg += np.bincount(keys // n, minlength=n) + np.bincount(keys % n, minlength=n)
    f_het = 1.0 - inter / (s0 + s1 - inter + 1e-6)
    f_impact = np.log(s0 + 1.0) * np.log(s1 + 1.0)
    return np.stack([f_het, f_impact, f_het * f_impact / (deg + 1e-6)], axis=1)


def action_cost(acts: np.ndarray, weights, n: int) -> np.ndarray:
    return np.full(len(acts), 1.0 / n)
