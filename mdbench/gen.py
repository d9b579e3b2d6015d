"""Inputs of a run, made from --seed: the duplex's edges and its node costs.

Frozen copies, so that a change to the program cannot change the traffic:

* `synth_duplex_edges` is mdcommunity_tpu_torch/large_graph_demo.py's
  generator (circular power-law offsets per layer, ids shuffled or kept in
  angular order), line for line;
* `degree_weights` is mdcommunity_tpu_torch/graphs/gmm.py's
  `_degree_weights` (deg/maxdeg on the intact layer, the reference's
  MultiDismantler_degree_cost/graph.py:39-51).
"""

from __future__ import annotations

import numpy as np


def synth_duplex_edges(n, avg_deg, rng, shuffle=True):
    """Locality-ordered duplex surrogate: circular power-law offsets per
    layer.  shuffle=True permutes the ids so the pipeline's reordering does
    real work; shuffle=False keeps the generator's angular order (a
    well-banded build)."""
    perm = rng.permutation(n) if shuffle else np.arange(n)
    layers = []
    for _ in range(2):
        e = n * avg_deg // 2
        src = rng.integers(0, n, e)
        off = (8.0 * (rng.pareto(2.5, e) + 1.0)).astype(np.int64)
        off = np.minimum(off, n // 2 - 1) * rng.choice(np.array([-1, 1]), e)
        dst = (src + off) % n
        keep = src != dst
        layers.append(np.stack([perm[src[keep]], perm[dst[keep]]], 1))
    return layers


def degree_weights(n: int, e0: np.ndarray, e1: np.ndarray) -> np.ndarray:
    """Per-layer node costs = deg/maxdeg on the intact layer."""
    w = np.zeros((2, n), np.float32)
    for l, e in enumerate((e0, e1)):
        deg = np.zeros(n, np.float32)
        if len(e):
            np.add.at(deg, e[:, 0], 1.0)
            np.add.at(deg, e[:, 1], 1.0)
        mx = deg.max() if deg.max() > 0 else 1.0
        w[l] = deg / mx
    return w


def make_inputs(traffic: dict, config: dict, seed: int, n: int):
    """(edges per layer in original ids, node costs [2, n] or None) of one
    run, and the configuration's node costs ("node_cost": "degree" or
    "unit").

    Every seed gets the same graph, drawn in angular order from the
    traffic's `graph_seed`, under other ids: a permutation drawn from
    `seed` where the traffic shuffles, else a rotation by an offset drawn
    from `seed` (which keeps the angular order, so the build stays
    spill-free).  The work a run does is then the same for every seed (a
    graph of another seed collapses at another pace, and the rate over a
    fixed window with it), while the ids, the build's order and every
    check's samples change with it."""
    e0, e1 = synth_duplex_edges(n, traffic["avg_deg"],
                                np.random.default_rng(traffic["graph_seed"]), shuffle=False)
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n) if traffic["shuffle"] else (np.arange(n) + rng.integers(n)) % n
    e0, e1 = ids[e0], ids[e1]
    w = degree_weights(n, e0, e1) if config["node_cost"] == "degree" else None
    return (e0, e1), w
