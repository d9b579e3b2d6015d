"""Betweenness, closeness and PageRank, step for step as networkx 3.6.1 runs them.

The JAX package's adaptive baselines (eval/baselines.py) score each live
subgraph with `nx.betweenness_centrality(G)`, `nx.closeness_centrality(G)`
and `nx.pagerank(G)` on a graph built as `nx.Graph(); add_nodes_from(nodes);
add_edges_from(edges)`.  The port does not import networkx, so this module
repeats those computations and returns the same floats bit for bit: one ulp
changes which tied node `argmax` takes, and the dismantling order then
parts.  What fixes the bits, and is kept here:

  * the adjacency as networkx stores it (`adjacency`): nodes in the order
    given, each node's neighbours in the order in which their undirected
    edge first appears (an edge seen again keeps its place);
  * betweenness: Brandes' BFS (`_single_source_shortest_path_basic`), the
    dependency accumulation over the stack in reverse (`_accumulate_basic`,
    predecessors in discovery order), then `_rescale` with normalized=True,
    endpoints=False (one multiply by 1 / ((n - 1)(n - 2)));
  * closeness: BFS path lengths (`_single_shortest_path_length`), summed as
    integers, and wf_improved=True;
  * PageRank: `_pagerank_scipy` with alpha=0.85, tol=1e-6, max_iter=100, on
    the same scipy CSR matrix `to_scipy_sparse_array` builds (edges as
    `G.edges()` reports them, symmetrised, self loops counted once), the
    dangling mass summed by Python's `sum` as networkx sums it.

Adapted from networkx/algorithms/centrality/betweenness.py, closeness.py,
shortest_paths/unweighted.py, link_analysis/pagerank_alg.py and
convert_matrix.py, networkx 3.6.1:

    Copyright (C) 2004-2025, NetworkX Developers
    Aric Hagberg <hagberg@lanl.gov>, Dan Schult <dschult@colgate.edu>,
    Pieter Swart <swart@lanl.gov>.  All rights reserved.

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met: redistributions of source code must retain the above copyright
    notice, this list of conditions and the following disclaimer;
    redistributions in binary form must reproduce the above copyright
    notice, this list of conditions and the following disclaimer in the
    documentation and/or other materials provided with the distribution;
    neither the name of the NetworkX Developers nor the names of its
    contributors may be used to endorse or promote products derived from
    this software without specific prior written permission.  THIS SOFTWARE
    IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS IS" AND ANY
    EXPRESS OR IMPLIED WARRANTIES ARE DISCLAIMED (BSD-3-Clause).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Tuple

import numpy as np

Adjacency = Dict[int, Dict[int, int]]


def adjacency(nodes: Iterable[int], edges: Iterable[Tuple[int, int]]) -> Adjacency:
    """An undirected graph as networkx's `Graph` stores it: `add_nodes_from(
    nodes)`, then `add_edges_from(edges)`.  A node an edge names that is not
    in `nodes` is added after them, as networkx adds it."""
    adj: Adjacency = {v: {} for v in nodes}
    for u, v in edges:
        adj.setdefault(u, {})
        adj.setdefault(v, {})
        adj[u][v] = 1
        adj[v][u] = 1
    return adj


def _shortest_paths(adj: Adjacency, s: int):
    S: List[int] = []
    P: Dict[int, List[int]] = {v: [] for v in adj}
    sigma = dict.fromkeys(adj, 0.0)
    D = {s: 0}
    sigma[s] = 1.0
    Q = deque([s])
    while Q:
        v = Q.popleft()
        S.append(v)
        Dv = D[v]
        sigmav = sigma[v]
        for w in adj[v]:
            if w not in D:
                Q.append(w)
                D[w] = Dv + 1
            if D[w] == Dv + 1:
                sigma[w] += sigmav
                P[w].append(v)
    return S, P, sigma


def betweenness_centrality(adj: Adjacency) -> Dict[int, float]:
    """`nx.betweenness_centrality(G)`: normalised, endpoints excluded."""
    betweenness = dict.fromkeys(adj, 0.0)
    for s in adj:
        S, P, sigma = _shortest_paths(adj, s)
        delta = dict.fromkeys(S, 0)
        while S:
            w = S.pop()
            coeff = (1 + delta[w]) / sigma[w]
            for v in P[w]:
                delta[v] += sigma[v] * coeff
            if w != s:
                betweenness[w] += delta[w]
    N = len(adj) - 1
    if N < 2:
        return betweenness
    scale = 1 / (N * (N - 1))
    if scale != 1:
        for v in betweenness:
            betweenness[v] *= scale
    return betweenness


def _path_lengths(adj: Adjacency, source: int) -> Dict[int, int]:
    seen = {source}
    nextlevel = [source]
    out = {source: 0}
    level = 0
    n = len(adj)
    while nextlevel:
        level += 1
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
                    out[w] = level
            if len(seen) == n:
                return out
    return out


def closeness_centrality(adj: Adjacency) -> Dict[int, float]:
    """`nx.closeness_centrality(G)`: wf_improved=True."""
    out = {}
    len_G = len(adj)
    for n in adj:
        sp = _path_lengths(adj, n)
        totsp = sum(sp.values())
        c = 0.0
        if totsp > 0.0 and len_G > 1:
            c = (len(sp) - 1.0) / totsp
            c *= (len(sp) - 1.0) / (len_G - 1)
        out[n] = c
    return out


def _adjacency_matrix(adj: Adjacency, nodelist: List[int]):
    """`nx.to_scipy_sparse_array(G, nodelist, weight="weight", dtype=float)`
    of an unweighted undirected graph (CSR)."""
    import scipy as sp

    index = dict(zip(nodelist, range(len(nodelist))))
    row, col, selfloops = [], [], []
    seen = set()
    for u in nodelist:
        for v in adj[u]:
            if v not in seen:
                row.append(index[u])
                col.append(index[v])
                if u == v:
                    selfloops.append(index[u])
        seen.add(u)
    data = [1] * len(row)
    d = data + data + [-1] * len(selfloops)
    r = row + col + selfloops
    c = col + row + selfloops
    n = len(nodelist)
    return sp.sparse.coo_array((d, (r, c)), shape=(n, n), dtype=float).asformat("csr")


def pagerank(adj: Adjacency, alpha: float = 0.85, max_iter: int = 100,
             tol: float = 1.0e-6) -> Dict[int, float]:
    """`nx.pagerank(G)` (`_pagerank_scipy`), uniform personalisation and
    dangling weights."""
    import scipy as sp

    N = len(adj)
    if N == 0:
        return {}
    nodelist = list(adj)
    A = _adjacency_matrix(adj, nodelist)
    S = A.sum(axis=1)
    S[S != 0] = 1.0 / S[S != 0]
    Q = sp.sparse.dia_array((S.T, 0), shape=A.shape).tocsr()
    A = Q @ A
    x = np.repeat(1.0 / N, N)
    p = np.repeat(1.0 / N, N)
    dangling_weights = p
    is_dangling = np.where(S == 0)[0]
    for _ in range(max_iter):
        xlast = x
        x = alpha * (x @ A + sum(x[is_dangling]) * dangling_weights) + (1 - alpha) * p
        err = np.absolute(x - xlast).sum()
        if err < N * tol:
            return dict(zip(nodelist, map(float, x)))
    raise RuntimeError(f"PageRank's power iteration failed to converge within "
                       f"{max_iter} iterations (networkx raises "
                       f"PowerIterationFailedConvergence)")


CENTRALITIES = {
    "betweenness": betweenness_centrality,
    "closeness": closeness_centrality,
    "pagerank": pagerank,
}
