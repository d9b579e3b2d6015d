"""Louvain community detection, step for step as networkx 3.6.1 runs it.

The JAX package takes its community priors (CE) and its HCA communities
from `networkx.community.louvain_communities(G, seed=s)` on graphs built as
`nx.Graph(); add_nodes_from(range(n)); add_edges_from(edges)`: unweighted,
resolution 1, threshold 1e-7.  The port does not import networkx, so this
module repeats that computation and returns the same list of sets in the
same order.  What fixes the result, and is kept here:

  * the adjacency in edge-insertion order (dicts keep insertion order), and
    the order in which each level's graph is rebuilt from the previous one
    (`G.edges()` then `add_edge`), which sets the neighbour iteration order
    and so how ties in the modularity gain break;
  * the node shuffle of each level, `random.Random(seed).shuffle`, one
    generator for all levels (what `py_random_state` makes of an integer);
  * the strict `>` on the gain, the `defaultdict` that adds a node's own
    community to its candidate list when no neighbour shares it;
  * the modularity sums as networkx forms them (integer weights, then one
    Python `sum` of the per-community floats in list order), and the level
    loop's stopping rule `new_mod - mod <= threshold`.

Adapted from networkx/algorithms/community/louvain.py and quality.py
(`louvain_partitions`, `_one_level`, `_neighbor_weights`, `_gen_graph`,
`modularity`), networkx 3.6.1:

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
    EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED TO, THE
    IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A PARTICULAR
    PURPOSE ARE DISCLAIMED.  (The BSD 3-clause licence.)
"""

from __future__ import annotations

import random
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

# a level's graph: adjacency dicts {neighbour: integer weight} in insertion
# order, one per node 0..k-1
Adj = List[Dict[int, int]]


def graph_adjacency(n: int, edges: Sequence) -> Adj:
    """The adjacency of `nx.Graph(); add_nodes_from(range(n));
    add_edges_from(edges)`: each node's neighbours in the order the edges
    first name them (a repeated edge keeps its place; a self loop is its
    own neighbour), every weight 1."""
    adj: Adj = [{} for _ in range(n)]
    for u, v in (edges.tolist() if hasattr(edges, "tolist") else edges):
        u, v = int(u), int(v)
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(f"edge ({u}, {v}) names a node outside range({n})")
        adj[u][v] = 1
        adj[v][u] = 1
    return adj


def degree(adj: Adj, u: int) -> int:
    """networkx's weighted degree: a self loop counts twice."""
    d = adj[u]
    return sum(d.values()) + d.get(u, 0)


def _edges(adj: Adj):
    """`G.edges(data="weight")`: each undirected edge once, from its first
    endpoint in node order, neighbours in adjacency order."""
    for u, nbrs in enumerate(adj):
        for v, w in nbrs.items():
            if v >= u:  # the nodes before u are `seen`
                yield u, v, w


def _rebuild(adj: Adj) -> Adj:
    """The first level's graph: `graph.add_weighted_edges_from(G.edges(
    data=weight, default=1))` on the nodes of G, which reorders each node's
    neighbours (those before it first, in node order)."""
    out: Adj = [{} for _ in range(len(adj))]
    for u, v, w in _edges(adj):
        out[u][v] = w
        out[v][u] = w
    return out


def modularity(adj: Adj, communities: List[Set[int]], resolution=1) -> float:
    """networkx's `modularity(G, communities, weight="weight")` for an
    undirected graph with integer weights."""
    deg = [degree(adj, u) for u in range(len(adj))]
    deg_sum = sum(deg)
    m = deg_sum / 2
    norm = 1 / deg_sum**2

    def community_contribution(comm):
        twice = 0
        loops = 0
        for u in comm:
            for v, w in adj[u].items():
                if v == u:
                    loops += w
                elif v in comm:
                    twice += w
        L_c = twice // 2 + loops
        out_degree_sum = sum(deg[u] for u in comm)
        return L_c / m - resolution * out_degree_sum * out_degree_sum * norm

    return sum(map(community_contribution, communities))


def _one_level(adj: Adj, members: Optional[List[Set[int]]], m, partition, resolution, rng,
               tally: List[int]):
    """One pass of local moves (networkx's `_one_level`, undirected); adds
    the pass and its node moves to tally [passes, moves]."""
    k = len(adj)
    node2com = list(range(k))
    inner_partition = [{u} for u in range(k)]
    degrees = [degree(adj, u) for u in range(k)]
    Stot = list(degrees)
    nbrs = [{v: w for v, w in adj[u].items() if v != u} for u in range(k)]
    rand_nodes = list(range(k))
    rng.shuffle(rand_nodes)
    two_m2 = 2 * m**2  # networkx writes it out in each expression: the same value
    nb_moves = 1
    improvement = False
    while nb_moves > 0:
        nb_moves = 0
        for u in rand_nodes:
            best_mod = 0
            best_com = node2com[u]
            weights2com = defaultdict(float)
            for nbr, wt in nbrs[u].items():
                weights2com[node2com[nbr]] += wt
            degree_u = degrees[u]
            Stot[best_com] -= degree_u
            remove_cost = -weights2com[best_com] / m + resolution * (
                Stot[best_com] * degree_u
            ) / two_m2
            for nbr_com, wt in weights2com.items():
                gain = remove_cost + wt / m - resolution * (Stot[nbr_com] * degree_u) / two_m2
                if gain > best_mod:
                    best_mod = gain
                    best_com = nbr_com
            Stot[best_com] += degree_u
            if best_com != node2com[u]:
                com = {u} if members is None else members[u]
                partition[node2com[u]].difference_update(com)
                inner_partition[node2com[u]].remove(u)
                partition[best_com].update(com)
                inner_partition[best_com].add(u)
                improvement = True
                nb_moves += 1
                node2com[u] = best_com
        tally[1] += nb_moves
    tally[0] += 1
    partition = list(filter(len, partition))
    inner_partition = list(filter(len, inner_partition))
    return partition, inner_partition, improvement


def _gen_graph(adj: Adj, members: Optional[List[Set[int]]], partition: List[Set[int]]):
    """The next level's graph (networkx's `_gen_graph`): a node per
    community, edge weights summed (a community's inner edges become its
    self loop), in the order G.edges() meets them.  Returns (adjacency,
    each new node's original members)."""
    node2com = {}
    new_members = []
    for i, part in enumerate(partition):
        nodes = set()
        for node in part:
            node2com[node] = i
            nodes.update({node} if members is None else members[node])
        new_members.append(nodes)
    out: Adj = [{} for _ in partition]
    for u, v, w in _edges(adj):
        c1, c2 = node2com[u], node2com[v]
        w = w + out[c1].get(c2, 0)
        out[c1][c2] = w
        out[c2][c1] = w
    return out, new_members


def _louvain_python(n: int, edges, rng: random.Random, resolution, threshold: float,
                    tally: List[int]) -> List[Set[int]]:
    g = graph_adjacency(n, edges)
    partition = [{u} for u in range(n)]
    if not any(g):  # nx.is_empty: no edges
        return partition
    mod = modularity(g, partition, resolution)
    adj, members = _rebuild(g), None
    m = sum(degree(adj, u) for u in range(n)) / 2
    partition, inner, improvement = _one_level(adj, members, m, partition, resolution, rng,
                                               tally)
    improvement = True
    last = partition
    while improvement:
        last = [s.copy() for s in partition]
        new_mod = modularity(adj, inner, resolution)
        if new_mod - mod <= threshold:
            break
        mod = new_mod
        adj, members = _gen_graph(adj, members, inner)
        partition, inner, improvement = _one_level(adj, members, m, partition, resolution,
                                                   rng, tally)
    return last


def _shuffled(rng: random.Random, k: int) -> np.ndarray:
    order = list(range(k))
    rng.shuffle(order)
    return np.asarray(order, np.int64)


def _louvain_native(lib, n: int, e: np.ndarray, rng: random.Random, resolution,
                    threshold: float, tally: List[int]) -> Tuple[np.ndarray, int]:
    from mdcommunity_tpu_torch.native import _ptr

    h = lib.mdc_louvain_create(n, _ptr(e), len(e), float(resolution))
    if not h:
        raise ValueError(f"the native Louvain takes fewer than 2^31 - 1 nodes and edges "
                         f"({n} nodes, {len(e)} edges)")
    try:
        labels = np.empty(n, np.int64)
        if not lib.mdc_louvain_empty(h):
            lib.mdc_louvain_level(h, _ptr(_shuffled(rng, n)))
            while lib.mdc_louvain_next(h, float(threshold)):
                if not lib.mdc_louvain_level(h, _ptr(_shuffled(rng, lib.mdc_louvain_size(h)))):
                    break
        count = int(lib.mdc_louvain_labels(h, _ptr(labels)))
        st = np.zeros(2, np.int64)
        lib.mdc_louvain_stats(h, _ptr(st))
        tally[0] += int(st[0])
        tally[1] += int(st[1])
    finally:
        lib.mdc_louvain_destroy(h)
    return labels, count


def louvain_labels(n: int, edges: Sequence, seed: int = 0, resolution=1,
                   threshold: float = 0.0000001, stats: Optional[dict] = None
                   ) -> Tuple[np.ndarray, int]:
    """Each node's community in `louvain_communities(n, edges, seed)`'s list
    (int64 [n]) and the number of communities.  With `stats`, appends to
    its lists louvain_s (host seconds), louvain_levels (passes of local
    moves) and louvain_moves (node moves, over all passes)."""
    from mdcommunity_tpu_torch import native

    t0 = time.perf_counter()
    rng = random.Random(seed)
    tally = [0, 0]
    lib = native.load()
    if lib is not None:
        e = np.ascontiguousarray(np.asarray(edges, np.int64).reshape(-1, 2))
        bad = (e < 0) | (e >= n)
        if bad.any():
            u, v = e[int(np.argmax(bad.any(axis=1)))]
            raise ValueError(f"edge ({u}, {v}) names a node outside range({n})")
        labels, count = _louvain_native(lib, n, e, rng, resolution, threshold, tally)
    else:
        comms = _louvain_python(n, edges, rng, resolution, threshold, tally)
        labels = np.empty(n, np.int64)
        for cid, nodes in enumerate(comms):
            labels[list(nodes)] = cid
        count = len(comms)
    if stats is not None:
        for key, v in (("louvain_s", time.perf_counter() - t0), ("louvain_levels", tally[0]),
                       ("louvain_moves", tally[1])):
            stats.setdefault(key, []).append(v)
    return labels, count


def louvain_communities(
    n: int, edges: Sequence, seed: int = 0, resolution=1, threshold: float = 0.0000001
) -> List[Set[int]]:
    """`networkx.community.louvain_communities(G, seed=seed)` for the graph
    `nx.Graph(); add_nodes_from(range(n)); add_edges_from(edges)`: the
    communities (sets of node ids) of the last level, in networkx's order."""
    labels, count = louvain_labels(n, edges, seed, resolution, threshold)
    if count == 0:
        return []
    order = np.argsort(labels, kind="stable")
    bounds = np.cumsum(np.bincount(labels, minlength=count))[:-1]
    return [set(part.tolist()) for part in np.split(order, bounds)]
