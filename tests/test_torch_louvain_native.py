"""The native Louvain (native/src/mdc_louvain.cpp, through
graphs/louvain.louvain_labels) against the port's Python levels and
networkx 3.6.1's louvain_communities: the same communities in the same
order on the benchmark's generator (2^10–2^14 nodes, several graph seeds
and id rotations), the CE and HCA fixture graphs, and graphs with isolated
nodes, repeated edges and self loops.  Then the vectorised
hca_communities_and_features against the per-node loop it replaced, bit
for bit."""

import math
import random

import networkx as nx
import numpy as np
import pytest

from mdbench.gen import synth_duplex_edges
from mdcommunity_tpu_torch import native
from mdcommunity_tpu_torch.graphs import hca, louvain
from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    if native.load() is None:
        pytest.fail("the native library does not build here")


def _nx(n, edges, seed):
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(np.asarray(edges).tolist())
    return nx.community.louvain_communities(G, seed=seed)


def _python(n, edges, seed):
    return louvain._louvain_python(n, edges, random.Random(seed), 1, 1e-7, [0, 0])


def _generator(n, graph_seed, rotation):
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(graph_seed), shuffle=False)
    return [(e + rotation) % n for e in (e0, e1)]


@pytest.mark.parametrize("n,graph_seed,rotation", [
    (1 << 10, 1, 0), (1 << 10, 2, 517), (1 << 12, 3, 0), (1 << 12, 4, 1234),
])
def test_generator_equals_python_and_networkx(n, graph_seed, rotation):
    for edges in _generator(n, graph_seed, rotation):
        for seed in (0, 7):
            got = louvain.louvain_communities(n, edges, seed=seed)
            assert got == _python(n, edges, seed)
            assert got == _nx(n, edges, seed)


def test_generator_2_14_equals_networkx():
    n = 1 << 14
    edges = _generator(n, 20260518, 9001)[0]
    assert louvain.louvain_communities(n, edges, seed=0) == _nx(n, edges, 0)


def _fixtures():
    hca_graph = gmm_duplex_edges(180, np.random.default_rng(11))     # tests/test_torch_hca.py
    ce_graph = synth_duplex_edges(400, 6, np.random.default_rng(3))   # tests/variant_cases.py
    return [(180, e) for e in hca_graph] + [(400, e) for e in ce_graph]


@pytest.mark.parametrize("case", range(4))
def test_fixture_graphs(case):
    n, edges = _fixtures()[case]
    for seed in (0, 5):
        got = louvain.louvain_communities(n, edges, seed=seed)
        assert got == _python(n, edges, seed) == _nx(n, edges, seed)


def test_isolated_nodes_repeated_edges_self_loops():
    rng = np.random.default_rng(17)
    n = 300
    e = rng.integers(0, 250, size=(700, 2))        # nodes 250..299 isolated
    e = np.concatenate([e, e[:100], e[50:150, ::-1], np.stack([np.arange(20)] * 2, 1)])
    rng.shuffle(e)
    for seed in (0, 3, 11):
        got = louvain.louvain_communities(n, e, seed=seed)
        assert got == _python(n, e, seed) == _nx(n, e, seed)
    assert louvain.louvain_communities(4, np.zeros((0, 2), np.int64)) == [{0}, {1}, {2}, {3}]
    assert louvain.louvain_communities(0, np.zeros((0, 2), np.int64)) == []
    with pytest.raises(ValueError):
        louvain.louvain_labels(3, np.array([[0, 3]]))


def test_labels_and_stats_on_both_routes(monkeypatch):
    n = 1 << 10
    edges = _generator(n, 5, 0)[1]
    st_native, st_python = {}, {}
    lab, count = louvain.louvain_labels(n, edges, seed=2, stats=st_native)
    monkeypatch.setattr(native, "load", lambda: None)
    lab_py, count_py = louvain.louvain_labels(n, edges, seed=2, stats=st_python)
    np.testing.assert_array_equal(lab, lab_py)
    assert count == count_py == len(set(lab.tolist()))
    for st in (st_native, st_python):
        assert set(st) == {"louvain_s", "louvain_levels", "louvain_moves"}
    assert st_native["louvain_levels"] == st_python["louvain_levels"]
    assert st_native["louvain_moves"] == st_python["louvain_moves"]
    assert st_native["louvain_moves"][0] > 0


def _loop_structure(n, edges0, edges1, seed=0):
    """hca_communities_and_features as it was written before: degrees from
    graph_adjacency node by node, comm_id by set."""
    comm_id = np.zeros((2, n), np.int32)
    n_comms = np.zeros(2, np.int32)
    sizes, deg = [], np.zeros(n, np.int64)
    for layer, edges in enumerate((edges0, edges1)):
        comms = louvain.louvain_communities(n, edges, seed=seed)
        n_comms[layer] = len(comms)
        for cid, nodes in enumerate(comms):
            comm_id[layer, list(nodes)] = cid
        sizes.append(np.array([len(c) for c in comms], np.int64))
        adj = louvain.graph_adjacency(n, edges)
        deg += np.array([louvain.degree(adj, u) for u in range(n)], np.int64)
    c0, c1 = comm_id[0].astype(np.int64), comm_id[1].astype(np.int64)
    _, pair, count = np.unique(c0 * int(n_comms[1]) + c1, return_inverse=True,
                               return_counts=True)
    inter = count[pair]
    union = sizes[0][c0] + sizes[1][c1] - inter
    f_het = 1.0 - inter / (union + 1e-6)
    f_impact = (np.array([math.log(s + 1) for s in sizes[0]])[c0]
                * np.array([math.log(s + 1) for s in sizes[1]])[c1])
    f_roi = (f_het * f_impact) / (deg + 1e-6)
    return comm_id, n_comms, np.stack([f_het, f_impact, f_roi], axis=1).astype(np.float32)


@pytest.mark.parametrize("case", ["generator", "hca_fixture", "ce_fixture", "loops"])
def test_vectorised_structure_equals_the_loop(case):
    if case == "generator":
        n, (e0, e1) = 1 << 12, _generator(1 << 12, 6, 333)
    elif case == "hca_fixture":
        n, (e0, e1) = 180, gmm_duplex_edges(180, np.random.default_rng(11))
    elif case == "ce_fixture":
        n, (e0, e1) = 400, synth_duplex_edges(400, 6, np.random.default_rng(3))
    else:
        n = 200
        rng = np.random.default_rng(4)
        e0 = np.concatenate([rng.integers(0, 180, (500, 2)), [[5, 5], [7, 7], [5, 5]]])
        e1 = np.concatenate([rng.integers(0, 190, (400, 2)), rng.integers(0, 190, (50, 2))])
    stats = {}
    got = hca.hca_communities_and_features(n, e0, e1, stats=stats)
    want = _loop_structure(n, e0, e1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(stats["louvain_s"]) == 2 and stats["hca_feat_s"] >= 0.0
