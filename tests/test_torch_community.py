"""The port's Louvain, CE prior and HCA structure against the JAX package,
exactly: graphs/louvain.py gives networkx's louvain_communities (reached
through the JAX package's louvain_partition and hca_communities_and_features)
the same list of sets in the same order, and the features derived from it
are the JAX package's bits.

As a script it compares the two at the size of chip_smoke.py's graph
(about a minute on one CPU core, so not a test):

    PYTHONPATH=.:tests python tests/test_torch_community.py --n 18222
"""

import argparse
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.graphs import community as jax_community  # noqa: E402
from mdcommunity_tpu.graphs import hca as jax_hca  # noqa: E402
from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.graphs import community, hca  # noqa: E402
from mdcommunity_tpu_torch.graphs.louvain import louvain_communities  # noqa: E402


def _nx_communities(n, edges, seed):
    """networkx's list of sets, through the JAX package's partition dict."""
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(edges)
    part = jax_community.louvain_partition(G, seed=seed)
    comms = [set() for _ in range(max(part.values()) + 1)]
    for v, c in part.items():
        comms[c].add(v)
    return comms


def _cases():
    """GMM duplexes of 30-50, 180 and 2,000 nodes, several draws."""
    out = []
    for n, draws in ((30, 3), (37, 2), (50, 2), (180, 3), (2000, 2)):
        for s in range(draws):
            out.append((n, s))
    return out


@pytest.mark.parametrize("n,draw", _cases())
def test_louvain_equals_networkx(n, draw):
    """Both layers at seeds 0 and 5: the same communities in the same order."""
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(1000 * n + draw))
    for edges in (e0, e1):
        for seed in (0, 5):
            assert louvain_communities(n, edges, seed=seed) == _nx_communities(n, edges, seed)


def test_louvain_edge_cases():
    """An isolated node, a repeated edge and a self loop, and an empty
    layer (every node its own community, in node order)."""
    e = np.array([[0, 1], [1, 2], [2, 0], [3, 4], [1, 0], [4, 4], [5, 6], [6, 3]])
    for n in (7, 9):  # 9: nodes 7 and 8 isolated
        for seed in (0, 1, 2):
            assert louvain_communities(n, e, seed) == _nx_communities(n, e, seed)
    assert louvain_communities(5, np.zeros((0, 2), np.int64)) == [{u} for u in range(5)]
    assert louvain_communities(5, np.zeros((0, 2), np.int64)) == _nx_communities(
        5, np.zeros((0, 2), np.int64), 0)
    with pytest.raises(ValueError, match="outside"):
        louvain_communities(3, np.array([[0, 3]]))


@pytest.mark.parametrize("feature", ["boundary", "participation"])
def test_duplex_prior_equals_jax(feature):
    """The CE prior [2, n] and the union boundary mask, bit for bit, on two
    GMM duplexes (one with an empty layer) and one with isolated nodes."""
    for n, seed, empty in ((45, 0, False), (180, 1, True), (300, 2, False)):
        e0, e1 = gmm_duplex_edges(n, np.random.default_rng(seed))
        if empty:
            e1 = np.zeros((0, 2), np.int64)
        f, b = community.duplex_prior(n, e0, e1, feature)
        jf, jb = jax_community.duplex_prior(n, e0, e1, feature)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(b, jb)
        assert f.dtype == np.float32 and b.dtype == bool


def test_prior_cache_is_shared_with_jax(tmp_path):
    """A cache file written by either package is read by the other: the
    same name, keys and values."""
    n = 120
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(4))
    f, b = community.cached_duplex_prior(str(tmp_path / "a"), "g", n, e0, e1)
    assert os.path.isfile(tmp_path / "a" / "comm_prior_g_boundary.npz")
    jf, jb = jax_community.cached_duplex_prior(str(tmp_path / "a"), "g", n,
                                               np.zeros((0, 2)), np.zeros((0, 2)))
    np.testing.assert_array_equal(jf, f)  # read, not recomputed from the empty edges
    np.testing.assert_array_equal(jb, b)
    jf, jb = jax_community.cached_duplex_prior(str(tmp_path / "b"), "g", n, e0, e1,
                                               "participation")
    f, b = community.cached_duplex_prior(str(tmp_path / "b"), "g", n, np.zeros((0, 2)),
                                         np.zeros((0, 2)), "participation")
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("n,seed", [(40, 0), (180, 11), (2000, 3)])
def test_hca_structure_equals_jax(n, seed):
    """comm_id and n_comms exactly, hca_feat bit for bit (f32 of the same
    f64 values)."""
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(seed))
    got = hca.hca_communities_and_features(n, e0, e1)
    ref = jax_hca.hca_communities_and_features(n, e0, e1)
    for x, y in zip(got, ref):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_hca_structure_with_an_empty_layer():
    n = 60
    e0, _ = gmm_duplex_edges(n, np.random.default_rng(8))
    e1 = np.zeros((0, 2), np.int64)
    for x, y in zip(hca.hca_communities_and_features(n, e0, e1),
                    jax_hca.hca_communities_and_features(n, e0, e1)):
        np.testing.assert_array_equal(x, y)


def compare_at(n, seed=0):
    """Both layers' partitions, the CE prior ("boundary") and the HCA
    structure of synth_duplex_edges(n, 6, default_rng(seed)) (chip_smoke's
    graph at n = 18,222), the port's against the JAX package's: whether
    each is equal, the community counts and each side's seconds."""
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(seed))
    res = dict(n=n, seed=seed)
    for name, port, ref in (
        ("partitions", lambda: [louvain_communities(n, e, 0) for e in (e0, e1)],
         lambda: [_nx_communities(n, e, 0) for e in (e0, e1)]),
        ("prior", lambda: community.duplex_prior(n, e0, e1, "boundary"),
         lambda: jax_community.duplex_prior(n, e0, e1, "boundary")),
        ("hca", lambda: hca.hca_communities_and_features(n, e0, e1),
         lambda: jax_hca.hca_communities_and_features(n, e0, e1)),
    ):
        t0 = time.perf_counter()
        got = port()
        t1 = time.perf_counter()
        want = ref()
        t2 = time.perf_counter()
        if name == "partitions":
            equal = got == want
            res["n_communities"] = [len(c) for c in got]
        else:
            equal = all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(got, want))
        res[name] = dict(equal=bool(equal), port_s=t1 - t0, jax_s=t2 - t1)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18222)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    out = compare_at(args.n, args.seed)
    print(json.dumps(out))
    if not all(out[k]["equal"] for k in ("partitions", "prior", "hca")):
        raise SystemExit("the port's structure differs from the JAX package's")
