"""The heuristic baselines of the port against the JAX package and networkx:
the port's betweenness, closeness and PageRank (graphs/centrality.py) equal
networkx 3.6.1's bit for bit on live subgraphs, the degree and CI scores
equal the JAX package's, and heuristic_dismantle gives the JAX package's
solutions, scores and curves exactly, for every method and combine, with
protection (a degree tie at the cut) and with the `_syn` stop; hxa and the
golden heuristic rows too."""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
nx = pytest.importorskip("networkx")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.eval import baselines as jb  # noqa: E402
from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges  # noqa: E402
from mdcommunity_tpu.graphs.io import duplex_from_layers as jax_duplex  # noqa: E402
from mdcommunity_tpu_torch.eval import baselines as tb  # noqa: E402
from mdcommunity_tpu_torch.graphs import centrality  # noqa: E402
from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges as port_gmm  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "results_tpu", "golden_synthetic", "golden.json")


def _graph(n, seed, isolated=False, empty_layer=False):
    rng = np.random.default_rng(seed)
    e0, e1 = gmm_duplex_edges(n, rng)
    if isolated:  # node n - 1 loses every edge of both layers
        e0, e1 = (e[(e != n - 1).all(axis=1)] for e in (e0, e1))
    if empty_layer:
        e1 = np.zeros((0, 2), np.int64)
    return e0, e1


def _masks(g, seed, cover=0.2, sever=0.1):
    rng = np.random.default_rng(seed)
    covered = np.zeros(g.pad_n, bool)
    n = int(g.n_nodes)
    covered[:n] = rng.random(n) < cover
    covered[n:] = True
    sev = (rng.random(np.asarray(g.edge_mask).shape) < sever) & np.asarray(g.edge_mask)
    return covered, sev


CASES = [(30, 0, False, False), (100, 1, True, False), (300, 2, False, False),
         (60, 3, True, True)]


@pytest.mark.parametrize("n,seed,isolated,empty_layer", CASES)
@pytest.mark.parametrize("kind", ["betweenness", "closeness", "pagerank"])
def test_centrality_equals_networkx(n, seed, isolated, empty_layer, kind):
    """On each layer's live subgraph, built as the JAX package builds it,
    the port's scores equal networkx's to the bit, node for node."""
    e0, e1 = _graph(n, seed, isolated, empty_layer)
    g = jax_duplex(n, e0, e1)
    covered, sev = _masks(g, seed)
    src, dst, em = (np.asarray(x) for x in (g.src, g.dst, g.edge_mask))
    live = em & ~sev & ~covered[src] & ~covered[dst]
    nodes = [v for v in range(n) if not covered[v]]
    fn = {"betweenness": nx.betweenness_centrality, "closeness": nx.closeness_centrality,
          "pagerank": nx.pagerank}[kind]
    for l in range(2):
        edges = list(zip(src[l][live[l]].tolist(), dst[l][live[l]].tolist()))
        G = nx.Graph()
        G.add_nodes_from(nodes)
        G.add_edges_from(edges)
        want = fn(G)
        got = centrality.CENTRALITIES[kind](centrality.adjacency(nodes, edges))
        assert list(got) == list(want)
        bad = [v for v in want if got[v] != want[v]]
        assert not bad, (kind, l, bad[:5], [(got[v], want[v]) for v in bad[:5]])
    # through the baselines' own wrappers
    tg = duplex_from_layers(n, e0, e1, device="cpu")
    assert np.array_equal(jb._nx_centrality(g, covered, sev, kind),
                          tb._centrality(tg, covered, sev, kind))


def test_centrality_adjacency_order_and_self_loop():
    """Neighbours in the order in which each undirected edge first appears,
    a repeated edge keeping its place; a self loop counts once in PageRank's
    matrix, as to_scipy_sparse_array counts it."""
    nodes = [0, 1, 2, 3, 4]
    edges = [(3, 1), (1, 0), (0, 3), (1, 3), (2, 2), (4, 2), (0, 1)]
    G = nx.Graph()
    G.add_nodes_from(nodes)
    G.add_edges_from(edges)
    adj = centrality.adjacency(nodes, edges)
    assert {v: list(adj[v]) for v in adj} == {v: list(G.adj[v]) for v in G}
    for kind, fn in (("betweenness", nx.betweenness_centrality),
                     ("closeness", nx.closeness_centrality), ("pagerank", nx.pagerank)):
        assert centrality.CENTRALITIES[kind](adj) == fn(G), kind


@pytest.mark.parametrize("n,seed", [(40, 5), (120, 6)])
def test_live_degrees_and_ci_equal(n, seed):
    e0, e1 = _graph(n, seed, isolated=True)
    g = jax_duplex(n, e0, e1)
    tg = duplex_from_layers(n, e0, e1, device="cpu")
    covered, sev = _masks(g, seed)
    tc, ts = torch.from_numpy(covered), torch.from_numpy(sev)
    deg = tb._live_degrees(tg, tc, ts)
    assert deg.dtype == torch.float64
    assert np.array_equal(deg.numpy(), jb._live_degrees(g, covered, sev))
    assert np.array_equal(tb._ci_scores(tg, tc, ts).numpy(), jb._ci_scores(g, covered, sev))


def _tie_frac(n, e0, e1, combine):
    """A protect_frac whose cut falls inside a run of equal initial degrees."""
    deg = np.zeros((2, n))
    for l, e in enumerate((e0, e1)):
        u = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
        np.add.at(deg[l], u[:, 0], 1)
        np.add.at(deg[l], u[:, 1], 1)
    comb = deg.max(0) if combine == "max2" else deg.sum(0)
    ranked = comb[np.argsort(-comb)]
    k = next(k for k in range(1, n) if ranked[k - 1] == ranked[k])
    frac = (k + 0.5) / n
    assert max(1, int(frac * n)) == k
    return frac


@pytest.mark.parametrize("method", list(jb.METHODS))
@pytest.mark.parametrize("combine", list(jb.COMBINES))
def test_heuristic_dismantle_equals_jax(method, combine):
    """Solutions, scores and curves identical to the JAX package's, plain,
    with the `_syn` stop, and with protection cut inside a degree tie."""
    n = 48
    e0, e1 = _graph(n, 11)
    g = jax_duplex(n, e0, e1)
    tg = duplex_from_layers(n, e0, e1, device="cpu")
    frac = _tie_frac(n, e0, e1, combine)
    for kw in (dict(), dict(syn_stop=True), dict(protect_frac=frac)):
        js, jscore, jcurve = jb.heuristic_dismantle(g, method, combine, **kw)
        ts, tscore, tcurve = tb.heuristic_dismantle(tg, method, combine, **kw)
        assert ts == js, kw
        assert tscore == jscore and tcurve == jcurve, kw
        assert len(ts) > 0


def test_hxa_equals_jax():
    n = 40
    e0, e1 = _graph(n, 12)
    g = jax_duplex(n, e0, e1)
    tg = duplex_from_layers(n, e0, e1, device="cpu")
    for name in ("HDA", "HBA", "HCA", "HPRA"):
        assert tb.hxa(tg, name) == jb.hxa(g, name), name


def test_heuristic_dismantle_rejects_unknown_method():
    e0, e1 = _graph(30, 0)
    tg = duplex_from_layers(30, e0, e1, device="cpu")
    with pytest.raises(ValueError, match="method"):
        tb.heuristic_dismantle(tg, "katz")


@pytest.mark.parametrize("method,combine", [("degree", "max2"), ("ci", "max2")])
def test_golden_heuristic_rows(method, combine):
    """The committed golden.json rows (scripts/make_golden_synthetic.py's
    seeds: rng = default_rng(SEED + n) a size, graphs of LMCC 1 skipped)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    for want in golden[f"{method}_{combine}"]:
        n = want["size"]
        rng = np.random.default_rng(golden["seed"] + n)
        scores, costs = [], []
        for _ in range(golden["n_graphs"]):
            e0, e1 = port_gmm(n, rng)
            g = duplex_from_layers(n, e0, e1, device="cpu")
            if int(g.max_rank) <= 1:
                continue
            sol, score, _ = tb.heuristic_dismantle(g, method, combine)
            scores.append(score)
            costs.append(len(sol) / n)
        np.testing.assert_allclose(
            [np.mean(scores), np.std(scores), np.mean(costs)],
            [want["score_mean"], want["score_std"], want["cost_mean"]], rtol=1e-12)
