"""The port's padded duplex containers, GMM generator and graph loaders
against the JAX package's: the same arrays from the same inputs, and pools
equal bit for bit from the same seed, on both of the generator's routes
(numpy pair sampling below 512 nodes, the C++ connector above)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mdcommunity_tpu.native as jax_native  # noqa: E402
from mdcommunity_tpu.graphs import gmm as jax_gmm  # noqa: E402
from mdcommunity_tpu.graphs import io as jax_io  # noqa: E402
from mdcommunity_tpu.graphs.duplex import build_duplex as jax_build  # noqa: E402
import mdcommunity_tpu_torch.native as port_native  # noqa: E402
from mdcommunity_tpu_torch.graphs import gmm  # noqa: E402
from mdcommunity_tpu_torch.graphs import io  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import (  # noqa: E402
    DuplexGraph,
    GraphPool,
    build_duplex,
    index_graphs,
    stack_graphs,
)


def assert_same_graph(jg, tg: DuplexGraph):
    for f in dataclasses.fields(tg):
        ref = np.asarray(getattr(jg, f.name))
        got = getattr(tg, f.name).cpu().numpy()
        assert got.shape == ref.shape, f.name
        np.testing.assert_array_equal(got, ref, err_msg=f.name)


def test_build_duplex_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    # duplicates, reversed pairs and self loops are cleaned the same way
    e0 = rng.integers(0, n, (90, 2))
    e1 = rng.integers(0, n, (70, 2))
    w = rng.random((2, n)).astype(np.float32)
    kw = dict(weights=w, node_feat=rng.random(n).astype(np.float32),
              boundary=rng.random(n) < 0.3)
    assert_same_graph(jax_build(n, e0, e1, 48, 256, **kw),
                      build_duplex(n, e0, e1, 48, 256, device="cpu", **kw))
    g = build_duplex(n, e0, e1, 48, 256, device="cpu")
    # padding edges point at node 0, masked out
    assert not g.edge_mask[:, -1].any() and int(g.src[0, -1]) == int(g.dst[0, -1]) == 0
    np.testing.assert_array_equal(g.degrees().numpy(), np.asarray(jax_build(n, e0, e1, 48, 256).degrees()))


@pytest.mark.parametrize("route", ["numpy", "native"])
def test_gmm_pool_equals_jax(route):
    """generate_pool from the same seed gives the same graphs, max_rank
    included.  Both packages must take the same route, or their streams
    differ: the native route needs both C++ connectors."""
    if route == "native":
        assert jax_native.load() is not None and port_native.load() is not None
        args = (3, 520, 530, 536, 8192)
        assert gmm._NATIVE_CONNECT_MIN_N == jax_gmm._NATIVE_CONNECT_MIN_N == 512
    else:
        args = (12, 30, 50, 64, 1024)
    jp = jax_gmm.generate_pool(np.random.default_rng(7), *args)
    tp = gmm.generate_pool(np.random.default_rng(7), *args, device="cpu")
    assert len(tp) == len(jp) == args[0]
    for jg, tg in zip(jp, tp):
        assert_same_graph(jg, tg)
        assert int(tg.max_rank) > 1


def test_gmm_degree_cost_pool_and_edges_equal_jax():
    jp = jax_gmm.generate_pool(np.random.default_rng(3), 4, 30, 50, 64, 1024, degree_cost=True)
    tp = gmm.generate_pool(np.random.default_rng(3), 4, 30, 50, 64, 1024, degree_cost=True,
                           device="cpu")
    for jg, tg in zip(jp, tp):
        assert_same_graph(jg, tg)
    for kw in (dict(), dict(g=None), dict(kbar1=6.0, kbar2=6.0, gamma1=2.1)):
        je = jax_gmm.gmm_duplex_edges(100, np.random.default_rng(5), **kw)
        te = gmm.gmm_duplex_edges(100, np.random.default_rng(5), **kw)
        for a, b in zip(je, te):
            np.testing.assert_array_equal(a, b)


def test_stack_index_and_pool():
    rng = np.random.default_rng(1)
    graphs = gmm.generate_pool(rng, 5, 30, 50, 64, 1024, device="cpu")
    gb = stack_graphs(graphs)
    assert gb.batched and gb.src.shape == (5, 2, 1024) and gb.pad_n == 64
    sub = index_graphs(gb, [3, 1])
    assert torch.equal(sub.src[0], graphs[3].src) and torch.equal(sub.max_rank[1], graphs[1].max_rank)
    pool = GraphPool()
    for g in graphs:
        pool.insert(g)
    assert len(pool) == 5 and pool.get(2) is graphs[2]
    assert torch.equal(pool.stacked.weights, gb.weights)
    s0 = pool.stacked_s0
    np.testing.assert_array_equal(s0.rank.numpy(), gb.max_rank.numpy())  # the t=0 rank
    assert not s0.covered.any()
    pool.clear()
    with pytest.raises(ValueError):
        pool.stacked


def test_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    n = 30
    a1 = np.triu((rng.random((n, n)) < 0.15).astype(np.int64), 1)
    a2 = np.triu((rng.random((n, n)) < 0.15).astype(np.int64), 1)
    a1, a2 = a1 + a1.T, a2 + a2.T
    np.save(tmp_path / "adj1_0.npy", a1)
    np.save(tmp_path / "adj2_0.npy", a2)
    np.testing.assert_array_equal(io.edges_from_dense_adj(a1), jax_io.edges_from_dense_adj(a1))
    for dc in (False, True):
        assert_same_graph(
            jax_io.load_synthetic_pair(str(tmp_path / "adj1_0.npy"), str(tmp_path / "adj2_0.npy"), dc),
            io.load_synthetic_pair(str(tmp_path / "adj1_0.npy"), str(tmp_path / "adj2_0.npy"), dc,
                                   device="cpu"))
    # a .edges multiplex with three layers; layers 1 and 3 coupled
    lines = []
    for lid in (1, 2, 3):
        for u, v in rng.integers(1, n + 1, (60, 2)):
            lines.append(f"{lid} {u} {v} 1")
    path = tmp_path / "toy.edges"
    path.write_text("\n".join(lines) + "\n")
    for dc in (False, True):
        assert_same_graph(jax_io.load_real_duplex(str(path), n, (1, 3), degree_cost=dc),
                          io.load_real_duplex(str(path), n, (1, 3), degree_cost=dc, device="cpu"))
    e = rng.integers(0, n, (50, 2))
    assert_same_graph(jax_io.duplex_from_layers(n, e, e[:20], max_rank=5),
                      io.duplex_from_layers(n, e, e[:20], max_rank=5, device="cpu"))
