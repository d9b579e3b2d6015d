"""The port's device cascade and environment against the JAX package's and
against the networkx oracle (tests/oracle.py), on both engines: the dense
closure (pad_n <= 128) and min-label propagation (pad_n 256).  Labels,
severed sets and ranks are held exactly; rewards and scores to f32."""

import networkx as nx
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.cascade import cascade as jax_cascade  # noqa: E402
from mdcommunity_tpu.env.cascade import connected_components as jax_cc  # noqa: E402
from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import batched_step as jax_step  # noqa: E402
from mdcommunity_tpu.env.env import batched_valid_mask as jax_valid  # noqa: E402
from mdcommunity_tpu.graphs.duplex import build_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu_torch.env import cascade as C  # noqa: E402
from mdcommunity_tpu_torch.env.env import (  # noqa: E402
    batched_reset,
    batched_step,
    env_reset,
    env_step,
    valid_action_mask,
)
from mdcommunity_tpu_torch.graphs.duplex import build_duplex, stack_graphs  # noqa: E402

from oracle import OracleEnv, mcc_oracle  # noqa: E402

ENGINES = [(48, 512), (256, 1024)]  # (pad_n, pad_e): dense closure, label propagation


def random_duplex(rng, n, p0=0.12, p1=0.12):
    g1 = nx.gnp_random_graph(n, p0, seed=int(rng.integers(1 << 30)))
    g2 = nx.gnp_random_graph(n, p1, seed=int(rng.integers(1 << 30)))
    return list(g1.edges()), list(g2.edges())


def _pair(e0, e1, n, pads, weights=None):
    pad_n, pad_e = pads
    return (jax_build(n, e0, e1, pad_n, pad_e, weights=weights),
            build_duplex(n, e0, e1, pad_n, pad_e, weights=weights, device="cpu"))


def sever_set(g, sever_mask, layer):
    s, d = g.src[layer].numpy(), g.dst[layer].numpy()
    m = np.asarray(sever_mask[layer]) & g.edge_mask[layer].numpy()
    return {(min(a, b), max(a, b)) for a, b in zip(s[m], d[m])}


def _same_result(jr, tr):
    np.testing.assert_array_equal(tr.rank.numpy(), np.asarray(jr.rank))
    np.testing.assert_array_equal(tr.sever.numpy(), np.asarray(jr.sever))
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    np.testing.assert_array_equal(tr.live_edge.numpy(), np.asarray(jr.live_edge))


@pytest.mark.parametrize("pads", ENGINES, ids=["dense", "labels"])
def test_cascade_matches_jax_and_oracle(pads):
    """Random graphs, covered sets and prior sever records: labels, severed
    sets, live edges and rank equal the JAX package's; intact ranks and
    severed sets equal the oracle's."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        n = int(rng.integers(10, 45))
        e0, e1 = random_duplex(rng, n)
        jg, tg = _pair(e0, e1, n, pads)
        g1 = nx.Graph(); g1.add_nodes_from(range(n)); g1.add_edges_from(e0)
        g2 = nx.Graph(); g2.add_nodes_from(range(n)); g2.add_edges_from(e1)
        rank, s1, s2, _ = mcc_oracle(g1, g2)
        tr = C.cascade_from_scratch(tg, torch.zeros(tg.pad_n, dtype=torch.bool))
        assert int(tg.max_rank) == int(jg.max_rank) == rank == int(tr.rank)
        assert sever_set(tg, tr.sever, 0) == s1 and sever_set(tg, tr.sever, 1) == s2

        covered = np.zeros(tg.pad_n, bool)
        covered[rng.choice(n, size=int(rng.integers(1, n // 2)), replace=False)] = True
        sever = rng.random((2, tg.pad_e)) < 0.1
        jr = jax_cascade(jg, jnp.asarray(covered), jnp.asarray(sever))
        tr = C.cascade(tg, torch.from_numpy(covered), torch.from_numpy(sever))
        _same_result(jr, tr)


@pytest.mark.parametrize("pads", ENGINES, ids=["dense", "labels"])
def test_batched_cascade_equals_single(pads):
    rng = np.random.default_rng(1)
    graphs = [_pair(*random_duplex(rng, 30), 30, pads)[1] for _ in range(4)]
    gb = stack_graphs(graphs)
    cov = torch.from_numpy(rng.random((4, gb.pad_n)) < 0.2)
    sev = torch.zeros_like(gb.edge_mask)
    batch = C.cascade(gb, cov, sev)
    for b, g in enumerate(graphs):
        one = C.cascade(g, cov[b], sev[b])
        for x, y in zip(batch, one):
            assert torch.equal(x[b], y)


def test_connected_components_matches_jax():
    rng = np.random.default_rng(2)
    e0, _ = random_duplex(rng, 200, 0.01, 0.01)
    _, tg = _pair(e0, e0, 200, (256, 1024))
    alive = rng.random(256) < 0.9
    live = tg.edge_mask[0].numpy() & (rng.random(1024) < 0.8)
    ref = jax_cc(jnp.asarray(alive), jnp.asarray(tg.src[0].numpy()),
                 jnp.asarray(tg.dst[0].numpy()), jnp.asarray(live))
    got = C.connected_components(torch.from_numpy(alive), tg.src[0], tg.dst[0],
                                 torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("pads", ENGINES, ids=["dense", "labels"])
@pytest.mark.parametrize("degree_cost", [False, True], ids=["unit", "degree"])
def test_batched_episode_matches_jax(pads, degree_cost):
    """Random-action episodes on a batch of 4, through batched_reset /
    batched_step (terminal members step as no-ops): every state field
    equal to the JAX package's (score and reward to f32)."""
    rng = np.random.default_rng(3)
    pairs = []
    for _ in range(4):
        n = int(rng.integers(16, 40))
        e0, e1 = random_duplex(rng, n, 0.15, 0.15)
        w = rng.random((2, n)).astype(np.float32) + 0.1 if degree_cost else None
        pairs.append(_pair(e0, e1, n, pads, weights=w))
    jg = jax_stack([p[0] for p in pairs])
    tg = stack_graphs([p[1] for p in pairs])
    js, ts = jax_reset(jg), batched_reset(tg)
    for step in range(45):
        for f in ("covered", "sever", "rank", "t", "terminal"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
        np.testing.assert_allclose(ts.score.numpy(), np.asarray(js.score), rtol=1e-6)
        mask = valid_action_mask(tg, ts).numpy()
        np.testing.assert_array_equal(mask, np.asarray(jax_valid(jg, js)))
        if ts.terminal.all():
            break
        acts = np.array([rng.choice(np.nonzero(m)[0]) if m.any() else 0 for m in mask])
        js, jr = jax_step(jg, js, jnp.asarray(acts), degree_cost)
        ts, tr = batched_step(tg, ts, torch.from_numpy(acts), degree_cost)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    assert ts.terminal.all()


def test_env_episode_matches_oracle():
    rng = np.random.default_rng(4)
    n = 20
    for _ in range(4):
        e0, e1 = random_duplex(rng, n, 0.15, 0.15)
        g = build_duplex(n, e0, e1, 48, 512, device="cpu")
        oracle = OracleEnv(e0, e1, n)
        assert int(g.max_rank) == oracle.max_rank
        state = env_reset(g)
        assert bool(state.terminal) == oracle.terminal()
        while not bool(state.terminal):
            acts = oracle.valid_actions()
            mask = valid_action_mask(g.map(lambda t: t[None]), state.map(lambda t: t[None]))
            assert np.nonzero(mask[0].numpy())[0].tolist() == acts
            a = int(rng.choice(acts))
            state, r = env_step(g, state, a)
            assert abs(float(r) - oracle.step(a)) < 1e-6
            assert bool(state.terminal) == oracle.terminal()
            assert int(state.rank) == oracle.rank
        assert abs(float(state.score) - oracle.score) < 1e-5


def test_empty_layer_terminal():
    g = build_duplex(4, [(0, 1)], [], 8, 128, device="cpu")
    assert bool(env_reset(g).terminal)
