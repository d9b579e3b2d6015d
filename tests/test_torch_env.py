"""Port's host envs (native C++ engine and the scipy one) vs the JAX package's
make_host_env on the same seeded graph: traces exact; and the engines'
cascade counters."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdcommunity_tpu.env.host_env import HostDuplexEnv as JaxHostEnv  # noqa: E402
from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import HostDuplexEnv, make_host_env  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.native import CASCADE_STATS, NativeDuplexEnv, load  # noqa: E402

N = 1024


def _edges(seed):
    return synth_duplex_edges(N, 6, np.random.default_rng(seed), shuffle=False)


def _sev(edges, canon):
    """A sever report; canon=True sorts it (the native and scipy engines
    report the same set in another order)."""
    return sorted(map(tuple, edges.tolist())) if canon else edges.tolist()


def _trace(env, actions, batch=None, canon=False):
    """Step through `actions` (one by one, or step_many in batches) and
    record everything the eval loop reads."""
    out = [(env.rank, env.terminal, [s.tolist() for s in env.sever])]
    i = 0
    while i < len(actions) and not env.terminal:
        if batch:
            rank, sev, removed = env.step_many(actions[i:i + batch])
            i += batch
            out.append(removed)
        else:
            a = int(actions[i])
            i += 1
            if env.covered[a]:
                continue
            rank, sev = env.step(a)
        out.append((rank, env.terminal, [_sev(s, canon) for s in sev], env.t))
    out.append((env.score, env.curve, [s.tolist() for s in env.sever],
                env.covered.tolist()))
    return out


def _envs(seed, engine):
    """The port's env on `engine` and the JAX package's env on the same
    engine (its make_host_env picks the native one; its scipy class is
    HostDuplexEnv over the same canonicalised edges)."""
    e0, e1 = _edges(seed)
    tenv = make_host_env(N, e0, e1, engine=engine)
    jenv = jax_make_env(N, e0, e1)
    assert type(jenv).__name__ == "NativeDuplexEnv"
    if engine == "scipy":
        jenv = JaxHostEnv(N, *tenv.edges)
    return jenv, tenv


@pytest.mark.parametrize("batch", [None, 16])
@pytest.mark.parametrize("engine", ["native", "scipy"])
def test_env_trace_matches_jax(engine, batch):
    jenv, tenv = _envs(0, engine)
    assert tenv.engine == engine
    assert isinstance(tenv, NativeDuplexEnv if engine == "native" else HostDuplexEnv)
    assert tenv.max_rank == jenv.max_rank
    actions = np.random.default_rng(1).permutation(N)
    assert _trace(tenv, actions, batch) == _trace(jenv, actions, batch)


def test_scipy_env_has_alive_nodes():
    """The JAX package's scipy env lacks alive_nodes (the native one has
    it); the port's has it and agrees with the native engine."""
    e0, e1 = _edges(2)
    native = make_host_env(N, e0, e1, engine="native")
    scipy_env = make_host_env(N, e0, e1, engine="scipy")
    assert not hasattr(JaxHostEnv, "alive_nodes")
    for a in np.random.default_rng(3).permutation(N)[:300]:
        if native.terminal:
            break
        if native.covered[a]:
            continue
        native.step(int(a))
        scipy_env.step(int(a))
        for layer in range(2):
            np.testing.assert_array_equal(scipy_env.alive_nodes(layer),
                                          native.alive_nodes(layer))
    assert native.t > 50


def test_native_epoch_wrap_keeps_the_trace():
    """The relabel union-find's u32 epoch wraps after 2^32 relabels; the
    port's engine then clears its co-stamped root->record map too.  Driven
    through the wrap from just below it, it walks the scipy engine's exact
    trace and its own unwrapped one."""
    assert load() is not None
    e0, e1 = _edges(4)
    wrapped = make_host_env(N, e0, e1, engine="native")
    plain = make_host_env(N, e0, e1, engine="native")
    scipy_env = make_host_env(N, e0, e1, engine="scipy")
    # the stamps written by reset's relabels are small epochs; start the
    # counter a few relabels before the wrap so they meet restarted epochs
    wrapped.set_uf_epoch(2**32 - 3)
    actions = np.random.default_rng(5).permutation(N)
    got = _trace(wrapped, actions)
    assert got == _trace(plain, actions)
    wrapped.reset()
    plain.reset()
    scipy_env.reset()
    wrapped.set_uf_epoch(2**32 - 3)
    assert _trace(wrapped, actions, canon=True) == _trace(scipy_env, actions, canon=True)
    assert wrapped.t > 100


# ------------------------------------------------------ cascade counters


def test_reset_cascade_walks_every_edge():
    """The reset cascade relabels one seed record a layer that holds every
    node and edge, so it walks at least every edge of each layer; all its
    severs are new."""
    e0, e1 = _edges(6)
    env = make_host_env(N, e0, e1, engine="native")
    st = env.cascade_stats
    assert list(st) == list(CASCADE_STATS)
    assert st["edges_walked"] >= len(e0) + len(e1)
    assert st["nodes_walked"] >= 2 * N
    assert st["rounds"] >= 1 and st["records_relabelled"] >= 2
    assert st["edges_severed"] == sum(int(s.sum()) for s in env.sever)
    env.reset()
    assert env.cascade_stats["edges_walked"] >= len(e0) + len(e1)


def _sever_counts(env, actions, batch):
    """edges_severed of the reset and of each cascade along `actions`,
    checked against the severs each step reports."""
    out = [env.cascade_stats["edges_severed"]]
    i = 0
    while i < len(actions) and not env.terminal:
        if batch:
            _, sev, removed = env.step_many(actions[i:i + batch])
            i += batch
            if not removed:
                continue
        else:
            a = int(actions[i])
            i += 1
            if env.covered[a]:
                continue
            _, sev = env.step(a)
        assert env.cascade_stats["edges_severed"] == len(sev[0]) + len(sev[1])
        out.append(env.cascade_stats["edges_severed"])
    return out


@pytest.mark.parametrize("batch", [None, 16])
@pytest.mark.parametrize("engine", ["native", "scipy"])
def test_edges_severed_counts_the_reported_severs(engine, batch):
    e0, e1 = _edges(7)
    env = make_host_env(N, e0, e1, engine=engine)
    counts = _sever_counts(env, np.random.default_rng(8).permutation(N)[:400], batch)
    assert len(counts) > 20 and sum(counts[1:]) > 0


@pytest.mark.parametrize("batch", [None, 16])
def test_engines_agree_on_severed_counts(batch):
    """The native and scipy engines sever the same edges along one action
    trace, so their counters agree cascade by cascade; the scipy engine's
    label passes walk the live edges of a whole layer each."""
    e0, e1 = _edges(9)
    native, scipy_env = (make_host_env(N, e0, e1, engine=e) for e in ("native", "scipy"))
    actions = np.random.default_rng(10).permutation(N)
    assert _sever_counts(native, actions, batch) == _sever_counts(scipy_env, actions, batch)
    st = scipy_env.cascade_stats
    assert set(st) < set(CASCADE_STATS)
    assert st["edges_walked"] >= 2 * st["rounds"] * min(int(a.sum()) for a in scipy_env.alive_edge)


def test_covering_a_small_component_walks_only_it():
    """Covering the middle node of a five-node path that both layers share,
    beside a graph of N nodes, relabels that component's record in each
    layer and nothing else: at most its 5 + 5 nodes and 4 + 4 edges are
    walked, and nothing is severed."""
    e0, e1 = _edges(11)
    path = np.array([[N + i, N + i + 1] for i in range(4)], np.int64)
    env = make_host_env(N + 5, np.concatenate([e0, path]), np.concatenate([e1, path]),
                        engine="native")
    env.step(N + 2)
    st = env.cascade_stats
    assert 0 < st["nodes_walked"] <= 10 and 0 < st["edges_walked"] <= 8
    assert st["records_relabelled"] == 2 and st["edges_severed"] == 0
    assert st["nodes_moved"] <= 4
