"""Port's host envs (native C++ engine and the scipy one) vs the JAX package's
make_host_env on the same seeded graph: traces exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mdcommunity_tpu.env.host_env import HostDuplexEnv as JaxHostEnv  # noqa: E402
from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import HostDuplexEnv, make_host_env  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.native import NativeDuplexEnv, load  # noqa: E402

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
