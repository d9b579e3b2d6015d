"""The banded loops' device cascade (env/device_cascade.py) on CPU tensors,
where ops/cascade_kernels.py runs its plain versions: each plain version
against a numpy/scipy reading of its contract, and the engine against the
native C++ engine (and the JAX package's native engine) on random and
synthetic duplexes of 2^8–2^12 nodes: covered, both sever masks, rank,
terminal, t and alive_nodes exactly, each cascade's new severs as sets,
score and curve within 1e-12 relative; batches of 1, 17 and n/8 with
covered and out-of-range actions, an engagement in mid-episode, a reset
after a partial dismantle, unit and degree costs.  Then the engagement
surface (to(cpu) does nothing; a patched NativeDuplexEnv.step_many stays
what the loops call) and both banded loops on the engine against the C++
one."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components
from torch_one_thread import one_torch_thread  # noqa: F401

from mdcommunity_tpu_torch.env.host_env import make_host_env
from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy_banded
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex, fork_banded
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
from mdcommunity_tpu_torch.models.checkpoint import load_model
from mdcommunity_tpu_torch.native import CASCADE_STATS, NativeDuplexEnv
from mdcommunity_tpu_torch.ops import cascade_kernels as ck
from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"
REL = 1e-12


def _graph(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return tuple(rng.integers(0, n, size=(3 * n, 2)) for _ in range(2))
    return synth_duplex_edges(n, 6, rng, shuffle=kind == "shuffled")


def _weights(n, seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, size=(2, n))


def _pair(kind, n, seed, weights=None, engage=True):
    """Two native envs on one graph; the second on the device engine."""
    e0, e1 = _graph(kind, n, seed)
    ref = make_host_env(n, e0, e1, weights=weights, engine="native")
    dev = make_host_env(n, e0, e1, weights=weights, engine="native")
    if engage:
        dev.engage("cpu")
    return ref, dev


def _state(env):
    return (env.covered.tolist(), [s.tolist() for s in env.sever], env.rank, env.terminal,
            env.t, [env.alive_nodes(layer).tolist() for layer in (0, 1)])


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _same(ref, dev):
    assert _state(dev) == _state(ref)
    assert _close(dev.score, ref.score)
    rc, dc = ref.curve, dev.curve
    assert len(rc) == len(dc) and all(_close(x, y) for x, y in zip(rc, dc))


def _pairs(sev):
    return [sorted(map(tuple, s.tolist())) for s in sev]


def _actions(n, seed):
    """A removal order with noise: out-of-range entries and repeats."""
    rng = np.random.default_rng(seed)
    acts = rng.permutation(n)
    noise = np.concatenate([[-1, n, n + 7], acts[: max(n // 50, 3)]])
    return np.insert(acts, rng.integers(0, n, size=len(noise)), noise)


def _dismantle(ref, dev, acts, batch, degree_cost=False, stop=None):
    """Step both envs through `acts` in batches; compare after each."""
    i = 0
    while not ref.terminal and i < len(acts) and (stop is None or i < stop):
        chunk = acts[i:i + batch]
        i += batch
        r = ref.step_many(chunk, degree_cost=degree_cost)
        d = dev.step_many(chunk, degree_cost=degree_cost)
        assert (d[0], d[2]) == (r[0], r[2])
        assert _pairs(d[1]) == _pairs(r[1])
        _same(ref, dev)
    return i


# ------------------------------------------------------------ plain versions


@pytest.mark.parametrize("seed", range(3))
def test_plain_versions_keep_their_contracts(seed):
    n = 300
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(500, 2))
    u = torch.from_numpy(e[:, 0].astype(np.int32))
    v = torch.from_numpy(e[:, 1].astype(np.int32))
    sever = torch.from_numpy(rng.random(len(e)) < 0.1)
    covered = torch.zeros(n, dtype=torch.bool)
    acts = torch.from_numpy(np.concatenate([rng.integers(0, n, 40), [-3, n, n + 1]]))
    ck.cover(covered, acts)
    want = np.zeros(n, bool)
    a = acts.numpy()
    want[a[(a >= 0) & (a < n)]] = True
    assert covered.numpy().tolist() == want.tolist()

    alive, count = torch.empty(len(e), dtype=torch.bool), torch.zeros(1, dtype=torch.int64)
    ck.live_edges(u, v, sever, covered, alive, count)
    live = ~sever.numpy() & ~want[e[:, 0]] & ~want[e[:, 1]]
    assert alive.numpy().tolist() == live.tolist() and int(count) == live.sum()

    label, touched = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.bool)
    ck.components(u, v, alive, label, touched)
    k, comp = connected_components(
        sp.coo_matrix((np.ones(live.sum()), (e[live, 0], e[live, 1])), shape=(n, n)),
        directed=False)
    least = np.full(k, n)
    np.minimum.at(least, comp, np.arange(n))
    assert label.numpy().tolist() == least[comp].tolist()
    ends = np.zeros(n, bool)
    ends[e[live].ravel()] = True
    assert touched.numpy().tolist() == ends.tolist()

    other = rng.integers(0, n, size=(400, 2))
    other[:20, 1] = other[:20, 0]  # self-loops: kept only on a node with a live edge
    ou, ov = (torch.from_numpy(other[:, j].astype(np.int32)) for j in (0, 1))
    osev = torch.zeros(len(other), dtype=torch.bool)
    oalive = torch.ones(len(other), dtype=torch.bool)
    new_ids = torch.empty(len(other), dtype=torch.int32)
    count2 = torch.full((1,), 0, dtype=torch.int64)
    ck.sever_test(ou, ov, oalive, osev, label, touched, new_ids, count2)
    cut = (least[comp][other[:, 0]] != least[comp][other[:, 1]]) | ~ends[other[:, 0]]
    assert osev.numpy().tolist() == cut.tolist() and oalive.numpy().tolist() == (~cut).tolist()
    assert new_ids[: int(count2)].numpy().tolist() == np.flatnonzero(cut).tolist()

    out = torch.zeros(1, dtype=torch.int64)
    ck.rank(label, covered, torch.empty(n, dtype=torch.int32), out)
    lab = least[comp][~want]
    assert int(out) == (np.bincount(lab).max() if len(lab) else 0)

    mask = torch.empty(n, dtype=torch.bool)
    ck.alive_nodes(u, v, alive, mask)
    assert mask.numpy().tolist() == ends.tolist()


def test_rank_of_singletons_and_of_nothing():
    n = 8
    label = torch.arange(n, dtype=torch.int32)
    out = torch.zeros(1, dtype=torch.int64)
    covered = torch.zeros(n, dtype=torch.bool)
    ck.rank(label, covered, torch.empty(n, dtype=torch.int32), out)
    assert int(out) == 1
    ck.rank(label, ~covered, torch.empty(n, dtype=torch.int32), out)
    assert int(out) == 0


def test_wrappers_refuse_other_devices_and_dtypes():
    x = torch.zeros(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        ck.cover(x, torch.zeros(1, dtype=torch.int64, device="meta"))


# -------------------------------------------------- the engine vs the C++ one


@pytest.mark.parametrize("kind,n,batch", [
    ("angular", 256, 1), ("random", 256, 1),
    ("angular", 1024, 17), ("shuffled", 1024, 17), ("random", 1024, 17),
    ("angular", 4096, 512), ("shuffled", 4096, 512),
])
@pytest.mark.parametrize("degree_cost", [False, True])
def test_engine_matches_native_to_terminal(kind, n, batch, degree_cost):
    w = _weights(n, 3) if degree_cost else None
    ref, dev = _pair(kind, n, 0, weights=w)
    _same(ref, dev)
    _dismantle(ref, dev, _actions(n, 1), batch, degree_cost)
    assert ref.terminal and dev.terminal
    st = dev.cascade_stats
    assert list(st) == list(CASCADE_STATS) and st["on_device"] == 1
    assert ref.cascade_stats["on_device"] == 0


def test_engagement_in_mid_episode_and_reset_after_a_partial_dismantle():
    n = 2048
    w = _weights(n, 5)
    ref, dev = _pair("shuffled", n, 4, weights=w, engage=False)
    acts = _actions(n, 6)
    i = _dismantle(ref, dev, acts, 64, True, stop=640)
    assert dev.cascade_stats["on_device"] == 0
    dev.engage("cpu")
    stats = dev.cascade_stats
    assert stats["on_device"] == 0  # no cascade on the engine yet: the C++ one's
    _same(ref, dev)
    _dismantle(ref, dev, acts[i:], 64, True, stop=640)
    ref.reset()
    dev.reset()
    _same(ref, dev)
    assert dev.rank == dev.max_rank == ref.max_rank
    _dismantle(ref, dev, acts[::-1], 256, True)
    assert dev.terminal


def test_empty_batch_and_single_steps():
    n = 512
    ref, dev = _pair("angular", n, 7)
    first = ref.step_many(np.arange(0, 40))
    assert dev.step_many(np.arange(0, 40))[2] == first[2]
    # a batch that removes nothing runs no cascade: both report the last severs
    r, d = ref.step_many([-1, 3, n]), dev.step_many([-1, 3, n])
    assert r[2] == d[2] == 0 and _pairs(r[1]) == _pairs(d[1]) and r[0] == d[0]
    for a in (100, 47, 300):
        r, d = ref.step(a, degree_cost=True), dev.step(a, degree_cost=True)
        assert r[0] == d[0] and _pairs(r[1]) == _pairs(d[1])
        _same(ref, dev)


def test_engine_matches_the_jax_native_engine():
    jax_env = pytest.importorskip("mdcommunity_tpu.env.host_env")
    n = 1024
    e0, e1 = _graph("angular", n, 2)
    dev = make_host_env(n, e0, e1, engine="native").engage("cpu")
    jenv = jax_env.make_host_env(n, e0, e1)
    assert type(jenv).__name__ == "NativeDuplexEnv"
    acts = np.random.default_rng(1).permutation(n)
    i = 0
    while not jenv.terminal:
        r, d = jenv.step_many(acts[i:i + 16]), dev.step_many(acts[i:i + 16])
        i += 16
        assert (r[0], r[2]) == (d[0], d[2]) and _pairs(r[1]) == _pairs(d[1])
        assert [s.tolist() for s in jenv.sever] == [s.tolist() for s in dev.sever]
        assert jenv.terminal == dev.terminal and jenv.t == dev.t
    assert _close(jenv.score, dev.score)


# ----------------------------------------------------------- the engagement


def test_to_cpu_keeps_the_native_engine():
    n = 256
    e0, e1 = _graph("angular", n, 0)
    env = make_host_env(n, e0, e1, engine="native")
    assert env.to("cpu") is env and env.to(torch.device("cpu")) is env
    assert env._dev is None
    env.step_many(np.arange(10))
    assert env.cascade_stats["on_device"] == 0
    scipy_env = make_host_env(n, e0, e1, engine="scipy")
    assert scipy_env.to("cpu") is scipy_env


def test_engaging_twice_keeps_the_engine_and_another_device_raises():
    n = 256
    env = make_host_env(n, *_graph("angular", n, 0), engine="native").engage("cpu")
    eng = env._dev
    assert env.engage("cpu")._dev is eng
    with pytest.raises(ValueError):
        env.engage("meta")


@pytest.fixture(scope="module")
def band():
    n = 1024
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(3))
    banded, _, (o0, o1) = build_banded_duplex(n, e0, e1, device="cpu")
    return n, banded, o0, o1, load_model(CKPT, device="cpu")


def test_the_state_fault_patch_is_what_the_loop_calls(band, monkeypatch):
    """faults.planted('state') patches NativeDuplexEnv.step_many: after the
    engagement the loop still calls it, so the fault keeps its effect."""
    from mdbench import faults

    n, banded, o0, o1, net = band
    env = make_host_env(n, o0, o1, engine="native").engage("cpu")
    calls = []
    step_many = NativeDuplexEnv.step_many

    def spy(self, actions, degree_cost=False):
        calls.append(len(actions))
        return step_many(self, actions, degree_cost)

    monkeypatch.setattr(NativeDuplexEnv, "step_many", spy)
    with faults.planted("state", "dismantle"):
        sol, _, curve = dismantle_greedy_banded(net, fork_banded(banded), env, step=64,
                                                batch_env=True, max_steps=192)
    assert not calls and len(sol) == 192
    assert env.t == 0 and not env.covered.any() and curve == [1.0]
    dismantle_greedy_banded(net, fork_banded(banded), env, step=64, batch_env=True,
                            max_steps=64)
    assert calls == [64] and env.t == 64


def test_dismantle_loop_on_the_engine_matches_native(band):
    n, banded, o0, o1, net = band
    runs = []
    for engage in (False, True):
        env = make_host_env(n, o0, o1, engine="native")
        if engage:
            env.engage("cpu")
        stats = {}
        runs.append(dismantle_greedy_banded(net, fork_banded(banded), env, step=32,
                                            batch_env=True, stats=stats))
        rows = [r for r in stats["batches"] if "on_device" in r]
        assert rows and all(r["on_device"] == int(engage) for r in rows)
    (rs, rscore, rcurve), (ds, dscore, dcurve) = runs
    assert ds == rs and _close(dscore, rscore)
    assert len(dcurve) == len(rcurve) and all(_close(x, y) for x, y in zip(rcurve, dcurve))


def test_train_loop_on_the_engine_matches_native(band):
    n, banded, o0, o1, net = band
    hists = []
    for engage in (False, True):
        env = make_host_env(n, o0, o1, engine="native")
        if engage:
            env.engage("cpu")
        acts = []

        class Spy:
            def __getattr__(self, name):
                return getattr(env, name)

            def step_many(self, actions, degree_cost=False):
                acts.append(np.array(actions))
                return env.step_many(actions, degree_cost=degree_cost)

        _, hist = train_banded_loop(net, banded, Spy(), iters=3, k=64, eps_start=0.5,
                                    eps_end=0.5, log=lambda *a, **k: None)
        rows = [h for h in hist if "loss" in h]
        assert [h["on_device"] for h in rows] == [int(engage)] * 3
        hists.append((acts, [h["loss"] for h in rows], [h["norm"] for h in rows]))
    (ra, rl, rn), (da, dl, dn) = hists
    assert all(np.array_equal(a, b) for a, b in zip(ra, da)) and len(ra) == len(da) == 3
    assert dl == rl and dn == rn
