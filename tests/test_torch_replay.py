"""The port's replay buffers and graph ring against the JAX package's, with
exact equality: the same episodes added and the same numpy generator seed
give identical batches, indices and importance weights (the port's
rl/replay.py and rl/replay_prioritized.py are its own copies of the JAX
package's numpy code), and the same pools written into EpochGraphRing give
the same slots, epochs, t=0 rows and host sever masks (the cases of the JAX
package's tests/test_dqn_smoke.py:52, tests/test_replay_prioritized.py and
tests/test_graph_ring.py)."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.graphs.duplex import EpochGraphRing as JaxRing  # noqa: E402
from mdcommunity_tpu.graphs.duplex import index_graphs as jax_index  # noqa: E402
from mdcommunity_tpu.graphs.gmm import generate_pool as jax_pool  # noqa: E402
from mdcommunity_tpu.rl import replay as jax_replay  # noqa: E402
from mdcommunity_tpu.rl import replay_prioritized as jax_prio  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import EpochGraphRing, index_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.gmm import generate_pool  # noqa: E402
from mdcommunity_tpu_torch.rl import replay, replay_prioritized  # noqa: E402


def _episodes(seed, n_ep, pad_n, pad_e, t_max=9):
    """Random episodes: (gid, covered_seq, sever_seq, actions, rewards, epoch)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ep):
        T = int(rng.integers(1, t_max))
        cov = [rng.random(pad_n) < 0.3 for _ in range(T + 1)]
        sev = [rng.random((2, pad_e)) < 0.2 for _ in range(T + 1)]
        acts = [int(a) for a in rng.integers(0, pad_n, T)]
        rews = [float(r) for r in -rng.random(T)]
        out.append((int(rng.integers(0, 12)), cov, sev, acts, rews, int(rng.integers(0, 3))))
    return out


def _fill(mod_a, mod_b, cls, episodes, *args):
    a, b = getattr(mod_a, cls)(*args), getattr(mod_b, cls)(*args)
    for gid, cov, sev, acts, rews, ep in episodes:
        a.add_episode(gid, cov, sev, acts, rews, graph_epoch=ep)
        b.add_episode(gid, cov, sev, acts, rews, graph_epoch=ep)
    return a, b


def _same_batch(x, y):
    for f in dataclasses.fields(x):
        np.testing.assert_array_equal(getattr(x, f.name), getattr(y, f.name), err_msg=f.name)


def _same_buffers(a, b):
    for k in ("graph_ids", "graph_epochs", "covered_st", "sever_st", "actions", "rewards",
              "covered_sp", "sever_sp", "terminal"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert (a.count, a.current) == (b.count, b.current)


def test_nstep_returns_match_jax():
    """JAX tests/test_dqn_smoke.py:52's episode: the n-step suffix sums,
    terminal flags and packed masks of both buffers, element for element."""
    T = 4
    covered = [np.zeros(8, bool) for _ in range(T + 1)]
    sever = [np.zeros((2, 16), bool) for _ in range(T + 1)]
    for i in range(T):
        covered[i + 1] = covered[i].copy()
        covered[i + 1][i] = True
    a, b = _fill(jax_replay, replay, "NStepReplay",
                 [(0, covered, sever, [0, 1, 2, 3], [-1.0, -2.0, -3.0, -4.0], 0)],
                 100, 8, 16, 2)
    _same_buffers(a, b)
    assert list(b.rewards[:4]) == [-3.0, -5.0, -7.0, -4.0]
    assert list(b.terminal[:4]) == [False, False, True, True]
    _same_batch(a.sample(np.random.default_rng(0), 4), b.sample(np.random.default_rng(0), 4))


@pytest.mark.parametrize("capacity", [50, 1000])
def test_nstep_sample_matches_jax(capacity):
    """Random episodes (the ring wraps at capacity 50), the same generator
    seed: identical batches, with and without a slots_live filter."""
    a, b = _fill(jax_replay, replay, "NStepReplay", _episodes(1, 40, 24, 40), capacity, 24,
                 40, 5)
    _same_buffers(a, b)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)

    def live(slots, epochs):
        return (slots + epochs) % 3 != 0

    for filt in (None, live, None):
        _same_batch(a.sample(ra, 16, slots_live=filt), b.sample(rb, 16, slots_live=filt))
    assert ra.bit_generator.state == rb.bit_generator.state


def test_sumtree_matches_jax_mixed_depths_and_large_capacity():
    """The JAX tests' SumTree cases: a non-power-of-two capacity whose
    leaves sit on two depths (a batch straddling them), and capacity
    100,000 across the depth-16/17 boundary: equal trees and descents."""
    rng = np.random.default_rng(0)
    for cap, idx in ((100, np.array([0, 5, 27, 28, 40, 99])),
                     (100_000, np.array([0, 31_000, 31_071, 31_072, 31_073, 99_999]))):
        ta, tb = jax_prio.SumTree(cap), replay_prioritized.SumTree(cap)
        pri = rng.random(cap)
        for sel in (idx, np.setdiff1d(np.arange(cap), idx)[:5000]):
            ta.update(sel, pri[sel])
            tb.update(sel, pri[sel])
        np.testing.assert_array_equal(ta.tree, tb.tree)
        vals = rng.random(256) * ta.total()
        np.testing.assert_array_equal(ta.sample(vals), tb.sample(vals))


def test_prioritized_matches_jax_with_slots_live():
    """The same priorities and draws give the same indices and IS weights,
    through deferred priority updates with write generations and through
    the stale-slot zeroing of slots_live (JAX
    test_prioritized_sampling_respects_slots_live's shape)."""
    eps = _episodes(2, 60, 16, 32)
    a, b = _fill(jax_prio, replay_prioritized, "PrioritizedNStepReplay", eps, 128, 16, 32, 5)
    _same_buffers(a, b)
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)

    def live(slots, epochs):
        return epochs >= 1

    td_rng = np.random.default_rng(4)
    for filt in (None, live, live, None):
        pa = a.sample_prioritized(ra, 16, slots_live=filt)
        pb = b.sample_prioritized(rb, 16, slots_live=filt)
        _same_batch(pa.batch, pb.batch)
        np.testing.assert_array_equal(pa.tree_idx, pb.tree_idx)
        np.testing.assert_array_equal(pa.is_weights, pb.is_weights)
        gen = a.write_gen[pa.tree_idx].copy()
        td = td_rng.normal(size=16)
        a.update_priorities(pa.tree_idx, td, write_gen=gen)
        b.update_priorities(pb.tree_idx, td, write_gen=gen)
        np.testing.assert_array_equal(a.tree.tree, b.tree.tree)
        np.testing.assert_array_equal(a.write_gen, b.write_gen)
        assert a.beta == b.beta and a._max_priority == b._max_priority
        if filt is live:
            assert (b.graph_epochs[pb.tree_idx] >= 1).all()
            stale = np.nonzero(b.graph_epochs[: b.count] == 0)[0]
            assert stale.size and (b.tree.tree[stale + b.tree.capacity - 1] == 0).all()


def _pools(seed, count=4):
    return (jax_pool(np.random.default_rng(seed), count, 12, 16, 16, 128),
            generate_pool(np.random.default_rng(seed), count, 12, 16, 16, 128, device="cpu"))


def test_ring_matches_jax_over_three_epochs():
    """K = 2, three epochs (the third wraps onto the first's slots): the
    same base, slot epochs, stacked graphs, t=0 rows, host sever masks,
    sampled slots and liveness (JAX tests/test_graph_ring.py)."""
    ja, tb = JaxRing(epochs=2), EpochGraphRing(epochs=2)
    for seed in (5, 6, 7):
        jp, tp = _pools(seed)
        ja.write_epoch(jp)
        tb.write_epoch(tp)
        assert (ja.epoch, ja.base, len(ja)) == (tb.epoch, tb.base, len(tb))
        np.testing.assert_array_equal(ja.slot_epoch, tb.slot_epoch)
        for f in dataclasses.fields(tb.stacked):
            np.testing.assert_array_equal(np.asarray(getattr(ja.stacked, f.name)),
                                          getattr(tb.stacked, f.name).numpy(), err_msg=f.name)
        for f in dataclasses.fields(tb.stacked_s0):
            np.testing.assert_array_equal(np.asarray(getattr(ja.stacked_s0, f.name)),
                                          getattr(tb.stacked_s0, f.name).numpy(), err_msg=f.name)
        np.testing.assert_array_equal(ja.s0_sever_host, tb.s0_sever_host)
        sa = ja.sample_slots(np.random.default_rng(seed), 64)
        np.testing.assert_array_equal(sa, tb.sample_slots(np.random.default_rng(seed), 64))
        assert sa.min() >= tb.base and sa.max() < tb.base + tb.pool_size
        slots, epochs = np.arange(8), np.array([0, 1, 2, 0, 1, 2, 2, 1])
        np.testing.assert_array_equal(ja.slots_live(slots, epochs), tb.slots_live(slots, epochs))
    # the third epoch overwrote epoch 0's slots; epoch 1's stay live
    assert not tb.slots_live(np.array([1]), np.array([0])).any()
    assert tb.slots_live(np.array([5]), np.array([1])).all()
    gids = tb.sample_slots(np.random.default_rng(1), 3)
    fresh = batched_reset(index_graphs(tb.stacked, torch.as_tensor(gids)))
    np.testing.assert_array_equal(tb.stacked_s0.sever[gids].numpy(), fresh.sever.numpy())
    jfresh = jax_reset(jax_index(ja.stacked, jnp.asarray(gids)))
    np.testing.assert_array_equal(np.asarray(jfresh.rank), fresh.rank.numpy())
