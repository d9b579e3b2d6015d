"""The padded small-graph forward against the JAX package's: batch operands
(make_batch_inputs), the aggregation helpers, and Q from test_forward and
train_forward on the dense and segment engines, with random parameters and
with the committed unit-cost checkpoint.

Operands are degree counts and ratios of them, held exactly or to 1 ulp;
Q is held at f32 tolerance (rtol 1e-5, atol 1e-5 of the Q range): both
packages compute in f32, summing in different orders (the port's
virtual-node pool is a graph-wide f64 sum), and the checkpoint's Q values
cancel down from terms ~10x larger, so each engine's error is ~1e-6 of
the range."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.batch import make_batch_inputs as jax_inputs  # noqa: E402
from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.env.env import batched_step as jax_step  # noqa: E402
from mdcommunity_tpu.graphs import gmm as jax_gmm  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.models.net import init_params  # noqa: E402
from mdcommunity_tpu.models.net import test_forward as jax_test_forward  # noqa: E402
from mdcommunity_tpu.models.net import train_forward as jax_train_forward  # noqa: E402
from mdcommunity_tpu.ops import aggregate as jax_agg  # noqa: E402
from mdcommunity_tpu_torch.env.batch import make_batch_inputs  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset, batched_step  # noqa: E402
from mdcommunity_tpu_torch.graphs import gmm  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import DuplexQNet  # noqa: E402
from mdcommunity_tpu_torch.models.net import test_forward as port_test_forward  # noqa: E402
from mdcommunity_tpu_torch.models.net import train_forward as port_train_forward  # noqa: E402
from mdcommunity_tpu_torch.ops import aggregate as agg  # noqa: E402
from mdcommunity_tpu_torch.rl.dqn import predict_q  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"


@pytest.fixture(scope="module")
def states():
    """A batch of 8 GMM graphs (pad 64) in mid-episode states: both
    packages step the same random valid actions from reset."""
    rng = np.random.default_rng(0)
    jp = jax_gmm.generate_pool(np.random.default_rng(11), 8, 30, 50, 64, 1024, degree_cost=True)
    tp = gmm.generate_pool(np.random.default_rng(11), 8, 30, 50, 64, 1024, degree_cost=True,
                           device="cpu")
    jg, tg = jax_stack(jp), stack_graphs(tp)
    js, ts = jax_reset(jg), batched_reset(tg)
    for _ in range(5):
        q = np.where(ts.covered.numpy() | ~tg.node_mask.numpy(), -1.0, rng.random((8, 64)))
        a = np.argmax(q, axis=1)
        js, _ = jax_step(jg, js, jnp.asarray(a))
        ts, _ = batched_step(tg, ts, torch.from_numpy(a))
    return jg, js, tg, ts


def _nets(seed=0):
    params = init_params(jax.random.PRNGKey(seed))
    return params, DuplexQNet(jax.tree_util.tree_map(np.array, params))


@pytest.mark.parametrize("variant", ["unit_cost", "degree_cost"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "segment"])
def test_batch_inputs_match_jax(states, variant, dense):
    jg, js, tg, ts = states
    ji = jax_inputs(jg, js.covered, js.sever, dense=dense, variant=variant)
    ti = make_batch_inputs(tg, ts.covered, ts.sever, dense=dense, variant=variant)
    for f in dataclasses.fields(ti):
        ref, got = getattr(ji, f.name), getattr(ti, f.name)
        if ref is None:
            assert got is None, f.name
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-7, err_msg=f.name)
    assert ti.active.any() and (ti.aux[:, :, 1] > 0).any()  # covered-edge counters live


def test_aggregation_helpers_match_jax():
    rng = np.random.default_rng(1)
    n, E = 40, 300
    src = rng.integers(0, n, (3, E))
    dst = rng.integers(0, n, (3, E))
    live = rng.random((3, E)) < 0.7
    h = rng.standard_normal((3, n, 8)).astype(np.float32)
    for b in range(3):
        s, d = jnp.asarray(src[b]), jnp.asarray(dst[b])
        for agg_id in (0, 1, 2):
            ref = jax_agg.edge_weights(s, d, jnp.asarray(live[b]), n, agg_id)
            got = agg.edge_weights(torch.from_numpy(src[b]), torch.from_numpy(dst[b]),
                                   torch.from_numpy(live[b]), n, agg_id)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
        w = np.array(ref)
        ref_seg = jax_agg.segment_spmm(s, d, jnp.asarray(w), jnp.asarray(h[b]), n)
        got_seg = agg.segment_spmm(torch.from_numpy(src[b]), torch.from_numpy(dst[b]),
                                   torch.from_numpy(w), torch.from_numpy(h[b]), n)
        np.testing.assert_allclose(got_seg.numpy(), np.asarray(ref_seg), rtol=1e-5, atol=1e-6)
    # batched segment sum = per-graph ones; dense adjacency of unique edges
    w = torch.from_numpy(live.astype(np.float32))
    bat = agg.segment_spmm(torch.from_numpy(src), torch.from_numpy(dst), w, torch.from_numpy(h), n)
    for b in range(3):
        one = agg.segment_spmm(torch.from_numpy(src[b]), torch.from_numpy(dst[b]), w[b],
                               torch.from_numpy(h[b]), n)
        assert torch.equal(bat[b], one)
    uniq = np.unique(src[0] * n + dst[0], return_index=True)[1]
    s0, d0, w0 = src[0][uniq], dst[0][uniq], live[0][uniq].astype(np.float32)
    ref = jax_agg.dense_adjacency(jnp.asarray(s0), jnp.asarray(d0), jnp.asarray(w0), n)
    got = agg.dense_adjacency(torch.from_numpy(s0), torch.from_numpy(d0), torch.from_numpy(w0), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _close_q(got, ref):
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.abs(ref[fin]).max()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "segment"])
def test_test_forward_matches_jax(states, dense):
    jg, js, tg, ts = states
    params, net = _nets(0)
    ji = jax_inputs(jg, js.covered, js.sever, dense=dense)
    ti = make_batch_inputs(tg, ts.covered, ts.sever, dense=dense)
    ref = np.asarray(jax_test_forward(params, jg, ji))
    with torch.no_grad():
        got = port_test_forward(net, tg, ti).numpy()
    _close_q(got, ref)
    # the two engines agree with each other as well
    other = predict_q(net, tg, ts.covered, ts.sever, dense=not dense).numpy()
    _close_q(other, got)


def test_checkpoint_q_matches_jax(states):
    """The committed unit-cost checkpoint, as the golden validation runs it."""
    from mdcommunity_tpu.rl.dqn import DQNAgent
    from mdcommunity_tpu.utils.config import Config

    jg, js, tg, ts = states
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    agent.load(CKPT)
    net = load_model(CKPT, device="cpu")
    ref = np.asarray(jax_test_forward(agent.params, jg, jax_inputs(jg, js.covered, js.sever)))
    got = predict_q(net, tg, ts.covered, ts.sever).numpy()
    _close_q(got, ref)


def test_train_forward_matches_jax(states):
    jg, js, tg, ts = states
    params, net = _nets(1)
    acts = np.argmax(np.where(ts.covered.numpy(), -1, np.arange(64)[None] % 7), axis=1)
    ji = jax_inputs(jg, js.covered, js.sever)
    ti = make_batch_inputs(tg, ts.covered, ts.sever)
    q_ref, h_ref = jax_train_forward(params, jg, ji, jnp.asarray(acts))
    with torch.no_grad():
        q, h = port_train_forward(net, tg, ti, torch.from_numpy(acts))
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)
