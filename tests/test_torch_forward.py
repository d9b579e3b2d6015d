"""Port's banded Q forward vs the JAX package's two engines, with the
committed unit-cost checkpoint loaded by each package's own loader."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.banded import pack_duplex  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu.models.net_packed import banded_test_forward_packed  # noqa: E402
from mdcommunity_tpu.rl.dqn import DQNAgent  # noqa: E402
from mdcommunity_tpu.utils.config import Config  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"
ATOL = 1e-5  # f32 on both sides; Q values are O(0.1)
N = 1024


@pytest.fixture(scope="module")
def jax_params():
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    agent.load(CKPT)
    return agent.params


def test_load_params_equals_the_agent_loader(jax_params):
    ours = load_params(CKPT)
    flat_j = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(flat_j) == 13
    for path, leaf in flat_j:
        node = ours
        for k in path:
            node = node[k.key]
        assert node.dtype == np.float32
        np.testing.assert_array_equal(node, np.asarray(leaf))
    net = load_model(CKPT, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 31205


def _state(seed, covered_frac):
    rng = np.random.default_rng(seed)
    e0, e1 = synth_duplex_edges(N, 6, rng)
    jb, _, _ = jax_build(N, e0, e1)
    tb, _, _ = build_banded_duplex(N, e0, e1, device="cpu")
    assert tb.spill_free  # so the fused step applies
    covered = (rng.random(tb.pad_n) < covered_frac) | ~tb.node_mask.numpy()
    return jb, tb, covered


def _assert_q_close(q, ref):
    q, ref = np.asarray(q), np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(q), fin)
    np.testing.assert_array_equal(q[~fin], ref[~fin])  # -inf masks
    assert fin.sum() > N // 2
    np.testing.assert_allclose(q[fin], ref[fin], rtol=0, atol=ATOL)


@pytest.mark.parametrize("covered_frac", [0.0, 0.2])
@pytest.mark.parametrize("fuse_sage", [False, True])
def test_forward_matches_xla_engine(jax_params, fuse_sage, covered_frac):
    jb, tb, covered = _state(0, covered_frac)
    ref = jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=True))(
        jax_params, jb, jnp.asarray(covered))
    q = banded_test_forward(load_model(CKPT, device="cpu"), tb, torch.from_numpy(covered),
                            fuse_sage=fuse_sage)
    _assert_q_close(q, ref)


@pytest.mark.parametrize("fuse_sage", [False, True])
def test_forward_matches_packed_engine(jax_params, fuse_sage):
    """Against the Pallas engine (interpret mode), fused or not as the
    port is."""
    jb, tb, covered = _state(1, 0.1)
    ref = banded_test_forward_packed(
        jax_params, jb, pack_duplex(jb), jnp.asarray(covered), interpret=True,
        fuse_sage=fuse_sage, precise=True,
    )
    q = banded_test_forward(load_model(CKPT, device="cpu"), tb, torch.from_numpy(covered),
                            fuse_sage=fuse_sage)
    _assert_q_close(q, ref)


def test_fuse_sage_needs_empty_spill():
    # a band-local ring plus 70 long edges from distinct rows of block 0:
    # more touched rows than the first mirror capacity (64) holds, spilling
    # few enough edges (< 0.2%) that the build keeps that capacity
    rng = np.random.default_rng(2)
    src = rng.integers(0, N, 4 * N)
    dst = (src + rng.integers(1, 64, 4 * N)) % N
    long_src = np.arange(70)
    e = np.concatenate([np.stack([src, dst], 1),
                        np.stack([long_src, long_src + 600], 1)])
    tb, _, _ = build_banded_duplex(N, e, e, reorder=False, device="cpu")
    assert not tb.spill_free
    covered = ~tb.node_mask
    net = load_model(CKPT, device="cpu")
    with pytest.raises(ValueError, match="spill"):
        banded_test_forward(net, tb, covered, fuse_sage=True)
    q = banded_test_forward(net, tb, covered)
    assert torch.isfinite(q[: N]).any()
