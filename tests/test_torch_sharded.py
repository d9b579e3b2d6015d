"""The port's gp-sharded forward (models/net.banded_test_forward(mesh=...))
against the JAX package's XLA engine net.banded_test_forward(precise=True)
and against the port's unsharded forward.  The fast sharded forward against
the JAX package's sharded packed engine, and that engine's fault the port
does not copy, are in tests/test_torch_sharded_packed.py; the sharded loss
and loop in tests/test_torch_sharded_train.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex, shard_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

CKPT = "models_tpu/unit_cost_full_r4/best_model.ckpt"
ATOL = 1e-5  # f32 on both sides; Q values are O(0.1) (tests/test_torch_forward.py)


def _graph(n, seed):
    rng = np.random.default_rng(seed)
    e0, e1 = synth_duplex_edges(n, 6, rng)
    jb, _, _ = jax_build(n, e0, e1)
    tb, _, _ = build_banded_duplex(n, e0, e1, device="cpu")
    assert tb.spill_free and tb.dbg0.C and tb.dbg1.C  # live mirror lanes
    covered = (rng.random(tb.pad_n) < 0.1) | ~tb.node_mask.numpy()
    return jb, tb, covered


@pytest.fixture(scope="module")
def net():
    return load_model(CKPT, device="cpu")


@pytest.fixture(scope="module")
def xla_forward():
    """n = 4,096 (16 blocks) and the JAX package's f32 XLA forward on it."""
    jb, tb, covered = _graph(4096, 7)
    ref = jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=True))(
        jax_load_params(CKPT), jb, jnp.asarray(covered))
    return tb, covered, np.asarray(ref)


@pytest.mark.parametrize("gp", [2, 4])
def test_sharded_precise_forward_matches_jax_and_unsharded(net, xla_forward, gp):
    """8 or 4 blocks a shard.  Against the JAX package's f32 XLA forward to
    ATOL; against the port's unsharded forward bit for bit: the sharded
    operator gives K1's bits, the dense layers run the same rows, and the
    graph-wide f64 sums round to the same f32.  A bdx sharded beforehand
    gives the same Q as one sharded on the way in."""
    tb, covered, ref = xla_forward
    cov = torch.from_numpy(covered)
    mesh = make_mesh(gp, "cpu")
    q = banded_test_forward(net, tb, cov, mesh=mesh)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(q.numpy()), fin)
    np.testing.assert_allclose(q.numpy()[fin], ref[fin], rtol=0, atol=ATOL)
    assert torch.equal(q, banded_test_forward(net, tb, cov))
    assert torch.equal(q, banded_test_forward(net, shard_banded_duplex(mesh, tb), cov))
    with pytest.raises(ValueError, match="mesh=None"):
        banded_test_forward(net, tb, cov, mesh=mesh, fuse_sage=True)


