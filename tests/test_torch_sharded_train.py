"""The port's gp-sharded loss, banded_train_loss(mesh=...) (every
aggregation through parallel/band_partition.ShardedBandSpmm, kernel K3 and
K3 with swapped scales), against the JAX package's banded_train_loss(
mesh=..., precise=True) on the 8-device CPU mesh.  The sharded trainer loop
is in tests/test_torch_sharded_loop.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.banded import shard_banded_duplex as jax_shard_duplex  # noqa: E402
from mdcommunity_tpu.models.net import banded_train_loss as jax_train_loss  # noqa: E402
from mdcommunity_tpu.parallel.band_partition import shard_band_vectors  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_train_loss, from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

from test_torch_sharded import CKPT  # noqa: E402
from test_torch_train import _grads  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401


def _loss_graph(n=2048):
    """Two layers of a band-local ring that differ in density and reach
    (tests/test_torch_train.py's reason: with alike layers the gate's and
    the fusion bias's gradients sit at the f32 rounding floor), plus 20 long
    edges from distinct rows of block 0: live mirror lanes, no spill."""
    rng = np.random.default_rng(5)
    layers = []
    for m, reach in ((6, 100), (1, 4)):
        src = rng.integers(0, n, m * n)
        dst = (src + rng.integers(1, reach, m * n)) % n
        layers.append(np.concatenate([np.stack([src, dst], 1),
                                      np.stack([np.arange(20), np.arange(20) + 1100], 1)]))
    jb, _, _ = jax_build(n, *layers, reorder=False)
    tb, _, _ = build_banded_duplex(n, *layers, reorder=False, device="cpu")
    assert tb.spill_free and tb.dbg0.ccoo.nnz and tb.dbg1.ccoo.nnz
    covered = (rng.random(tb.pad_n) < 0.15) | ~tb.node_mask.numpy()
    return jb, tb, covered


def test_sharded_train_loss_matches_jax():
    """gp = 2 (4 blocks a shard), 64 actions: the loss to rtol 1e-5 of the
    JAX package's sharded loss; every gradient leaf of the port's sharded
    f32 loss and of the JAX package's to 1e-4 of the leaf's max |grad| from
    the port's sharded f64 gradient (tests/test_torch_train.py's arbiter),
    but the fusion's logistic bias to 3e-4: it is a sum over all nodes of
    terms of both signs, ~1e-3 of their size, and both f32 engines land
    1.3e-4 of it from the f64 value on this graph."""
    jb, tb, covered = _loss_graph()
    rng = np.random.default_rng(4)
    acts = rng.choice(np.flatnonzero(~covered), 64, replace=False)
    tgts = (0.1 * rng.standard_normal(64) - 0.05).astype(np.float32)
    params = load_params(CKPT)
    jm = jax_mesh(dp=4, gp=2, devices=jax.devices()[:8])
    ref_loss, jax_grads = jax.jit(jax.value_and_grad(
        lambda p, b, c: jax_train_loss(p, b, c, jnp.asarray(acts), jnp.asarray(tgts),
                                       precise=True, mesh=jm)))(
        jax.tree_util.tree_map(jnp.asarray, params), jax_shard_duplex(jm, jb),
        shard_band_vectors(jm, jnp.asarray(covered)))
    mesh = make_mesh(2, "cpu")
    res = []
    for dt in (torch.float32, torch.float64):
        net = from_jax_params(params, device="cpu").to(dt).requires_grad_()
        loss = banded_train_loss(net, tb, torch.from_numpy(covered), torch.from_numpy(acts),
                                 torch.from_numpy(tgts).to(dt), mesh=mesh)
        loss.backward()
        res.append((loss.item(), _grads(net)))
    (loss, grads), (_, grads64) = res
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    flat = jax.tree_util.tree_leaves_with_path(jax_grads)
    assert len(flat) == 13
    for path, ref32 in flat:
        got, ref = grads, grads64
        for key in path:
            got, ref = got[key.key], ref[key.key]
        tol = (3e-4 if path[-1].key == "logis_b" else 1e-4) * np.abs(ref).max()
        assert tol > 0, path
        for name, g in (("port", got), ("jax", np.asarray(ref32))):
            np.testing.assert_allclose(g, ref, rtol=0, atol=tol, err_msg=f"{name} {path}")
