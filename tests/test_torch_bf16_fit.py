"""The bf16 fit: the port's banded_train_loss(precise=False), whose every
aggregation is K1's bf16 mode both ways (the backward K1-bf16 with row and
col swapped, and, gp-sharded, K3's bf16 mode), against the JAX package's
banded_train_loss(precise=False) on the same weights, state, actions and
targets, through the plain versions on the CPU; and a few iterations of
train_banded_loop(precise=False), unsharded and at gp = 2.

Both packages round col ⊙ h (and row ⊙ g in the backward) to bf16 and sum
in f32, with f32 dense layers here, so they agree at f32 level: the loss to
rtol 1e-5 and each gradient leaf to 1e-4 of its max|grad|, the f32 fit's
standards (tests/test_torch_train.py).  A value within the packages' f32
difference of a bf16 rounding boundary could round to the neighbouring bf16
value in one package only; on these graphs that moves nothing past those
tolerances (the worst leaf, the fusion's logistic bias, at 4.9e-5 of its
max|grad|)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.graphs.banded import shard_banded_duplex as jax_shard_duplex  # noqa: E402
from mdcommunity_tpu.models.net import banded_train_loss as jax_train_loss  # noqa: E402
from mdcommunity_tpu.parallel.band_partition import shard_band_vectors  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_train_loss, from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.ops import band_kernels  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop  # noqa: E402

from test_torch_sharded_train import _loss_graph as _clean_graph  # noqa: E402
from test_torch_train import CKPT, _grads, _loss_graph  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of the leaf's max |grad|


def _port(params, tb, covered, acts, tgts, mesh=None):
    net = from_jax_params(params, device="cpu").requires_grad_()
    loss = banded_train_loss(net, tb, torch.from_numpy(covered), torch.from_numpy(acts),
                             torch.from_numpy(tgts), mesh=mesh, precise=False)
    loss.backward()
    return loss.item(), _grads(net)


def _compare(loss, grads, ref_loss, jax_grads):
    np.testing.assert_allclose(loss, float(ref_loss), rtol=LOSS_RTOL)
    flat = jax.tree_util.tree_leaves_with_path(jax_grads)
    assert len(flat) == 13
    for path, ref in flat:
        got, ref = grads, np.asarray(ref)
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, ref, rtol=0, atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=str(path))


def test_bf16_train_loss_matches_jax():
    """The graph of tests/test_torch_train.py (mirror lanes and spill in
    both layers), the fine-tuning checkpoint, 48 actions."""
    params = load_params(CKPT)
    jb, tb, covered, acts, tgts = _loss_graph()
    ref_loss, jax_grads = jax.jit(jax.value_and_grad(
        lambda p, b, c: jax_train_loss(p, b, c, jnp.asarray(acts), jnp.asarray(tgts),
                                       precise=False)))(
        jax.tree_util.tree_map(jnp.asarray, params), jb, jnp.asarray(covered))
    loss, grads = _port(params, tb, covered, acts, tgts)
    _compare(loss, grads, ref_loss, jax_grads)
    # the bf16 fit is another function than the precise one: its loss moves
    with torch.no_grad():
        precise = banded_train_loss(from_jax_params(params, device="cpu"), tb,
                                    torch.from_numpy(covered), torch.from_numpy(acts),
                                    torch.from_numpy(tgts), remat=False).item()
    assert abs(precise - loss) > 10 * LOSS_RTOL * abs(loss)


def test_bf16_sharded_train_loss_matches_jax():
    """gp = 2 (tests/test_torch_sharded_train.py's graph: mirror lanes, no
    spill), 64 actions, against the JAX package's sharded loss at
    precise=False on its 8-device CPU mesh; and the port's sharded bf16 loss
    against its unsharded one."""
    jb, tb, covered = _clean_graph()
    rng = np.random.default_rng(4)
    acts = rng.choice(np.flatnonzero(~covered), 64, replace=False)
    tgts = (0.1 * rng.standard_normal(64) - 0.05).astype(np.float32)
    params = load_params(CKPT)
    jm = jax_mesh(dp=4, gp=2, devices=jax.devices()[:8])
    ref_loss, jax_grads = jax.jit(jax.value_and_grad(
        lambda p, b, c: jax_train_loss(p, b, c, jnp.asarray(acts), jnp.asarray(tgts),
                                       precise=False, mesh=jm)))(
        jax.tree_util.tree_map(jnp.asarray, params), jax_shard_duplex(jm, jb),
        shard_band_vectors(jm, jnp.asarray(covered)))
    loss, grads = _port(params, tb, covered, acts, tgts, mesh=make_mesh(2, "cpu"))
    _compare(loss, grads, ref_loss, jax_grads)
    loss1, grads1 = _port(params, tb, covered, acts, tgts)
    np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)


def test_bf16_counters_are_their_own():
    for k in ("band_spmm_bf16_bwd", "band_spmm_bf16_bwd_nib", "band_halo_bf16_bwd",
              "band_halo_bf16_bwd_nib", "band_spmm_bwd", "band_halo_bwd"):
        assert k in band_kernels.launches


@pytest.mark.parametrize("gp", [None, 2])
def test_bf16_loop_runs(gp):
    """A few iterations of train_banded_loop(precise=False) on a 400-node
    graph (gp = 2: the sharded loop): every fit's loss finite, the weights
    moved, the caller's net untouched and the matmul flags as they were."""
    n = 400
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    banded, _, (o0, o1) = build_banded_duplex(n, e0, e1, device="cpu")
    assert banded.spill_free  # the sharded loop refuses spill
    env = make_host_env(n, o0, o1, engine="native")
    net = from_jax_params(load_params(CKPT), device="cpu")
    flags = torch.backends.cuda.matmul.allow_tf32
    net2, hist = train_banded_loop(net, banded, env, iters=4, k=16, precise=False,
                                   mesh=None if gp is None else make_mesh(gp, "cpu"),
                                   log=lambda *a, **k: None)
    rows = [h for h in hist if "loss" in h]
    assert len(rows) == 4
    full = [h for h in rows if h["removed"] == 16]
    assert full and all(np.isfinite(h["loss"]) for h in full)
    assert sum(float((a - b.detach()).abs().sum())
               for a, b in zip(net.parameters(), net2.parameters())) > 0
    assert not any(p.requires_grad for p in net.parameters())
    assert torch.backends.cuda.matmul.allow_tf32 == flags
