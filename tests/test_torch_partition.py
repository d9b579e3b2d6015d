"""The port's edge-partitioned aggregation (parallel/partition.py) against the
JAX package's shard_map version on its 8-device CPU mesh, at gp = 2 and 8:
the replicated output and the gradients of h and w, with E padded to a
multiple of gp by w = 0 edges."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.parallel import partition as jpart  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch.ops.aggregate import spmm_coo  # noqa: E402
from mdcommunity_tpu_torch.parallel import partition as tpart  # noqa: E402
from mdcommunity_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6  # of max|ref|: f32 partial sums added in another order


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= TOL * np.abs(want).max(), (what, err)


def _inputs(gp, n=300, e=2500, D=32, seed=0):
    rng = np.random.default_rng(seed + gp)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    pad = -e % gp  # padding edges: node 0 to node 0, weight 0
    src, dst = (np.concatenate([x, np.zeros(pad, np.int64)]) for x in (src, dst))
    w = np.concatenate([w, np.zeros(pad, np.float32)])
    assert pad or gp == 2
    h = rng.standard_normal((n, D)).astype(np.float32)
    ct = rng.standard_normal((n, D)).astype(np.float32)
    return src, dst, w, h, ct


@pytest.mark.parametrize("gp", [2, 8])
def test_edge_partitioned_spmm_and_grads_equal_jax(gp):
    src, dst, w, h, ct = _inputs(gp)
    mesh = jax_mesh(dp=1, gp=gp, devices=jax.devices()[:gp])

    def loss(ww, hh):
        out = jpart.spmm_edge_partitioned(mesh, jnp.asarray(src, jnp.int32),
                                          jnp.asarray(dst, jnp.int32), ww, hh)
        return jnp.sum(out * ct), out

    with mesh:
        (jdw, jdh), want = jax.grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(w), jnp.asarray(h))

    tmesh = make_mesh(gp, "cpu")
    tw = torch.from_numpy(w).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    outs = tpart.spmm_edge_partitioned(tmesh, torch.from_numpy(src), torch.from_numpy(dst),
                                       tw, th)
    assert len(outs) == gp and all(o is outs[0] for o in outs)  # one device, one tensor
    _close(outs[0].detach().numpy(), want, "forward")
    dw, dh = torch.autograd.grad((outs[0] * torch.from_numpy(ct)).sum(), (tw, th))
    _close(dw.numpy(), jdw, "dw")
    _close(dh.numpy(), jdh, "dh")

    # the pre-sharded form, and the unsharded segment sum, give the same
    parts = tpart.shard_edges(tmesh, torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(w))
    assert [len(p) for p in parts] == [gp] * 3
    again = tpart.spmm_edge_partitioned(tmesh, *parts, torch.from_numpy(h))[0]
    assert torch.equal(again, outs[0].detach())
    whole = spmm_coo(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                     torch.from_numpy(h), h.shape[0])
    _close(again.numpy(), whole.numpy(), "unsharded")


def test_shard_edges_needs_a_multiple_of_gp():
    mesh = make_mesh(3, "cpu")
    x = torch.zeros(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="pad"):
        tpart.shard_edges(mesh, x, x, torch.zeros(10))


def test_spmm_coo_and_param_count_equal_jax():
    """The two API names of this slice: ops/aggregate.spmm_coo (the segment
    SpMM) and models/net.param_count."""
    from mdcommunity_tpu.models.net import param_count as jax_count
    from mdcommunity_tpu.ops.aggregate import spmm_coo as jax_spmm_coo
    from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params
    from mdcommunity_tpu_torch.models.net import param_count

    src, dst, w, h, _ = _inputs(2)
    want = jax_spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(h),
                        h.shape[0])
    got = spmm_coo(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                   torch.from_numpy(h), h.shape[0])
    _close(got.numpy(), want, "spmm_coo")
    path = os.path.join(REPO, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
    assert param_count(load_model(path, device="cpu")) == jax_count(load_params(path))
