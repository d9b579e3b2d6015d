"""The port's banded SpMM (ops/band_spmm.py) and the dual-sorted COO's
backward (ops/spmm_csr.py) against the JAX package: the band build, the
band weights and live mask, spmm_band's forward and the gradients of the
band weights, the overflow weights and h against jax.grad of the JAX
package's spmm_band (its custom VJP), with and without overflow."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.ops import band_spmm as jbs  # noqa: E402
from mdcommunity_tpu.ops import spmm_csr as jcsr  # noqa: E402
from mdcommunity_tpu_torch.ops import band_spmm as tbs  # noqa: E402
from mdcommunity_tpu_torch.ops import spmm_csr as tcsr  # noqa: E402

TOL = 1e-5  # of max|ref|: f32 block products summed in another order


def _graph(rng, n, e, spread, n_far):
    """A symmetric graph (both orientations, equal weights, as the VJP
    assumes): edges mostly within ±spread of the diagonal, n_far uniform
    long-range ones (the overflow)."""
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-spread, spread + 1, e), 0, n - 1)
    if n_far:
        src = np.concatenate([src, rng.integers(0, n, n_far)])
        dst = np.concatenate([dst, rng.integers(0, n, n_far)])
    w = rng.random(len(src)).astype(np.float32)
    return (np.concatenate([src, dst]), np.concatenate([dst, src]),
            np.concatenate([w, w]))


def _both(src, dst, w, n, S, B):
    jbg, jrow, jcol, jin = jbs.build_band(src, dst, n, S=S, B=B)
    tbg, trow, tcol, tin = tbs.build_band(src, dst, n, S=S, B=B, device="cpu")
    order = np.argsort(dst[~jin], kind="stable")
    w_ov = w[~jin][order]
    return (jbg, jbs.band_weights(jbg, jrow, jcol, w[jin]), w_ov,
            tbg, tbs.band_weights(tbg, trow, tcol, w[tin]), (jrow, jcol, jin, trow, tcol, tin))


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)
    assert err <= TOL * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


@pytest.mark.parametrize("S,B", [(128, 64), (256, 128), (512, 256)])
def test_build_band_weights_and_live_mask_equal(S, B):
    rng = np.random.default_rng(S)
    n = 3 * S - 5
    src, dst, w = _graph(rng, n, 4 * n, B + 8, 40)
    jbg, jwb, _, tbg, twb, (jrow, jcol, jin, trow, tcol, tin) = _both(src, dst, w, n, S, B)
    assert (tbg.n, tbg.S, tbg.B, tbg.Wb, tbg.pad_n) == (jbg.n, jbg.S, jbg.B, jbg.Wb, jbg.pad_n)
    assert np.array_equal(trow, jrow) and np.array_equal(tcol, jcol)
    assert np.array_equal(tin, jin) and (~tin).sum() > 0
    for f in ("d_src", "d_dst", "s_src", "s_dst", "s2d"):
        assert np.array_equal(getattr(tbg.overflow, f).numpy(),
                              np.asarray(getattr(jbg.overflow, f))), f
    assert tbg.overflow.n == jbg.overflow.n
    assert twb.dtype == torch.float32 and np.array_equal(twb.numpy(), jwb)
    covered = rng.random(tbg.pad_n) < 0.2
    covered[n:] = True
    want = np.asarray(jbs.band_live_mask(jbg, jnp.asarray(covered)))
    assert np.array_equal(tbs.band_live_mask(tbg, torch.from_numpy(covered)).numpy(), want)


@pytest.mark.parametrize("S,B", [(128, 64), (256, 128), (512, 256)])
@pytest.mark.parametrize("D", [2, 64])
@pytest.mark.parametrize("overflow", [True, False])
def test_spmm_band_forward_and_grads_equal_jax(S, B, D, overflow):
    rng = np.random.default_rng(S + D + overflow)
    n = 3 * S - 7
    src, dst, w = _graph(rng, n, 4 * n, B - 3, 50 if overflow else 0)
    jbg, jwb, w_ov, tbg, twb, _ = _both(src, dst, w, n, S, B)
    assert (tbg.overflow.nnz > 0) == overflow
    h = rng.standard_normal((tbg.pad_n, D)).astype(np.float32)
    ct = rng.standard_normal((tbg.pad_n, D)).astype(np.float32)

    def loss(wb, wo, hh):
        out = jbs.spmm_band(jbg, wb, wo, hh)
        return jnp.sum(out * ct), out

    args = (jnp.asarray(jwb), jnp.asarray(w_ov), jnp.asarray(h))
    jgrads, want = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)

    twb = twb.clone().requires_grad_()
    tov = torch.from_numpy(w_ov).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    out = tbs.spmm_band(tbg, twb, tov, th)
    _close(out.detach().numpy(), want, "forward")
    tgrads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (twb, tov, th))
    for name, g, jg in zip(("wb", "w_ov", "h"), tgrads, jgrads):
        assert g.shape == tuple(jg.shape), name
        _close(g.numpy(), jg, name)


def test_spmm_sorted_backward_equals_jax_vjp():
    """dh by the source-order segment sum, dw by the per-edge dot, against
    the JAX package's custom VJP; the forward's bits are those of the
    forward without autograd."""
    rng = np.random.default_rng(3)
    n, e, D = 97, 600, 24
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    src[:5] = dst[:5] = 0  # repeated edges and self loops
    jcoo = jcsr.build_sorted_coo(src, dst, n)
    tcoo = tcsr.build_sorted_coo(src, dst, n, "cpu")
    for f in ("d_src", "d_dst", "s_src", "s_dst", "s2d"):
        assert np.array_equal(getattr(tcoo, f).numpy(), np.asarray(getattr(jcoo, f))), f
    w = rng.random(e).astype(np.float32)
    h = rng.standard_normal((n, D)).astype(np.float32)
    g = rng.standard_normal((n, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda ww, hh: jcsr.spmm_sorted(jcoo, ww, hh), jnp.asarray(w),
                        jnp.asarray(h))
    jdw, jdh = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    out = tcsr.spmm_sorted(tcoo, tw, th)
    plain = tcsr.spmm_sorted(tcoo, tw.detach(), th.detach())
    assert torch.equal(out.detach(), plain)
    _close(out.detach().numpy(), want, "forward")
    dw, dh = torch.autograd.grad(out, (tw, th), torch.from_numpy(g))
    _close(dw.numpy(), jdw, "dw")
    _close(dh.numpy(), jdh, "dh")
    # an empty COO: zeros of the output shape, and zero gradients
    empty = tcsr.build_sorted_coo(np.zeros(0), np.zeros(0), n, "cpu")
    th0 = torch.from_numpy(h).requires_grad_()
    out0 = tcsr.spmm_sorted(empty, torch.zeros(0), th0)
    assert out0.shape == (n, D) and not out0.abs().max()
    (dh0,) = torch.autograd.grad(out0.sum(), th0)
    assert dh0.shape == (n, D) and not dh0.abs().max()
