"""The port's differentiable band operator (BandSpmm) and training loss vs the
JAX package: the operator's input gradient against both JAX VJPs (the XLA
engine's custom VJP and the Pallas kernel's, interpret mode), a
finite-difference check in f64, and banded_train_loss's value and every
parameter gradient against the JAX package's banded_train_loss on the same
weights, state, actions and targets.  The backward tests scale rows and
columns differently (row ≠ col), so a backward that forgot to swap them
fails.  CPU: the port's wrappers run their plain versions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.cli import _load_params as jax_load_params  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.models.net import banded_train_loss as jax_train_loss  # noqa: E402
from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu.ops.band_pallas import pack_band, pack_rows, spmm_band_packed, unpack_rows  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_params, save_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import (  # noqa: E402
    banded_train_loss,
    from_jax_params,
    init_params,
    to_jax_params,
)
from mdcommunity_tpu_torch.ops import dense_band as tdb  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r4/best_model.ckpt"
N, S, B = 2048, 512, 128


def _ring(rng, n, e, scale):
    src = rng.integers(0, n, e)
    off = np.minimum((scale * (rng.pareto(2.0, e) + 1)).astype(np.int64), n // 2 - 1)
    dst = (src + off * rng.choice([-1, 1], e)) % n
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def _scales(jg, rng):
    """JAX live_scales 'mean': row = live/live_deg, col = live (row ≠ col)."""
    covered = jnp.asarray(rng.random(jg.pad_n) < 0.1)
    row, col = jdb.live_scales(jg, covered, "mean")
    row, col = np.asarray(row), np.asarray(col)
    assert not np.array_equal(row, col)
    return row, col


def _input_grad(tg, row, col, h, g):
    ht = torch.from_numpy(h).requires_grad_()
    out = tdb.spmm_dense_band_grad(tg, torch.from_numpy(row), torch.from_numpy(col), ht)
    (dh,) = torch.autograd.grad(out, ht, torch.from_numpy(g))
    return out.detach().numpy(), dh.numpy()


def test_band_spmm_grad_matches_jax_vjp():
    """Mirror lanes and spill both present; tolerance 1e-5 of max |grad|
    (f32 on both sides, sums in another order)."""
    rng = np.random.default_rng(0)
    ss, dd = _ring(rng, N, 2 * N, 24.0)
    jg = jdb.build_dense_band(ss, dd, None, N, S=S, B=B, max_mirror=16)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=16, device="cpu")
    assert tg.C and tg.ccoo.nnz and tg.spill.nnz
    row, col = _scales(jg, rng)
    h = rng.standard_normal((tg.pad_n, 64)).astype(np.float32)
    g = rng.standard_normal((tg.pad_n, 64)).astype(np.float32)
    ref_out, vjp = jax.vjp(
        lambda x: jdb.spmm_dense_band(jg, jnp.asarray(row), jnp.asarray(col), x,
                                      precise=True), jnp.asarray(h))
    (ref,) = vjp(jnp.asarray(g))
    out, dh = _input_grad(tg, row, col, h, g)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=0,
                               atol=1e-5 * np.abs(ref_out).max())
    np.testing.assert_allclose(dh, ref, rtol=0, atol=1e-5 * scale)
    # the swap matters here: the unswapped operator is far off
    _, wrong = _input_grad(tg, col, row, h, g)
    assert np.abs(wrong - ref).max() > 1e-2 * scale


def test_band_spmm_grad_matches_pallas_vjp():
    """Against jax.grad through the Pallas kernel K1 (spmm_band_packed,
    interpret mode), on tests/test_band_pallas.py's VJP graph and at its
    tolerance, with row ≠ col."""
    rng = np.random.default_rng(0)
    n, e = 2048, 4096
    ss, dd = _ring(rng, n, e, 24.0)
    jg = jdb.build_dense_band(ss, dd, None, n, S=S, B=B, dtype=jnp.int8)
    tg = tdb.build_dense_band(ss, dd, n, S=S, B=B, device="cpu")
    assert tg.ccoo.nnz
    pk = pack_band(jg)
    row, col = _scales(jg, rng)
    h = rng.standard_normal((jg.pad_n, 64)).astype(np.float32)
    g_pk = jax.grad(lambda x2: jnp.sum(jnp.square(spmm_band_packed(
        pk, jg, jnp.asarray(row), jnp.asarray(col), x2, True, precise=True))))(
        pack_rows(jnp.asarray(h)))
    ref = np.asarray(unpack_rows(g_pk))
    ht = torch.from_numpy(h).requires_grad_()
    out = tdb.spmm_dense_band_grad(tg, torch.from_numpy(row), torch.from_numpy(col), ht)
    (dh,) = torch.autograd.grad(torch.sum(torch.square(out)), ht)
    np.testing.assert_allclose(dh.numpy(), ref, rtol=3e-2,
                               atol=3e-2 * np.abs(ref).max())


def test_band_spmm_gradcheck_f64():
    """Finite differences in f64 on a tiny graph with mirror lanes and
    spill, independent random row and col scales."""
    rng = np.random.default_rng(3)
    n = 96
    ss, dd = _ring(rng, n, 3 * n, 6.0)
    tg = tdb.build_dense_band(ss, dd, n, S=16, B=8, max_mirror=2, device="cpu")
    assert tg.ccoo.nnz and tg.spill.nnz
    row = torch.from_numpy(rng.random(tg.pad_n) + 0.5)
    col = torch.from_numpy(rng.random(tg.pad_n) + 0.5)
    h = torch.from_numpy(rng.standard_normal((tg.pad_n, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: tdb.spmm_dense_band_grad(tg, row, col, x), (h,))


def test_band_spmm_refuses_scale_grads_and_edits():
    rng = np.random.default_rng(4)
    ss, dd = _ring(rng, N, 2 * N, 96.0)
    tg = tdb.build_dense_band(ss, dd, N, S=S, B=B, max_mirror=4, device="cpu")
    ones = torch.ones(tg.pad_n)
    h = torch.randn(tg.pad_n, 8, requires_grad=True)
    with pytest.raises(ValueError, match="in h only"):
        tdb.spmm_dense_band_grad(tg, ones.clone().requires_grad_(), ones, h)
    out = tdb.spmm_dense_band_grad(tg, ones, ones, h)
    tdb.sever_edges(tg, torch.from_numpy(ss[:4]), torch.from_numpy(dd[:4]),
                    torch.ones(4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="edited"):
        out.sum().backward()


# ---------------------------------------------------------------- the loss


def _loss_graph():
    """Two layers of a band-local ring plus 70 long edges from distinct rows
    of block 0: more touched rows than the first mirror capacity holds, so
    both mirror lanes and (under 0.2% of edges) spill.  The layers differ in
    density and reach, so their virtual nodes differ: with alike layers the
    gate's and the fusion bias's gradients are differences of near-equal
    terms, left at the f32 rounding floor in both engines."""
    rng = np.random.default_rng(5)
    layers = []
    for m, reach in ((6, 128), (1, 4)):
        src = rng.integers(0, N, m * N)
        dst = (src + rng.integers(1, reach, m * N)) % N
        layers.append(np.concatenate([np.stack([src, dst], 1),
                                      np.stack([np.arange(70), np.arange(70) + 1100], 1)]))
    jb, _, _ = jax_build(N, layers[0], layers[1], S=S, B=B, reorder=False)
    tb, _, _ = build_banded_duplex(N, layers[0], layers[1], S=S, B=B,
                                   reorder=False, device="cpu")
    for layer in range(2):
        assert tb.dbg(layer).C and tb.dbg(layer).ccoo.nnz and tb.dbg(layer).spill.nnz
    covered = (rng.random(tb.pad_n) < 0.15) | ~tb.node_mask.numpy()
    live = np.flatnonzero(~covered)
    acts = rng.choice(live, 48, replace=False)
    tgts = (0.1 * rng.standard_normal(48) - 0.05).astype(np.float32)
    return jb, tb, covered, acts, tgts


@pytest.fixture(scope="module")
def loss_setup():
    params = load_params(CKPT)
    return (params,) + _loss_graph()


def _port_loss(params, tb, covered, acts, tgts, remat, dtype=torch.float32):
    net = from_jax_params(params, device="cpu").to(dtype).requires_grad_()
    loss = banded_train_loss(net, tb, torch.from_numpy(covered),
                             torch.from_numpy(acts), torch.from_numpy(tgts).to(dtype),
                             remat=remat)
    loss.backward()
    return loss.item(), _grads(net)


def _grads(net):
    grads = {k: p.grad.numpy() for k, p in net.named_parameters() if "." not in k}
    grads["fusion"] = {k: p.grad.numpy() for k, p in net.fusion.items()}
    return grads


def test_train_loss_matches_jax(loss_setup):
    """The loss to rtol 1e-5 of JAX's; every gradient leaf of both f32
    engines to 1e-4 of the leaf's max |grad| from the port's f64 gradient
    (the same code in f64 on the CPU).  The f64 gradient is the arbiter
    because one leaf, the fusion's logistic bias, is a difference of
    near-equal terms (σ' of two close logits): each f32 engine lands about
    5e-5 of it from the f64 value, on opposite sides."""
    params, jb, tb, covered, acts, tgts = loss_setup
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ref_loss, jax_grads = jax.value_and_grad(
        lambda p: jax_train_loss(p, jb, jnp.asarray(covered), jnp.asarray(acts),
                                 jnp.asarray(tgts), precise=True))(jparams)
    loss, grads = _port_loss(params, tb, covered, acts, tgts, remat=True)
    _, grads64 = _port_loss(params, tb, covered, acts, tgts, remat=False,
                            dtype=torch.float64)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    flat = jax.tree_util.tree_leaves_with_path(jax_grads)
    assert len(flat) == 13
    for path, ref32 in flat:
        got, ref = grads, grads64
        for key in path:
            got, ref = got[key.key], ref[key.key]
        tol = 1e-4 * np.abs(ref).max()
        assert tol > 0, path
        for name, g in (("port", got), ("jax", np.asarray(ref32))):
            np.testing.assert_allclose(g, ref, rtol=0, atol=tol,
                                       err_msg=f"{name} {path}")


def test_remat_equals_no_remat(loss_setup):
    params, _, tb, covered, acts, tgts = loss_setup
    loss_r, g_r = _port_loss(params, tb, covered, acts, tgts, remat=True)
    loss_n, g_n = _port_loss(params, tb, covered, acts, tgts, remat=False)
    assert loss_r == loss_n
    for (_, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(g_r), jax.tree_util.tree_leaves_with_path(g_n)
    ):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_backward_refuses_edited_operands(loss_setup, remat):
    """A sever between the loss and its backward raises (with remat the
    recomputed forward would otherwise read the edited band)."""
    params, _, _, covered, acts, tgts = loss_setup
    tb = _loss_graph()[1]
    net = from_jax_params(params, device="cpu").requires_grad_()
    loss = banded_train_loss(net, tb, torch.from_numpy(covered),
                             torch.from_numpy(acts), torch.from_numpy(tgts),
                             remat=remat)
    e = torch.tensor([[0, 1]])
    apply_severs(tb, 1, e[:, 0], e[:, 1], torch.ones(1, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="edited"):
        loss.backward()


def test_params_round_trip(tmp_path):
    """to_jax_params inverts from_jax_params; save_params writes a file
    that load_params and the JAX package's loader read back."""
    params = load_params(CKPT)
    net = from_jax_params(params, device="cpu")
    tree = to_jax_params(net)
    path = str(tmp_path / "w.ckpt")
    save_params(path, net)
    for other in (load_params(path), jax_load_params(path)):
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = jax.tree_util.tree_leaves_with_path(other)
        flat_c = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b] == [p for p, _ in flat_c]
        for (_, a), (_, b), (_, c) in zip(flat_a, flat_b, flat_c):
            assert np.asarray(b).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(b), a)
            np.testing.assert_array_equal(c, a)


def test_init_params_shapes():
    """init_params gives the JAX package's tree: same keys, shapes and
    parameter count, fmod-bounded dense weights."""
    from mdcommunity_tpu.models.net import init_params as jax_init

    ref = jax_init(jax.random.PRNGKey(0))
    ours = init_params(torch.Generator().manual_seed(0))
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    flat_o = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in flat_r] == [p for p, _ in flat_o]
    for (_, r), (_, o) in zip(flat_r, flat_o):
        assert o.shape == r.shape and o.dtype == np.float32
    assert sum(o.size for _, o in flat_o) == 31205
    assert np.abs(ours["p_node_conv"]).max() < 2.0
    np.testing.assert_array_equal(ours["fusion"]["trans"], np.eye(64))
