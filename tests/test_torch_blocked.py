"""The blocked-pair kernels' plain versions and the blocked path against the
JAX package: the layout, K4 (`spmm_block`) and K5 (`sddmm_block`) against
the Pallas kernels in interpret mode (with padding slots, padded pairs and
empty destination blocks), BlockSpmm's gradients against the JAX VJP's
composition, and blocked Q and greedy dismantling against the JAX blocked
path (tests/test_blocked.py's sizes).

Tolerances: the port computes in f32; the JAX kernels gather through hi/lo
bf16 halves (~2^-16 relative error per term), so the forward is held at
atol 1e-3 and the SDDMM at 1e-2, test_pallas_spmm.py's tolerances; the
layouts and greedy removals are held exactly."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.batch import make_batch_inputs as jax_inputs  # noqa: E402
from mdcommunity_tpu.env.env import batched_reset as jax_reset  # noqa: E402
from mdcommunity_tpu.eval.metrics import dismantle_greedy as jax_dismantle  # noqa: E402
from mdcommunity_tpu.graphs.blocked import build_blocked_duplex as jax_build_blocked  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.models.net import init_params  # noqa: E402
from mdcommunity_tpu.models.net import make_blocked_aggregate as jax_blocked_agg  # noqa: E402
from mdcommunity_tpu.models.net import test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu.ops import pallas_spmm as PS  # noqa: E402
from mdcommunity_tpu_torch.env.batch import make_batch_inputs  # noqa: E402
from mdcommunity_tpu_torch.env.env import batched_reset  # noqa: E402
from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy  # noqa: E402
from mdcommunity_tpu_torch.graphs.blocked import build_blocked_duplex  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.models.net import DuplexQNet, make_blocked_aggregate  # noqa: E402
from mdcommunity_tpu_torch.models.net import test_forward as port_forward  # noqa: E402
from mdcommunity_tpu_torch.ops import blocked_kernels as bk  # noqa: E402


def _layout(n, E, S, T, seed, empty_blocks=()):
    """Random directed edges on n nodes whose destinations avoid
    `empty_blocks`; both packages' layouts of them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    keep = ~np.isin(dst // S, empty_blocks)
    src, dst = src[keep].astype(np.int32), dst[keep].astype(np.int32)
    jb, js, jd, jm = PS.build_block_coo(src, dst, n, S, T)
    tb, ts, td, tm = bk.build_block_coo(src, dst, n, S, T, device="cpu")
    return rng, (jb, js, jd, jm), (tb, ts, td, tm)


@pytest.fixture(scope="module")
def layout():
    # 4 blocks, block 1 with no incoming edges, and P padded past the real pairs
    return _layout(2048, 6000, 512, 512, 0, empty_blocks=(1,))


def test_layout_equals_jax(layout):
    _, (jb, js, jd, jm), (tb, ts, td, tm) = layout
    for name in ("rowptr", "src_blk", "dst_blk", "lsrc", "ldst"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm, jm)
    assert tb.n_pairs % 8 == 0 and int(tb.rowptr[-1]) < tb.n_pairs  # padded pairs
    rp = tb.rowptr.numpy()
    assert rp[2] == rp[1]  # destination block 1 is empty
    # K4's row lists hold every real slot once, under its destination row
    slots = tb.row_slot.numpy().astype(np.int64)
    assert sorted(slots) == sorted(np.nonzero(tm)[0])
    rows = np.repeat(np.arange(tb.n_rows), np.diff(tb.row_ptr.numpy()))
    np.testing.assert_array_equal(rows, td[slots])


@pytest.mark.parametrize("D", [64, 48])
def test_spmm_plain_matches_pallas(layout, D):
    rng, (jb, js, jd, jm), (tb, *_) = layout
    w = (rng.random(tb.n_slots).astype(np.float32) * jm).reshape(tb.n_pairs, tb.T)
    h = rng.standard_normal((tb.n_rows, D)).astype(np.float32)
    ref = np.asarray(PS.spmm_block(jb, jnp.asarray(w), jnp.asarray(h), interpret=True))
    got = bk.spmm_block(tb, torch.from_numpy(w), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert not got[512:1024].any()  # the empty destination block
    # the exact sum, in f64
    exact = np.zeros((tb.n_rows, D))
    np.add.at(exact, jd[jm], h[js[jm]].astype(np.float64) * w.reshape(-1)[jm][:, None])
    np.testing.assert_allclose(got, exact, atol=1e-5)


def test_sddmm_plain_matches_pallas_padding_included(layout):
    rng, (jb, *_), (tb, ts, td, tm) = layout
    h = rng.standard_normal((tb.n_rows, 64)).astype(np.float32)
    g = rng.standard_normal((tb.n_rows, 64)).astype(np.float32)
    ref = np.asarray(PS.sddmm_block(jb, jnp.asarray(h), jnp.asarray(g), interpret=True))
    got = bk.sddmm_block(tb, torch.from_numpy(h), torch.from_numpy(g)).numpy()
    assert got.shape == ref.shape == (tb.n_pairs, tb.T)
    # every slot: real ones, padding slots (h[src_blk·S]·g[dst_blk·S]) and
    # padded pairs (h[0]·g[0]), as the Pallas kernel gives them
    np.testing.assert_allclose(got, ref, atol=1e-2)
    pad = ~tm.reshape(tb.n_pairs, tb.T)
    assert pad.any() and np.abs(got[pad]).max() > 0
    np.testing.assert_allclose(got[-1], np.full(tb.T, h[0] @ g[0]), rtol=1e-5)


def _symmetric_problem(seed):
    N, S, T = 1024, 512, 512
    rng = np.random.default_rng(seed)
    und = np.unique(np.sort(rng.integers(0, N, (1500, 2)), axis=1), axis=0)
    und = und[und[:, 0] != und[:, 1]]
    s2 = np.concatenate([und[:, 0], und[:, 1]]).astype(np.int32)
    d2 = np.concatenate([und[:, 1], und[:, 0]]).astype(np.int32)
    jb, qs, qd, qm = PS.build_block_coo(s2, d2, N, S, T)
    tb, *_ = bk.build_block_coo(s2, d2, N, S, T, device="cpu")
    uw = rng.random(len(und)).astype(np.float32)
    wmap = {}
    for i, (a, b) in enumerate(und):
        wmap[(a, b)] = wmap[(b, a)] = uw[i]
    w = np.zeros(tb.n_slots, np.float32)
    for sl in np.nonzero(qm)[0]:
        w[sl] = wmap[(int(qs[sl]), int(qd[sl]))]
    h = rng.standard_normal((tb.n_rows, 64)).astype(np.float32)
    return jb, tb, qm, w.reshape(tb.n_pairs, T), h


def test_blockspmm_gradients_match_jax_vjp():
    """Loss Σ out²: BlockSpmm's backward (K4 on the gradient, K5) against
    the JAX VJP's composition (spmm_block + sddmm_block in interpret mode,
    pallas_spmm.py:411-416), dw on every slot, padding included."""
    jb, tb, qm, w, h = _symmetric_problem(2)
    wj, hj = jnp.asarray(w), jnp.asarray(h)
    out = PS.spmm_block(jb, wj, hj, interpret=True)
    gj = 2 * out
    dh_ref = np.asarray(PS.spmm_block(jb, wj, gj, interpret=True))
    dw_ref = np.asarray(PS.sddmm_block(jb, hj, gj, interpret=True))

    wt = torch.from_numpy(w).requires_grad_()
    ht = torch.from_numpy(h).requires_grad_()
    bk.reset_launches()
    loss = torch.sum(bk.blocked_spmm(tb, wt, ht) ** 2)
    loss.backward()
    assert bk.launches == {"spmm_block": 0, "spmm_block_bwd": 0, "sddmm_block": 0}
    np.testing.assert_allclose(ht.grad.numpy(), dh_ref, atol=2e-2)
    np.testing.assert_allclose(wt.grad.numpy(), dw_ref, atol=2e-2)
    # and autograd through a plain segment-sum operator, on the real slots
    qs = (tb.src_blk.long()[:, None] * 512 + tb.lsrc.long()).reshape(-1)
    qd = (tb.dst_blk.long()[:, None] * 512 + tb.ldst.long()).reshape(-1)
    w2 = torch.from_numpy(w).requires_grad_()
    h2 = torch.from_numpy(h).requires_grad_()
    o2 = torch.zeros_like(h2).index_add(0, qd, h2[qs] * w2.reshape(-1, 1))
    torch.sum(o2 ** 2).backward()
    np.testing.assert_allclose(ht.grad.numpy(), h2.grad.numpy(), rtol=1e-5, atol=1e-4)
    m = qm.reshape(w.shape)
    np.testing.assert_allclose(wt.grad.numpy()[m], w2.grad.numpy()[m], rtol=1e-5, atol=1e-4)


def _random_duplex(rng, n, m):
    e0 = rng.integers(0, n, (m, 2)).astype(np.int32)
    e1 = rng.integers(0, n, (m, 2)).astype(np.int32)
    e0 = e0[e0[:, 0] != e0[:, 1]]
    e1 = e1[e1[:, 0] != e1[:, 1]]
    return (np.unique(np.sort(e0, axis=1), axis=0),
            np.unique(np.sort(e1, axis=1), axis=0))


def _nets(seed):
    params = init_params(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.array, params)
    return params, DuplexQNet(tree)


def test_blocked_build_equals_jax():
    e0, e1 = _random_duplex(np.random.default_rng(0), 600, 1500)
    jbd = jax_build_blocked(600, e0, e1, S=512, T=512, reorder=True)
    tbd = build_blocked_duplex(600, e0, e1, S=512, T=512, reorder=True, device="cpu")
    np.testing.assert_array_equal(tbd.perm, jbd.perm)
    for f in ("src", "dst", "edge_mask", "node_mask", "n_nodes", "n_edges", "max_rank"):
        np.testing.assert_array_equal(getattr(tbd.g, f).numpy(), np.asarray(getattr(jbd.g, f)))


def test_blocked_q_matches_jax():
    e0, e1 = _random_duplex(np.random.default_rng(0), 600, 1500)
    params, net = _nets(0)
    jbd = jax_build_blocked(600, e0, e1, S=512, T=512, reorder=True)
    gb = jax_stack([jbd.g])
    st = jax_reset(gb)
    ji = jax_inputs(gb, st.covered, st.sever, dense=False)
    qj = np.asarray(jax_forward(params, gb, ji, aggregate_fn=jax_blocked_agg(jbd, interpret=True)))

    tbd = build_blocked_duplex(600, e0, e1, S=512, T=512, reorder=True, device="cpu")
    tg = stack_graphs([tbd.g])
    ts = batched_reset(tg)
    ti = make_batch_inputs(tg, ts.covered, ts.sever, dense=False)
    with torch.no_grad():
        qt = port_forward(net, tg, ti, aggregate_fn=make_blocked_aggregate(tbd)).numpy()
    fin = np.isfinite(qj)
    np.testing.assert_array_equal(np.isfinite(qt), fin)
    np.testing.assert_allclose(qt[fin], qj[fin], rtol=2e-3, atol=2e-4)


def test_blocked_dismantle_matches_jax():
    """The JAX blocked path's removals, and the port's segment and dense
    engines on the same ordering give the same removals too."""
    e0, e1 = _random_duplex(np.random.default_rng(1), 300, 700)
    params, net = _nets(1)
    jbd = jax_build_blocked(300, e0, e1, S=512, T=512, reorder=True)
    sol_j, score_j, curve_j = jax_dismantle(params, jbd, step=4, max_steps=24)
    tbd = build_blocked_duplex(300, e0, e1, S=512, T=512, reorder=True, device="cpu")
    stats = {}
    sol_b, score_b, curve_b = dismantle_greedy(net, tbd, step=4, max_steps=24, stats=stats)
    assert sol_b == sol_j and len(sol_b) == 24 and stats["model_calls"] == 6
    np.testing.assert_allclose(score_b, score_j, rtol=1e-6)
    np.testing.assert_allclose(curve_b, curve_j, rtol=1e-12)
    for dense in (False, True):
        sol_s, score_s, _ = dismantle_greedy(net, tbd.g, step=4, max_steps=24, dense=dense)
        assert sol_s == sol_b
        np.testing.assert_allclose(score_s, score_b, rtol=1e-6)
