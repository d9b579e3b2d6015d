"""The HCA model against the JAX package, with the JAX parameters carried
across (from_jax_params): the dense forward (B = 2, with and without
ref_quirks) and its Laplacian term, the banded forward on the intact state
and mid-dismantling (the cases of tests/test_hca_banded.py), the community
pass's chunked K1 form at c_pad = 512, and the committed HCA checkpoint through
load_model against the JAX predict_q.

Q is compared in two parts.  Nodes selected by the decoder carry Q of order
1; both packages compute them in f32, held to 1e-5 of their max|Q| (the
sums run in other orders).  Unselected nodes sit at -1e9·w (w the layer
gate), where the f32 spacing is 32-64; their value is the gate's, whose
softmax logits are 128-term sums (of order 10 with the trained weights),
so f32 sums in another order move it by up to ~1e-5 relative: held to
2e-5 relative, and both packages must agree which nodes are unselected."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.graphs.banded import apply_severs as jax_apply_severs  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges  # noqa: E402
from mdcommunity_tpu.graphs.io import duplex_from_layers as jax_duplex  # noqa: E402
from mdcommunity_tpu.models import hca as jax_hca  # noqa: E402
from mdcommunity_tpu.models import hca_banded as jax_hca_banded  # noqa: E402
from mdcommunity_tpu.rl.dqn import predict_q as jax_predict_q  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers  # noqa: E402
from mdcommunity_tpu_torch.models import hca  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.hca_banded import (  # noqa: E402
    banded_hca_forward,
    make_hca_band_data,
)
from mdcommunity_tpu_torch.models.net import from_jax_params, to_jax_params  # noqa: E402
from mdcommunity_tpu_torch.rl.dqn import predict_q  # noqa: E402

HCA_CKPT = "models_tpu/hca_100k_r5/best_model.ckpt"
SENTINEL = -1e8  # below: an unselected node's -1e9·w
_jax_banded = jax.jit(jax_hca_banded.banded_hca_forward, static_argnames=("precise",))


def assert_hca_q(got, ref):
    """got and ref agree: the same -inf and unselected nodes, selected Q to
    1e-5 of its max|Q|, unselected to 2e-5 relative."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    sel = fin & (ref > SENTINEL)
    np.testing.assert_array_equal(fin & (got > SENTINEL), sel)
    assert sel.any()
    scale = np.abs(ref[sel]).max()
    np.testing.assert_allclose(got[sel], ref[sel], rtol=0, atol=1e-5 * scale)
    low = fin & ~sel
    np.testing.assert_allclose(got[low], ref[low], rtol=2e-5)


@pytest.fixture(scope="module")
def setup():
    n = 180
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(11))
    params = jax.tree_util.tree_map(np.asarray, jax_hca.init_hca_params(jax.random.PRNGKey(3)))
    return n, e0, e1, params, from_jax_params(params, device="cpu")


def test_params_round_trip(setup):
    """from_jax_params gives an HcaQNet, to_jax_params its tree back."""
    params, net = setup[3], setup[4]
    assert isinstance(net, hca.HcaQNet)
    back = to_jax_params(net)
    assert set(back) == set(params)
    for k in hca.HCA_HEADS + ("w_n2l",):
        np.testing.assert_array_equal(back[k], params[k])


@pytest.mark.parametrize("ref_quirks", [False, True])
def test_dense_forward_and_laplacian(setup, ref_quirks):
    """B = 2, one graph intact and one mid-dismantling (covered nodes and
    severed edges); Q, the fused embeddings and the Laplacian term."""
    n, e0, e1, params, net = setup
    jg = jax_duplex(n, e0, e1, hca=True)
    tg = duplex_from_layers(n, e0, e1, hca=True, device="cpu")
    rng = np.random.default_rng(2)
    cov = np.zeros((2, jg.pad_n), bool)
    cov[1, rng.choice(n, 30, replace=False)] = True
    sev = np.zeros((2, 2, jg.pad_e), bool)
    sev[1, :, rng.choice(2 * len(e0), 10, replace=False)] = True
    ji = jax.jit(jax_hca.make_hca_inputs, static_argnames=("c_pad",))(
        jax_stack([jg, jg]), jnp.asarray(cov), jnp.asarray(sev), c_pad=jg.pad_n)
    qj, hj = jax.jit(jax_hca.hca_forward, static_argnames=("ref_quirks",))(
        params, jax_stack([jg, jg]), ji, ref_quirks=ref_quirks)
    ti = hca.make_hca_inputs(stack_graphs([tg, tg]), torch.from_numpy(cov),
                             torch.from_numpy(sev), tg.pad_n)
    for name in ("member", "comm_adj", "comm_real", "node_input", "deg", "n_dir_live"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)),
                                      err_msg=name)
    qt, ht = hca.hca_forward(net, ti, ref_quirks=ref_quirks)
    for b in range(2):
        assert_hca_q(qt[b].numpy(), np.asarray(qj)[b])
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(hca.hca_laplacian(ht, ti)),
                               float(jax_hca.hca_laplacian(hj, None, ji)), rtol=1e-5)


@pytest.fixture(scope="module")
def banded(setup):
    n, e0, e1, params, net = setup
    jg = jax_duplex(n, e0, e1, hca=True)
    jb, perm, _ = jax_build(n, e0, e1, S=64, B=32)
    tb, tperm, _ = build_banded_duplex(n, e0, e1, S=64, B=32, device="cpu")
    np.testing.assert_array_equal(perm, tperm)
    args = (np.asarray(jg.comm_id)[:, :n], np.asarray(jg.n_comms),
            np.asarray(jg.hca_feat)[:n], perm, tb.pad_n)
    return jg, jb, tb, perm, jax_hca_banded.make_hca_band_data(*args), args


def _covered(pad_n, n, idx=()):
    c = np.zeros(pad_n, bool)
    c[n:] = True
    c[list(idx)] = True
    return c


def test_banded_intact(setup, banded):
    """The banded forward at the intact state, against the JAX banded
    forward (the same banded order) and against the port's dense forward
    (the banded order unwound)."""
    n, e0, e1, params, net = setup
    jg, jb, tb, perm, jhd, args = banded
    hd = make_hca_band_data(*args, device="cpu")
    cov = _covered(tb.pad_n, n)
    q = banded_hca_forward(net, tb, hd, torch.from_numpy(cov)).numpy()
    assert_hca_q(q, np.asarray(_jax_banded(params, jb, jhd, jnp.asarray(cov), precise=True)))
    tg = duplex_from_layers(n, e0, e1, hca=True, device="cpu")
    gb = stack_graphs([tg])
    dense = hca.hca_forward(net, hca.make_hca_inputs(
        gb, torch.zeros(1, tg.pad_n, dtype=torch.bool),
        torch.zeros(1, 2, tg.pad_e, dtype=torch.bool), hd.c_pad))[0][0].numpy()
    assert_hca_q(q[:n], dense[perm])


@pytest.mark.parametrize("c_pad", [None, 512])
def test_banded_mid_dismantling(setup, banded, c_pad):
    """Covered nodes and severed edges (the band's in-place edits against
    the JAX package's); c_pad = 512 runs the community tables 512 wide
    and must give the same Q."""
    n, e0, e1, params, net = setup
    jg, jb, tb0, perm, jhd, args = banded
    tb = build_banded_duplex(n, e0, e1, S=64, B=32, device="cpu")[0]
    hd = make_hca_band_data(*args, c_pad=c_pad, device="cpu")
    rng = np.random.default_rng(5)
    removed = rng.choice(n, size=25, replace=False)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    covered = np.zeros(n, bool)
    covered[removed] = True
    for layer, edges in enumerate((e0, e1)):
        alive = [i for i, (u, v) in enumerate(edges) if not (covered[u] or covered[v])]
        pick = rng.choice(alive, size=min(8, len(alive)), replace=False)
        s, d = inv[edges[pick, 0]], inv[edges[pick, 1]]
        jb = jax_apply_severs(jb, layer, jnp.asarray(s.astype(np.int32)),
                              jnp.asarray(d.astype(np.int32)), jnp.ones(len(pick), bool))
        apply_severs(tb, layer, torch.from_numpy(s), torch.from_numpy(d),
                     torch.ones(len(pick), dtype=torch.bool))
    cov = _covered(tb.pad_n, n, inv[removed])
    ref = np.asarray(_jax_banded(params, jb, jhd, jnp.asarray(cov), precise=True))
    q = banded_hca_forward(net, tb, hd, torch.from_numpy(cov)).numpy()
    assert_hca_q(q, ref)


def test_community_graph_is_exact(setup, banded):
    """The community pass's K1 form (community_graph, the check of
    ops/hca_kernels.comm_adj) at c_pad = 512 (two K1 chunks of 256 columns):
    integer counts equal to the live inter-community edges counted one by
    one, and the same table as at the default c_pad where both have
    rows."""
    from mdcommunity_tpu_torch.models.hca_banded import community_graph

    n, e0, e1, params, net = setup
    tb, perm, args = banded[2], banded[3], banded[5]
    hd = make_hca_band_data(*args, c_pad=512, device="cpu")
    live = (~torch.from_numpy(_covered(tb.pad_n, n))).float()
    a = community_graph(tb, hd, 0, live)
    cid = hd.comm_id[0].numpy()
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ref = np.zeros((512, 512))
    for u, v in e0:
        ref[cid[inv[u]], cid[inv[v]]] += 1
        ref[cid[inv[v]], cid[inv[u]]] += 1
    np.testing.assert_array_equal(a.numpy(), ref)
    small = make_hca_band_data(*args, device="cpu")
    c = small.c_pad
    np.testing.assert_array_equal(community_graph(tb, small, 0, live).numpy(), ref[:c, :c])


def test_init_hca_params_shapes():
    """init_hca_params gives the JAX package's tree shapes and an HcaQNet."""
    tree = hca.init_hca_params(torch.Generator().manual_seed(0))
    ref = jax_hca.init_hca_params(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        got = tree[keys[0]] if len(keys) == 1 else tree[keys[0]][keys[1]]
        assert np.shape(got) == np.shape(leaf), keys
    assert isinstance(from_jax_params(tree, device="cpu"), hca.HcaQNet)


def test_checkpoint_predict_q_matches_jax():
    """The committed HCA checkpoint through load_model (no jax, no
    networkx in the port) against the JAX predict_q on a 40-node graph, at
    the intact state and after removals."""
    n = 40
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(21))
    params = load_params(HCA_CKPT)
    net = load_model(HCA_CKPT, device="cpu")
    assert isinstance(net, hca.HcaQNet) and net.w_n2l.shape == (3, 64)
    jg = jax_stack([jax_duplex(n, e0, e1, pad_nodes=64, pad_edges=1024, hca=True)])
    tg = stack_graphs([duplex_from_layers(n, e0, e1, pad_nodes=64, pad_edges=1024, hca=True,
                                          device="cpu")])
    cov = np.zeros((1, 64), bool)
    for removed in ((), (3, 17, 29)):
        cov[0, list(removed)] = True
        sev = np.zeros((1, 2, 1024), bool)
        ref = jax_predict_q(params, jg, jnp.asarray(cov), jnp.asarray(sev), "hca")
        got = predict_q(net, tg, torch.from_numpy(cov), torch.from_numpy(sev), "hca")
        assert_hca_q(got[0].numpy(), np.asarray(ref)[0])
