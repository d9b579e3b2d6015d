"""The degree-cost, CE and HCA variants' large-graph dismantling against
the JAX package: evaluate_real's banded path (blocked_threshold=0, one host
cascade a batch) with each committed *_100k_r5 checkpoint, the port's own
rollout held to the JAX banded forward through its shadow
(tests/variant_cases.py), and banded_test_forward(variant=) for degree
cost and CE against the JAX package's, unfused and fused."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import (  # noqa: E402
    N,
    STEP_RATIO,
    JaxShadow,
    ckpt,
    hold,
    load_kw,
    write_graph,
)

from mdcommunity_tpu.eval.real import evaluate_real as jax_evaluate_real  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.io import load_real_duplex as jax_load  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_fwd  # noqa: E402
from mdcommunity_tpu_torch.eval.real import evaluate_real  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_graph(str(tmp_path_factory.mktemp("variants")))


@pytest.mark.parametrize("variant", ["degree_cost", "ce", "hca"])
def test_evaluate_real_banded_path(data, variant, tmp_path):
    """blocked_threshold=0: the banded forward (K1 and K2 for degree cost
    and CE, banded_hca_forward for HCA) with the host env, one cascade a
    batch; the port's own rollout is held to the JAX forward through its
    shadow."""
    path = os.path.join(data, "g.edges")
    step = max(int(STEP_RATIO * N), 1)
    kw = dict(n_nodes=N, layers=(1, 2), step_ratio=STEP_RATIO, blocked_threshold=0,
              batch_env=True)
    jsol, _, jscore = jax_evaluate_real(load_params(ckpt(variant)), data, "g.edges",
                                        str(tmp_path / "jax"), variant=variant, **kw)
    shadow = JaxShadow(variant, path, step)
    stats = {}
    tsol, _, tscore = evaluate_real(load_model(ckpt(variant), device="cpu"), data, "g.edges",
                                    str(tmp_path / "port"), variant=variant, device="cpu",
                                    shadow=shadow, stats=stats, **kw)
    assert stats["variant"] == variant and stats["fuse_sage"] == (variant != "hca")
    assert (stats["c_pad"] is not None) == (variant == "hca")
    if shadow.parting is None:
        assert jsol == tsol
    else:
        k, tie = shadow.parting
        assert jsol[:k] == tsol[:k]
        assert tie, f"{variant}: banded runs part at removal {k}, not a near-tie"
    hold(variant, path, jsol, tsol, jscore, tscore, tmp_path, lambda: shadow.parting)


@pytest.mark.parametrize("variant", ["degree_cost", "ce"])
def test_banded_forward_variants(data, variant):
    """banded_test_forward(variant=) against the JAX package's on an intact
    and a mid-dismantling state, unfused and fused (K2's plain version),
    and gp-sharded against unsharded:
    f32 on both sides, Q of order 0.1: to 1e-5, as tests/test_torch_forward.py
    holds unit cost."""
    path = os.path.join(data, "g.edges")
    g = jax_load(path, N, (1, 2), max_rank=0, **load_kw(variant))
    raw = read_multiplex_edges(path, N)
    w = np.asarray(g.weights) if variant == "degree_cost" else None
    nf = np.asarray(g.node_feat)[:, :N] if variant == "ce" else None
    jb, _, _ = jax_build(N, raw[1], raw[2], weights=w, node_feat=nf)
    tb, _, _ = build_banded_duplex(N, raw[1], raw[2], weights=w, node_feat=nf, device="cpu")
    np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    np.testing.assert_array_equal(tb.node_feat.numpy(), np.asarray(jb.node_feat))
    params = load_params(ckpt(variant))
    net = load_model(ckpt(variant), device="cpu")
    cov = np.zeros(tb.pad_n, bool)
    cov[N:] = True
    for removed in ((), np.random.default_rng(1).choice(N, 40, replace=False)):
        cov[list(removed)] = True
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax_fwd(params, jb, jnp.asarray(cov), variant=variant,
                                     precise=True))
        fin = np.isfinite(ref)
        for fuse in (False, True):
            got = banded_test_forward(net, tb, torch.from_numpy(cov), fuse_sage=fuse,
                                      variant=variant).numpy()
            np.testing.assert_array_equal(np.isfinite(got), fin)
            np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-5)
    # gp-sharded (two shards on the CPU): the variant's columns ride the
    # shards' pieces of weights and node_feat
    from mdcommunity_tpu_torch.graphs.banded import fork_banded, shard_banded_duplex
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, "cpu")
    sharded = shard_banded_duplex(mesh, fork_banded(tb))
    assert torch.equal(torch.cat(sharded.weights, dim=1), tb.weights)
    assert torch.equal(torch.cat(sharded.node_feat, dim=1), tb.node_feat)
    got = banded_test_forward(net, sharded, torch.from_numpy(cov), variant=variant).numpy()
    ref = banded_test_forward(net, tb, torch.from_numpy(cov), variant=variant).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="banded_hca_forward"):
        banded_test_forward(net, tb, torch.from_numpy(cov), variant="hca")


