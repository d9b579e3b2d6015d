"""The variants' large-graph training against the JAX package, on the CPU
at 400 nodes (tests/variant_cases.py's demo graph) with the committed
degree-cost and CE checkpoints, and live_scales.

* banded_train_loss(variant=degree_cost|ce): the loss to rtol 1e-5 of the
  JAX package's banded_train_loss(variant=, precise=True); every gradient
  leaf of both f32 engines within 1e-4 of the leaf's max|grad| from the
  port's f64 gradient (the same code in f64, the arbiter, as in
  tests/test_torch_train.py), with LEAF_FLOOR, under
  tests/gradient_rules.py's rule.  The gate leaves are sums of near-equal
  terms: the layer gate's w_layer1 and w_layer2 (7e-7 to 2e-5 of the
  largest leaf, 7e-4 to 2e-3 of their terms' absolute sum) and the
  fusion's logis_b; they may also take TERMS_TOL of that sum (both
  engines off by at most 7.4e-7 of it; the test checks that gate_terms
  saw every term).
* HCA has no banded trainer in the JAX package: both entry points raise
  ValueError naming that.
* live_scales(sum|mean|gcn) exactly the JAX package's (0/1 operands and
  integer sums), in both precise modes.
The loop, train_banded_loop(variant=): tests/test_torch_banded_variants_loop.py.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from gradient_rules import gate_terms, leaf_tolerances  # noqa: E402
from variant_cases import N, ckpt, load_kw, write_graph  # noqa: E402

from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.io import load_real_duplex as jax_load  # noqa: E402
from mdcommunity_tpu.models import net as jnet  # noqa: E402
from mdcommunity_tpu.ops import dense_band as jdb  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_train_loss, from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.ops.dense_band import live_scales  # noqa: E402
from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop  # noqa: E402

QUIET = dict(log_every=100, log=lambda *a, **k: None)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Per variant: the JAX and the port's banded builds of the demo graph
    with the variant's columns, both packages' band-order edges and the
    band-order weights."""
    d = write_graph(str(tmp_path_factory.mktemp("banded_train")))
    path = os.path.join(d, "g.edges")
    raw = read_multiplex_edges(path, N)
    out = {}
    for variant in ("degree_cost", "ce"):
        g = jax_load(path, N, (1, 2), max_rank=0, **load_kw(variant))
        w = np.asarray(g.weights) if variant == "degree_cost" else None
        nf = np.asarray(g.node_feat)[:, :N] if variant == "ce" else None
        jb, _, jedges = jax_build(N, raw[1], raw[2], weights=w, node_feat=nf)
        tb, _, tedges = build_banded_duplex(N, raw[1], raw[2], weights=w, node_feat=nf,
                                            device="cpu")
        np.testing.assert_array_equal(tb.weights.numpy(), np.asarray(jb.weights))
        np.testing.assert_array_equal(tb.node_feat.numpy(), np.asarray(jb.node_feat))
        bw = tb.weights.numpy()[:, :N] if variant == "degree_cost" else None
        out[variant] = (jb, tb, jedges, tedges, bw)
    return out


def _loss_inputs(tb, seed=5):
    rng = np.random.default_rng(seed)
    covered = (rng.random(tb.pad_n) < 0.15) | ~tb.node_mask.numpy()
    acts = rng.choice(np.flatnonzero(~covered), 48, replace=False)
    tgts = (0.1 * rng.standard_normal(48) - 0.05).astype(np.float32)
    return covered, acts, tgts


def _port_loss(params, tb, covered, acts, tgts, variant, dtype=torch.float32):
    """(loss, gradients, the gate_terms of the run)."""
    net = from_jax_params(params, device="cpu").to(dtype).requires_grad_()
    with gate_terms(net) as terms:
        loss = banded_train_loss(net, tb, torch.from_numpy(covered), torch.from_numpy(acts),
                                 torch.from_numpy(tgts).to(dtype), variant=variant)
        loss.backward()
    return (loss.item(), {k: p.grad.double().numpy() for k, p in net.named_parameters()},
            terms)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


@pytest.mark.parametrize("variant", ["degree_cost", "ce"])
def test_banded_train_loss_variant_matches_jax(builds, variant):
    jb, tb, _, _, _ = builds[variant]
    params = load_params(ckpt(variant))
    covered, acts, tgts = _loss_inputs(tb)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.default_matmul_precision("highest"):
        ref_loss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b, c, a, t: jnet.banded_train_loss(p, b, c, a, t, variant=variant,
                                                         precise=True)))(
            jparams, jb, jnp.asarray(covered), jnp.asarray(acts), jnp.asarray(tgts))
    loss, grads, _ = _port_loss(params, tb, covered, acts, tgts, variant)
    _, grads64, terms = _port_loss(params, tb, covered, acts, tgts, variant, torch.float64)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    ref = _flat(jgrads)
    assert set(ref) == set(grads) and len(ref) == 13
    # the hook saw every term of the gate leaves
    for k, s in terms.sums(signed=True).items():
        np.testing.assert_allclose(s, grads64[k], rtol=1e-9,
                                   atol=1e-9 * np.abs(grads64[k]).max(), err_msg=k)
    tols = leaf_tolerances(grads64, terms.sums())
    for k, g64 in grads64.items():
        tol = tols[k]
        for name, g in (("port", grads[k]), ("jax", ref[k])):
            np.testing.assert_allclose(g, g64, rtol=0, atol=tol, err_msg=f"{name} {k}")


def test_hca_has_no_banded_trainer(builds):
    jb, tb, _, tedges, _ = builds["ce"]
    net = load_model(ckpt("hca"), device="cpu")
    covered, acts, tgts = _loss_inputs(tb)
    with pytest.raises(ValueError, match="JAX package has no banded HCA loss"):
        banded_train_loss(net, tb, torch.from_numpy(covered), torch.from_numpy(acts),
                          torch.from_numpy(tgts), variant="hca")
    with pytest.raises(ValueError, match="JAX package has no banded HCA trainer"):
        train_banded_loop(net, tb, make_host_env(N, *tedges, engine="native"), iters=1,
                          variant="hca", **QUIET)


@pytest.mark.parametrize("aggregator", ["sum", "mean", "gcn"])
def test_live_scales_matches_jax(builds, aggregator):
    jb, tb, _, _, _ = builds["ce"]
    rng = np.random.default_rng(2)
    for layer in range(2):
        covered = (rng.random(tb.pad_n) < 0.2) | ~tb.node_mask.numpy()
        ref = jdb.live_scales(jb.dbg(layer), jnp.asarray(covered), aggregator)
        for precise in (True, False):
            got = live_scales(tb.dbg(layer), torch.from_numpy(covered), aggregator, precise)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        if aggregator != "sum":
            assert not np.array_equal(np.asarray(ref[0]), (~covered).astype(np.float32))
