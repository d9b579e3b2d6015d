"""The port across OS processes: parallel/mesh.init_distributed and a GpMesh
whose gp axis spans processes (the dp agent, the CLI smoke and the dp × gp
mesh are in tests/test_torch_multihost_dp.py).

mdcommunity_tpu_torch.multihost_smoke spawns 2 CPU processes with gloo,
each importing the port only; they write their results into tmp_path and
this process holds them against the JAX package on its 8-device CPU mesh:

* gp = 4, two shards a process, on a graph with live mirror lanes:
  spmm_band_sharded's forward and VJP against the JAX package's
  spmm_band_sharded(make_mesh(dp=1, gp=4), precise=True) to 1e-5 of
  max|ref|, Q against its f32 XLA forward to 1e-5, banded_train_loss's value
  against JAX's banded_train_loss(mesh=..., precise=True) to rtol 1e-5 and
  its gradients, with JAX's and the one-process f32 loss's, against the
  port's float64 loss by tests/gradient_rules.py; the children hold the
  same calls to the one-process gp = 4 port bit for bit (operator, VJP, Q;
  the loss, a sum of the processes' parts, to 1e-6) and both losses'
  gradients to their own float64 referee;
* validate under dp (each process half the pool) against the
  single-process score; the edge partition across processes against one
  process; init_distributed without a cluster.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gradient_rules import gate_terms, leaf_tolerances  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.graphs.banded import shard_banded_duplex as jax_shard_duplex  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu.models.net import banded_train_loss as jax_train_loss  # noqa: E402
from mdcommunity_tpu.parallel import band_partition as jbp  # noqa: E402
from mdcommunity_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from mdcommunity_tpu_torch import multihost_smoke as mh  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_params  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_train_loss, from_jax_params  # noqa: E402
from mdcommunity_tpu_torch.parallel import mesh as tmesh  # noqa: E402

GRAPH = dict(kind="mirror", n=4096)
TOL = 1e-5  # of max|ref|: f32 on both sides, sums in another order
SMOKE = dict(n_train=6, n_valid=4, max_iteration=12, batch_size=4, warmup_games=1,
             warmup_traj=4, num_env=4, num_min=12, num_max=16, pad_nodes=16,
             pad_edges=256, memory_size=2000, save_frequency=6, update_time=6)


@pytest.fixture(scope="module")
def gp_run(tmp_path_factory):
    """The gp phase (precise, 64 actions), the edge partition and dp
    validation, one run of two processes."""
    out = str(tmp_path_factory.mktemp("gp"))
    cfg = dict(mh.SMALL, phases=["gp", "partition", "validate"], graph=GRAPH, actions=64,
               partition=dict(n=4096, edges=40000, D=32, tol=1e-6),
               agent=dict(config=SMOKE))
    results, _ = mh.run("cpu", "gloo", cfg, out, timeout=240)
    mh.check_agreement(results)
    return results, dict(np.load(os.path.join(out, "rank0.npz")))


@pytest.fixture(scope="module")
def builds():
    n, e0, e1, reorder = mh.graph_edges(GRAPH)
    jb, _, _ = jax_build(n, e0, e1, reorder=reorder)
    tb, _, _ = build_banded_duplex(n, e0, e1, reorder=reorder, device="cpu")
    assert tb.spill_free and tb.dbg0.ccoo.nnz and tb.dbg1.ccoo.nnz  # live mirror lanes
    return jb, tb


def test_gp_operator_and_q_match_jax_and_one_process(gp_run, builds):
    results, arrays = gp_run
    jb, _ = builds
    gp = results[0]["gp"]
    assert [r["gp"]["local"] for r in results] == [[0, 1], [2, 3]]
    assert [r["foreign_modules"] for r in results] == [[], []]  # the port alone
    for key in ("op_precise", "q_precise"):
        assert gp[key]["vs_one_process"] == 0.0, key  # bit for bit
    assert gp["op_precise"]["vjp_vs_one_process"] == 0.0

    jm = jax_mesh(dp=1, gp=4, devices=jax.devices()[:4])
    dbg_s = jbp.shard_band_graph(jm, jb.dbg(0))
    row_s, col_s, h_s = jbp.shard_band_vectors(
        jm, *map(jnp.asarray, (arrays["row"], arrays["col"], arrays["h"])))
    ref, vjp = jax.vjp(lambda x: jbp.spmm_band_sharded(jm, dbg_s, row_s, col_s, x,
                                                       precise=True), h_s)
    (dref,) = vjp(jnp.asarray(arrays["g0"]))
    for got, want in ((arrays["out_precise"], ref), (arrays["dh_precise"], dref)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())

    params = load_params(mh.CKPT)
    q = np.asarray(jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jb, jnp.asarray(arrays["covered"])))
    fin = np.isfinite(q)
    np.testing.assert_array_equal(np.isfinite(arrays["q_precise"]), fin)
    np.testing.assert_allclose(arrays["q_precise"][fin], q[fin], rtol=0, atol=TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def test_gp_loss_matches_jax(gp_run, builds):
    """The loss (the two processes' parts summed) to rtol 1e-5 of JAX's
    sharded loss; every gradient leaf of the two-process loss, of the
    one-process f32 loss (the child's reference) and of JAX's against the
    port's float64 one-process loss by tests/gradient_rules.py (the gate
    leaves, w_layer1 and w_layer2 among them, also to TERMS_TOL of their
    terms)."""
    results, arrays = gp_run
    jb, tb = builds
    gp = results[0]["gp"]
    assert abs(gp["loss"]["loss"] - gp["loss"]["one_process"]) <= \
        1e-6 * abs(gp["loss"]["one_process"])
    assert sum(r["gp"]["loss"]["part"] for r in results) == pytest.approx(
        gp["loss"]["loss"], rel=1e-6)
    params = load_params(mh.CKPT)
    acts, tgts, covered = arrays["acts"], arrays["tgts"], arrays["covered"]
    jm = jax_mesh(dp=1, gp=4, devices=jax.devices()[:4])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b, c: jax_train_loss(p, b, c, jnp.asarray(acts), jnp.asarray(tgts),
                                       precise=True, mesh=jm)))(
        jax.tree_util.tree_map(jnp.asarray, params), jax_shard_duplex(jm, jb),
        jbp.shard_band_vectors(jm, jnp.asarray(covered)))
    np.testing.assert_allclose(float(arrays["loss"]), float(jloss), rtol=1e-5)

    net = from_jax_params(params, "cpu").double().requires_grad_()
    with gate_terms(net) as terms:
        banded_train_loss(net, tb, torch.from_numpy(covered), torch.from_numpy(acts),
                          torch.from_numpy(tgts).double()).backward()
    grads64 = {k: p.grad.numpy() for k, p in net.named_parameters()}
    tols = leaf_tolerances(grads64, terms.sums())
    jflat = _flat(jgrads)
    assert set(jflat) == set(grads64)
    for k, g64 in grads64.items():
        for name, g in (("two processes", arrays[f"grad.{k}"]),
                        ("one process", arrays[f"grad1.{k}"]), ("jax", jflat[k])):
            np.testing.assert_allclose(g, g64, rtol=0, atol=tols[k], err_msg=f"{name} {k}")


def test_edge_partition_across_processes(gp_run):
    part = gp_run[0][0]["partition"]
    assert max(part["errors"].values()) <= 1e-6, part


def test_validate_under_dp(gp_run):
    results = gp_run[0]
    v = results[0]["validate"]
    assert v["graphs"] == SMOKE["n_valid"] and abs(v["vc"] - v["single"]) <= 1e-6
    assert results[1]["validate"]["vc"] == v["vc"]


def test_init_distributed_without_a_cluster(monkeypatch):
    """No arguments and no torchrun variables: one process, rank 0, no
    group; a dp mesh then needs processes."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() == 0
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh(4, "cpu")
    assert not mesh.spans and list(mesh.local) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="dp=2"):
        tmesh.make_mesh(1, "cpu", dp=2)
