"""The degree-cost, CE and HCA variants' small-graph dismantling against
the JAX package: evaluate_real's small-graph path with each committed
*_100k_r5 checkpoint (tests/variant_cases.py holds the trajectories to each
other), `cli test-real --variant hca --cpu`, and the agent building CE and HCA
for training (slice D2)."""

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
        ckpt,
    hold,
    small_parting,
    write_graph,
)

from mdcommunity_tpu.eval.real import evaluate_real as jax_evaluate_real  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges  # noqa: E402
from mdcommunity_tpu.graphs.io import duplex_from_layers as jax_duplex  # noqa: E402
from mdcommunity_tpu.rl.dqn import predict_q as jax_predict_q  # noqa: E402
from mdcommunity_tpu_torch.eval.real import evaluate_real  # noqa: E402
from mdcommunity_tpu_torch.eval.synthetic import variant_options  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.rl.dqn import predict_q  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_graph(str(tmp_path_factory.mktemp("variants")))


@pytest.mark.parametrize("variant", ["degree_cost", "ce", "hca"])
def test_evaluate_real_small_graph_path(data, variant, tmp_path):
    path = os.path.join(data, "g.edges")
    kw = dict(n_nodes=N, layers=(1, 2), step_ratio=STEP_RATIO)
    jsol, _, jscore = jax_evaluate_real(load_params(ckpt(variant)), data, "g.edges",
                                        str(tmp_path / "jax"), variant=variant, **kw)
    tsol, _, tscore = evaluate_real(load_model(ckpt(variant), device="cpu"), data, "g.edges",
                                    str(tmp_path / "port"), variant=variant, device="cpu",
                                    **kw)
    hold(variant, path, jsol, tsol, jscore, tscore, tmp_path,
          lambda: small_parting(variant, path, jsol, tsol, max(int(STEP_RATIO * N), 1)))
    if variant == "ce":  # the prior went through the JAX package's cache name
        assert os.path.isfile(tmp_path / "port" / "real_cache" / "comm_prior_g_layers1-2_boundary.npz")


def test_cli_test_real_hca_cpu(data, tmp_path, capsys):
    from mdcommunity_tpu_torch.cli import main

    main(["test-real", "--model", ckpt("hca"), "--data", data, "-o", str(tmp_path),
          "--datasets", "g.edges", "--n-nodes", str(N), "--layers", "1", "2",
          "--step-ratio", "0.05", "--variant", "hca", "--cpu"])
    out = capsys.readouterr().out
    assert out.startswith("g.edges: audc=") and "removed=" in out
    assert os.path.isfile(tmp_path / "StepRatio_0.0500" / "Soluion_g_12.txt")


def test_agent_refuses_to_train_ce_and_hca():
    """Since slice D2 the agent trains CE and HCA (held to the JAX package
    in tests/test_torch_variants_train.py, test_torch_hca_train.py and their
    agent files): it builds both, with HCA's net, and refuses only what the
    JAX package has not, an unknown variant or fusion mode."""
    from mdcommunity_tpu_torch.models.hca import HcaQNet
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.config import Config

    for variant in ("ce", "hca"):
        agent = DQNAgent(Config(variant=variant), device="cpu")
        assert isinstance(agent.net, HcaQNet) == (variant == "hca")
        assert agent.net.w_n2l.shape[0] == 3
    with pytest.raises(ValueError, match="unknown variant"):
        DQNAgent(Config(variant="leiden"), device="cpu")
    with pytest.raises(ValueError, match="unknown fusion"):
        DQNAgent(Config(fusion="gat"), device="cpu")


def test_jax_synthetic_eval_leaves_out_the_prior():
    """A fault of the JAX package that the port does not copy (pinned).
    Its eval/synthetic.py:70-75 (and :39) builds the graphs of every
    variant with duplex_from_layers(n, e0, e1, degree_cost=...): a CE graph
    without its prior, so the CE model reads a zero prior column, and an HCA
    graph with n_comms = 0, so no community is real, no node is selected
    and every live node gets the same Q, the -1e9 sentinel.  The port's
    synthetic evaluation attaches both, as evaluate_real does
    (eval/synthetic.variant_options)."""
    n = 40
    e0, e1 = gmm_duplex_edges(n, np.random.default_rng(0))
    jg = jax_duplex(n, e0, e1, degree_cost=False)  # what the JAX sweep builds
    assert not np.asarray(jg.node_feat).any() and not np.asarray(jg.n_comms).any()
    cov = np.zeros((1, jg.pad_n), bool)
    sev = np.zeros((1, 2, jg.pad_e), bool)
    q = np.asarray(jax_predict_q(load_params(ckpt("hca")), jax_stack([jg]), jnp.asarray(cov),
                                 jnp.asarray(sev), "hca"))[0]
    live = q[np.isfinite(q)]
    assert len(live) == n and np.all(live == live[0]) and live[0] < -1e8

    tg = duplex_from_layers(n, e0, e1, device="cpu", **variant_options("hca"))
    assert (tg.n_comms > 0).all()
    qt = predict_q(load_model(ckpt("hca"), device="cpu"), stack_graphs([tg]),
                   torch.from_numpy(cov), torch.from_numpy(sev), "hca")[0].numpy()
    assert (qt[np.isfinite(qt)] > -1e8).any()
    tce = duplex_from_layers(n, e0, e1, device="cpu", **variant_options("ce"))
    assert tce.node_feat.any() and tce.boundary.any()
    jce = jax_duplex(n, e0, e1, prior_feature="boundary")
    np.testing.assert_array_equal(tce.node_feat.numpy(), np.asarray(jce.node_feat))
