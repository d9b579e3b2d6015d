"""The degree-cost, CE and HCA variants on small graphs against the JAX
package: the synthetic sweep of each committed *_100k_r5 checkpoint against
JAX dismantle_greedy on the same GMM graphs with their variant's structure
(the JAX package's own sweep leaves the CE and HCA structure out: pinned in
tests/test_torch_variants.py), and the validation VC against the JAX
agent's validate on the same pool, to 1e-6.

Each graph's trajectory is held to the JAX package's up to its first
parting, which must be a near-tie (tests/variant_cases.py); with no parting
the scores agree to f32.  HCA parts often: its unselected nodes sit at
-1e9·w, where the f32 spacing is 32-64 and the small part of their Q is
below it, so which of them rounds up a spacing is f32 noise.  So HCA's VC
is held to JAX's with the port's rollout resynced to the JAX action at each
near-tie parting (each one checked), as the DQN rollout tests do."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
from variant_cases import VARIANTS, ckpt, graph_parting, is_near_tie  # noqa: E402

from mdcommunity_tpu.eval.metrics import dismantle_greedy as jax_dismantle  # noqa: E402
from mdcommunity_tpu.graphs.gmm import gmm_duplex_edges  # noqa: E402
from mdcommunity_tpu.graphs.io import duplex_from_layers as jax_duplex  # noqa: E402
from mdcommunity_tpu.rl.dqn import DQNAgent  # noqa: E402
from mdcommunity_tpu.utils.config import Config  # noqa: E402
from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy  # noqa: E402
from mdcommunity_tpu_torch.eval.synthetic import (  # noqa: E402
    evaluate_synthetic_sweep,
    variant_options,
)
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model, load_params  # noqa: E402
from mdcommunity_tpu_torch.rl.dqn import make_valid_pool, validate  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config as PortConfig  # noqa: E402

SIZE, GRAPHS, G_VALUES = 40, 3, (0.3, 0.8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sweep_equals_jax_greedy_with_the_prior(variant):
    """Rows of evaluate_synthetic_sweep over g: each row is the mean of the
    port's greedy runs on the graphs the sweep draws, each with its
    variant's structure, and each run is held to the JAX package's greedy
    rollout on the JAX package's graph."""
    net = load_model(ckpt(variant), device="cpu")
    rows = evaluate_synthetic_sweep(net, "g", list(G_VALUES), size=SIZE, n_graphs=GRAPHS,
                                    variant=variant, device="cpu")
    params = load_params(ckpt(variant))
    for row, g in zip(rows, G_VALUES):
        rng = np.random.default_rng(0)
        scores, costs = [], []
        for _ in range(GRAPHS):
            e0, e1 = gmm_duplex_edges(SIZE, rng, g=g, gamma1=2.5, gamma2=2.5)
            jg = jax_duplex(SIZE, e0, e1, degree_cost=variant == "degree_cost",
                            prior_feature="boundary" if variant == "ce" else None,
                            hca=variant == "hca")
            tg = duplex_from_layers(SIZE, e0, e1, device="cpu", **variant_options(variant))
            if int(tg.max_rank) <= 1:
                continue
            jsol, jscore, _ = jax_dismantle(params, jg, variant=variant)
            tsol, tscore, _ = dismantle_greedy(net, tg, variant=variant)
            if jsol == tsol:
                np.testing.assert_allclose(tscore, jscore, rtol=1e-6)
            else:
                k, tie = graph_parting(variant, jg, tg, jsol, tsol, 1)
                assert tie, f"{variant}, g={g}: parts at removal {k}, not a near-tie"
            scores.append(tscore)
            costs.append(len(tsol) / SIZE)
        assert row["g"] == g and scores
        assert row["score_mean"] == float(np.mean(scores))
        assert row["cost_mean"] == float(np.mean(costs))


def _lockstep_vc(variant, jax_agent, pool, net):
    """The JAX agent's validation rollout and the port's in lockstep over
    the pool: at each step every graph takes the JAX package's argmax, after
    checking that the port's differs from it only at a near-tie.  Returns
    (the VC, the number of partings)."""
    import jax.numpy as jnp
    import torch

    from mdcommunity_tpu.env.env import batched_reset as jax_reset
    from mdcommunity_tpu.env.env import batched_step as jax_step
    from mdcommunity_tpu.rl.dqn import predict_q as jax_predict_q
    from mdcommunity_tpu_torch.env.env import batched_reset, batched_step
    from mdcommunity_tpu_torch.rl.dqn import predict_q

    jg, tg = jax_agent.valid_pool.stacked, pool.stacked
    js, ts = jax_reset(jg), batched_reset(tg)
    partings = 0
    for _ in range(tg.pad_n):
        if bool(ts.terminal.all()):
            break
        qj = np.asarray(jax_predict_q(jax_agent.params, jg, js.covered, js.sever, variant))
        qt = predict_q(net, tg, ts.covered, ts.sever, variant).numpy()
        aj, at = qj.argmax(axis=1), qt.argmax(axis=1)
        for b in np.flatnonzero((aj != at) & ~ts.terminal.numpy()):
            a, c = aj[b], at[b]
            assert is_near_tie(qj[b, a], qj[b, c], qj[b], qt[b, a], qt[b, c], qt[b], a, c)
            partings += 1
        js, _ = jax_step(jg, js, jnp.asarray(aj), False)
        ts, _ = batched_step(tg, ts, torch.from_numpy(aj), False)
    covered = torch.sum(ts.covered & tg.node_mask, dim=1)
    n_f = tg.n_nodes.to(torch.float32)
    vc = ts.score + (tg.n_nodes - covered).to(torch.float32) / (tg.max_rank.to(torch.float32)
                                                               * n_f)
    return float(torch.mean(vc)), partings


@pytest.mark.parametrize("variant", ["ce", "hca"])
def test_validation_vc_equals_jax(variant):
    """make_valid_pool and validate against the JAX agent's
    prepare_valid_data and validate on an 8-graph pool with the variant's
    structure and the committed checkpoint's weights: the pools equal, the
    VC to 1e-6 (CE directly; HCA through the lockstep, the port's own
    validate within the spread its near-tie partings allow)."""
    cfg = dataclasses.replace(Config(variant=variant), n_valid=8)
    agent = DQNAgent(cfg, seed=0)
    agent.prepare_valid_data()
    agent.params = load_params(ckpt(variant))
    ref = agent.validate()
    pool = make_valid_pool(dataclasses.replace(PortConfig(variant=variant), n_valid=8),
                           device="cpu")
    for f in ("src", "max_rank", "node_feat", "boundary", "comm_id", "n_comms", "hca_feat"):
        np.testing.assert_array_equal(getattr(pool.stacked, f).numpy(),
                                      np.asarray(getattr(agent.valid_pool.stacked, f)), f)
    net = load_model(ckpt(variant), device="cpu")
    vc = validate(net, pool, variant)
    if variant == "ce":
        assert abs(vc - ref) <= 1e-6, (vc, ref)
        return
    lock, partings = _lockstep_vc(variant, agent, pool, net)
    assert abs(lock - ref) <= 1e-6, (lock, ref)
    assert partings > 0 or abs(vc - ref) <= 1e-6
