"""The small-graph slice as a whole, against the JAX package: the golden
validation VC of the committed unit-cost checkpoint, the golden synthetic
sweep rows, greedy dismantling on the dense and segment engines (both
cascade engines), eval/real.py's small-graph branch with its result files,
and the scoring helpers.

Both packages compute Q in f32 and pick the same removals unless a choice
hangs on a gap below f32 rounding; on these graphs none does, so removals
are held identical and scores to f32 (rtol 1e-6)."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401

from mdcommunity_tpu.eval import metrics as jax_metrics  # noqa: E402
from mdcommunity_tpu.eval import writers as jax_writers  # noqa: E402
from mdcommunity_tpu.eval.real import evaluate_real as jax_evaluate_real  # noqa: E402
from mdcommunity_tpu.graphs import gmm as jax_gmm  # noqa: E402
from mdcommunity_tpu.graphs.duplex import stack_graphs as jax_stack  # noqa: E402
from mdcommunity_tpu.graphs.io import duplex_from_layers as jax_duplex  # noqa: E402
from mdcommunity_tpu.rl.dqn import DQNAgent  # noqa: E402
from mdcommunity_tpu.utils.config import Config  # noqa: E402
from mdcommunity_tpu_torch.eval import metrics, writers  # noqa: E402
from mdcommunity_tpu_torch.eval.real import evaluate_real  # noqa: E402
from mdcommunity_tpu_torch.eval.synthetic import (  # noqa: E402
    evaluate_synthetic_generated,
    write_result_rows,
)
from mdcommunity_tpu_torch.graphs import gmm  # noqa: E402
from mdcommunity_tpu_torch.graphs.duplex import stack_graphs  # noqa: E402
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import write_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.rl.dqn import make_valid_pool, validate  # noqa: E402
from mdcommunity_tpu_torch.utils.config import Config as PortConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
GOLDEN_VC = 0.1194451824  # tests/test_golden_models.py, unit cost
GOLDEN_SYN = os.path.join(REPO, "results_tpu", "golden_synthetic", "golden.json")


@pytest.fixture(scope="module")
def agent():
    """The JAX agent with the checkpoint, and a copy of its numpy rng as
    __init__ seeded it (load() restores the checkpoint's rng state)."""
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    rng0 = copy.deepcopy(agent.nprng)
    agent.load(CKPT)
    return agent, rng0


@pytest.fixture(scope="module")
def models(agent):
    return agent[0].params, load_model(CKPT, device="cpu")


def test_golden_validation_vc(agent, models):
    """The 32-graph validation pool of seed 0 and its greedy VC: the pool
    equals the one the JAX agent draws (prepare_valid_data from the rng its
    __init__ seeded), the VC the golden value to 1e-5."""
    cfg = dataclasses.replace(PortConfig(variant="unit_cost"), n_valid=32)
    pool = make_valid_pool(cfg, device="cpu")
    ref = jax_gmm.generate_pool(agent[1], 32, cfg.num_min, cfg.num_max,
                                cfg.pad_nodes, cfg.pad_edges, g_corr=cfg.gmm_g)
    ref = jax_stack(ref)
    np.testing.assert_array_equal(pool.stacked.src.numpy(), np.asarray(ref.src))
    np.testing.assert_array_equal(pool.stacked.max_rank.numpy(), np.asarray(ref.max_rank))
    vc = validate(models[1], pool)
    assert abs(vc - GOLDEN_VC) <= 1e-5, vc


def test_golden_synthetic_model_rows(models, tmp_path):
    """scripts/make_golden_synthetic.py's model rows (sizes 32, 64, 128, 5
    graphs each, seed 0) at rtol 1e-5, and their result-file lines."""
    with open(GOLDEN_SYN) as f:
        golden = json.load(f)
    rows = evaluate_synthetic_generated(models[1], golden["sizes"], golden["n_graphs"],
                                        seed=golden["seed"], device="cpu")
    for r, ref in zip(rows, golden["model"]):
        assert r["size"] == ref["size"]
        for k in ("score_mean", "score_std", "cost_mean"):
            np.testing.assert_allclose(r[k], ref[k], rtol=1e-5)
    write_result_rows(str(tmp_path / "rows.txt"), rows, "unit_cost")
    committed = open(os.path.join(REPO, "results_tpu", "golden_synthetic",
                                  "result_synthetic_unit_cost.txt")).read().splitlines()
    for line, ref in zip(open(tmp_path / "rows.txt").read().splitlines(), committed):
        assert line.split(" time ")[0] == ref.split(" time ")[0]


def _gmm_graph(n, seed):
    e0, e1 = jax_gmm.gmm_duplex_edges(n, np.random.default_rng(seed))
    return e0, e1, jax_duplex(n, e0, e1), duplex_from_layers(n, e0, e1, device="cpu")


@pytest.mark.parametrize("n,step,dense", [(60, 1, None), (60, 3, False), (200, 1, None),
                                          (200, 5, False)],
                         ids=["dense-closure", "segment-closure", "dense-labels",
                              "segment-labels"])
def test_dismantle_greedy_matches_jax(models, n, step, dense):
    params, net = models
    _, _, jg, tg = _gmm_graph(n, 100 + n)
    assert (tg.pad_n <= 128) == (n <= 128)  # which cascade engine runs
    sol_j, score_j, curve_j = jax_metrics.dismantle_greedy(params, jg, step=step, dense=dense)
    sol_t, score_t, curve_t = metrics.dismantle_greedy(net, tg, step=step, dense=dense)
    assert sol_t == sol_j and len(sol_t) > 3
    np.testing.assert_allclose(score_t, score_j, rtol=1e-6)
    np.testing.assert_allclose(curve_t, curve_j, rtol=1e-12)
    sol_s, score_s, _ = metrics.dismantle_greedy(net, tg, step=step, dense=dense, syn_stop=True)
    sol_js, score_js, _ = jax_metrics.dismantle_greedy(params, jg, step=step, dense=dense,
                                                      syn_stop=True)
    assert sol_s == sol_js and len(sol_s) <= len(sol_t)


def test_scoring_helpers_match_jax(models):
    params, net = models
    e0, e1, jg, tg = _gmm_graph(80, 5)
    sol, score, _ = metrics.dismantle_greedy(net, tg)
    for dc in (False, True):
        rj = jax_metrics.solution_robustness(jg, sol, degree_cost=dc)
        rt = metrics.solution_robustness(tg, sol, degree_cost=dc)
        np.testing.assert_allclose(rt[0], rj[0], rtol=1e-6)
        np.testing.assert_allclose(rt[1], rj[1], rtol=1e-12)
    for each in (1, 3):
        assert metrics.reinsert_solution(tg, sol, each) == jax_metrics.reinsert_solution(jg, sol, each)
    assert metrics.validation_score(0.1, 80, 20, 50) == jax_metrics.validation_score(0.1, 80, 20, 50)
    # the batched sweep over a pool
    jp = jax_gmm.generate_pool(np.random.default_rng(9), 6, 30, 50, 64, 1024)
    tp = gmm.generate_pool(np.random.default_rng(9), 6, 30, 50, 64, 1024, device="cpu")
    sj, cj = jax_metrics.dismantle_batch_greedy(params, jax_stack(jp))
    st, ct = metrics.dismantle_batch_greedy(net, stack_graphs(tp))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(st, sj, rtol=1e-6)


def test_cost_curve_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.random((2, 30))
    sol = [4, 17, 2, 9]
    jax_writers.write_cost_curve(str(tmp_path / "j.txt"), w, sol, 30, 0.25)
    writers.write_cost_curve(str(tmp_path / "t.txt"), w, sol, 30, 0.25)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()


@pytest.mark.parametrize("step_ratio", [0.0, 0.02])
def test_evaluate_real_small_graph_branch(models, tmp_path, step_ratio):
    """A 300-node GMM duplex written as a .edges file: each package's
    evaluate_real takes its small-graph branch; same removals, same AUDC,
    byte-identical result files."""
    params, net = models
    e0, e1 = jax_gmm.gmm_duplex_edges(300, np.random.default_rng(21))
    name = "gmm_300_multiplex.edges"
    write_edges(str(tmp_path / name), e0, e1)
    kw = dict(n_nodes=300, layers=(1, 2), step_ratio=step_ratio)
    jsol, _, jscore = jax_evaluate_real(params, str(tmp_path), name, str(tmp_path / "jax"), **kw)
    stats = {}
    tsol, _, tscore = evaluate_real(net, str(tmp_path), name, str(tmp_path / "port"),
                                    device="cpu", stats=stats, **kw)
    assert tsol == jsol and len(tsol) > 10 and stats["model_calls"] > 0
    np.testing.assert_allclose(tscore, jscore, rtol=1e-6)
    sub = f"StepRatio_{step_ratio:.4f}"
    for f in ("Soluion_gmm_300_multiplex_12.txt", "NormalizedLMCC_gmm_300_multiplex_12.txt"):
        assert (tmp_path / "jax" / sub / f).read_bytes() == (tmp_path / "port" / sub / f).read_bytes()
