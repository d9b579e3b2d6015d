"""The slice as a whole: the port's greedy dismantling against the JAX
package's, with the committed unit-cost checkpoint, on a seeded shuffled
graph from the large_graph_demo generator (the pattern and sizes of
tests/test_banded_eval.py: n = 1024, precise f32).

Both engines compute the same operator in f32, so they walk the same
trajectory as long as no decision hangs on a gap below f32 rounding.  A
full dismantling reaches such gaps: nodes whose Q is equal in exact
arithmetic (a live graph symmetric under swapping its layers gives
layer-swapped nodes equal Q) or closer than the engines' rounding (~1e-6
of Q).  The two engines round differently there (the JAX engine sums the
virtual-node pool in f32 in its own order; the port sums graph-wide in
f64), so the StepRatio-0 run is held to the same removals up to the first
difference, and that difference must be such a tie: both engines rate the
two candidates within TIE of each other.  The batched run and the short
packed-engine run walk identical trajectories and write identical files.
"""

import argparse
import copy
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_one_thread import one_torch_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from mdcommunity_tpu.env.host_env import make_host_env as jax_make_env  # noqa: E402
from mdcommunity_tpu.eval.metrics import dismantle_greedy_banded as jax_dismantle  # noqa: E402
from mdcommunity_tpu.eval.real import evaluate_real as jax_evaluate_real  # noqa: E402
from mdcommunity_tpu.graphs.banded import apply_severs as jax_apply_severs  # noqa: E402
from mdcommunity_tpu.graphs.banded import build_banded_duplex as jax_build  # noqa: E402
from mdcommunity_tpu.models.net import banded_test_forward as jax_forward  # noqa: E402
from mdcommunity_tpu.rl.dqn import DQNAgent  # noqa: E402
from mdcommunity_tpu.utils.config import Config  # noqa: E402
from mdcommunity_tpu_torch.env.host_env import make_host_env  # noqa: E402
from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy_banded  # noqa: E402
from mdcommunity_tpu_torch.eval.real import evaluate_real  # noqa: E402
from mdcommunity_tpu_torch.graphs.banded import apply_severs, build_banded_duplex  # noqa: E402
from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges  # noqa: E402
from mdcommunity_tpu_torch.models.checkpoint import load_model  # noqa: E402
from mdcommunity_tpu_torch.models.net import banded_test_forward  # noqa: E402

CKPT = "models_tpu/unit_cost_full_r1/best_model.ckpt"
N, SEED = 1024, 1
AUDC_TOL = 1e-9
TIE = 1e-5  # of max|Q|: a gap no f32 forward of this depth resolves


@pytest.fixture(scope="module")
def models():
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    agent.load(CKPT)
    return agent.params, load_model(CKPT, device="cpu")


@pytest.fixture(scope="module")
def edges():
    return synth_duplex_edges(N, 6, np.random.default_rng(SEED))


def _runs(models, edges, **kw):
    params, net = models
    e0, e1 = edges
    jb, _, (j0, j1) = jax_build(N, e0, e1)
    jsol, jscore, jcurve = jax_dismantle(params, jb, jax_make_env(N, j0, j1),
                                         precise=True, **kw)
    tb, _, (t0, t1) = build_banded_duplex(N, e0, e1, device="cpu")
    tsol, tscore, tcurve = dismantle_greedy_banded(
        net, tb, make_host_env(N, t0, t1), fuse_sage=False, **kw)
    return (jsol, jscore, jcurve), (tsol, tscore, tcurve)


def _q_after(models, edges, prefix, n=N):
    """Both engines' Q after removing `prefix` one by one, with the band
    edits each dismantling loop makes (the JAX loop pads sever lists to a
    power of two; so does this replay), and the port's Q in f64."""
    params, net = models
    e0, e1 = edges
    jb, _, (j0, j1) = jax_build(n, e0, e1)
    tb, _, _ = build_banded_duplex(n, e0, e1, device="cpu")
    env = make_host_env(n, j0, j1)

    def sever(layer, ns):
        nonlocal jb
        if not len(ns):
            return
        k = 8
        while k < len(ns):
            k *= 2
        s, d, v = np.zeros(k, np.int32), np.zeros(k, np.int32), np.zeros(k, bool)
        s[: len(ns)], d[: len(ns)], v[: len(ns)] = ns[:, 0], ns[:, 1], True
        jb = jax_apply_severs(jb, layer, jnp.asarray(s), jnp.asarray(d), jnp.asarray(v))
        e = torch.from_numpy(ns)
        apply_severs(tb, layer, e[:, 0], e[:, 1], torch.ones(len(ns), dtype=torch.bool))

    for layer in range(2):
        sever(layer, env.edges[layer][env.sever[layer]])
    for a in prefix:
        _, new = env.step(int(a))
        for layer in range(2):
            sever(layer, new[layer])
    covered = np.pad(env.covered, (0, tb.pad_n - n), constant_values=True)
    qj = np.asarray(jax.jit(lambda p, b, c: jax_forward(p, b, c, precise=True))(
        params, jb, jnp.asarray(covered)))
    cov = torch.from_numpy(covered)
    qt = banded_test_forward(net, tb, cov).numpy()
    q64 = banded_test_forward(copy.deepcopy(net).double(), tb, cov).numpy()
    return qj, qt, q64


def test_step_ratio_0_to_terminal(models, edges):
    (jsol, jscore, _), (tsol, tscore, tcurve) = _runs(models, edges, step=1)
    assert len(tsol) > N // 3 and len(set(tsol)) == len(tsol)
    k = next((i for i, (a, b) in enumerate(zip(jsol, tsol)) if a != b), None)
    if k is None:
        assert tsol == jsol
        assert abs(tscore - jscore) <= AUDC_TOL
        return
    # the first difference is a decision below f32 resolution
    qj, qt, _ = _q_after(models, edges, tsol[:k])
    a_j, a_t = jsol[k], tsol[k]
    tie = TIE * np.abs(qj[np.isfinite(qj)]).max()
    assert qj[a_j] == qj.max() and qt[a_t] == qt.max()
    assert abs(qj[a_j] - qj[a_t]) <= tie and abs(qt[a_t] - qt[a_j]) <= tie
    assert k > 100  # long identical prefix first
    # the port's AUDC is its own curve's
    assert abs(tscore - float(np.sum(tcurve[1:]) / N)) <= AUDC_TOL


def test_batch_env_evaluate_real_files_identical(models, edges, tmp_path):
    """StepRatio 32/1024 with one cascade per batch, through each package's
    evaluate_real: same removals, same AUDC, byte-identical result files."""
    params, net = models
    name = "synthetic_1024_multiplex.edges"
    write_edges(str(tmp_path / name), *edges)
    kw = dict(n_nodes=N, layers=(1, 2), step_ratio=32 / N, blocked_threshold=0,
              batch_env=True)
    jsol, _, jscore = jax_evaluate_real(params, str(tmp_path), name,
                                        str(tmp_path / "jax"), precise=True, **kw)
    tsol, _, tscore = evaluate_real(net, str(tmp_path), name, str(tmp_path / "port"),
                                    fuse_sage=False, device="cpu", **kw)
    assert len(tsol) > N // 3
    assert tsol == jsol
    assert abs(tscore - jscore) <= AUDC_TOL
    sub = "StepRatio_0.0312"
    for f in ("Soluion_synthetic_1024_multiplex_12.txt",
              "NormalizedLMCC_synthetic_1024_multiplex_12.txt"):
        with open(tmp_path / "jax" / sub / f, "rb") as a, \
                open(tmp_path / "port" / sub / f, "rb") as b:
            assert a.read() == b.read(), f
    rows = [open(tmp_path / d / "time&audc_real.csv").read().split()[-1].split(",")
            for d in ("jax", "port")]
    assert rows[0][2] == rows[1][2]  # the AUDC column (times differ)


def test_batch_env_without_cascade_batching_matches(models, edges):
    """StepRatio 32 with a cascade per removal: identical removals."""
    (jsol, jscore, _), (tsol, tscore, _) = _runs(models, edges, step=32,
                                                 max_steps=256)
    assert tsol == jsol and len(tsol) == 256
    assert abs(tscore - jscore) <= AUDC_TOL


def test_short_run_matches_packed_engine(models, edges):
    """About 10 removals against the JAX package's Pallas engine (fused SAGE
    steps, interpreted); the port takes its fused step (K2) too."""
    params, net = models
    e0, e1 = edges
    jb, _, (j0, j1) = jax_build(N, e0, e1)
    jsol, jscore, _ = jax_dismantle(params, jb, jax_make_env(N, j0, j1), step=1,
                                    packed=True, precise=True, max_steps=10)
    tb, _, (t0, t1) = build_banded_duplex(N, e0, e1, device="cpu")
    assert tb.spill_free
    stats = {}
    tsol, tscore, _ = dismantle_greedy_banded(net, tb, make_host_env(N, t0, t1),
                                              step=1, max_steps=10, stats=stats)
    assert stats["fuse_sage"] and stats["model_calls"] == 10
    assert tsol == jsol and len(tsol) == 10
    assert abs(tscore - jscore) <= AUDC_TOL


def test_large_graph_demo_on_the_cpu(tmp_path, capsys):
    """The demo entry point end to end with --device cpu: one JSON line per
    size, with the result files beside it."""
    from mdcommunity_tpu_torch.large_graph_demo import main as demo

    demo(["--sizes", "5000", "--step-ratio", "0.05", "--batch-env", "--packed",
          "--device", "cpu", "-o", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n"] == 5000 and line["device"] == "cpu"
    assert 0.0 < line["audc"] < 1.0 and line["removed"] > 1000
    assert line["fuse_sage"] and line["host_env"] == "native"
    sub = tmp_path / "results" / "StepRatio_0.0500"
    sol = (sub / "Soluion_synthetic_5000_multiplex_12.txt").read_text().split()
    assert len(sol) == line["removed"] == len(set(sol))


def _full_run(models, edges, n, engine):
    """One engine's StepRatio-0 dismantling to terminal on the CPU."""
    e0, e1 = edges
    if engine == "jax":
        jb, _, (j0, j1) = jax_build(n, e0, e1)
        sol, score, _ = jax_dismantle(models[0], jb, jax_make_env(n, j0, j1),
                                      precise=True)
    else:
        if engine == "port-f32-sums":
            import mdcommunity_tpu_torch.models.net as port_net

            port_net._graph_sum = lambda x, dim=0: torch.sum(x, dim=dim)
        tb, _, (t0, t1) = build_banded_duplex(n, e0, e1, device="cpu")
        sol, score, _ = dismantle_greedy_banded(models[1], tb,
                                                make_host_env(n, t0, t1))
    return dict(audc=score, removed=len(sol))


def main(argv=None):
    """Find where the two engines' StepRatio-0 dismantlings of one
    large_graph_demo graph first differ, and show both candidates' Q in
    both engines (f32) and in the port's f64 forward:

        PYTHONPATH=. python tests/test_torch_greedy.py --n 18222 --removals 400
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18222)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--removals", type=int, default=400)
    ap.add_argument("--full", choices=["jax", "port", "port-f32-sums"],
                    help="instead: run one engine to terminal and print its "
                         "AUDC; port-f32-sums sums graph-wide features in "
                         "f32, in row order, as the JAX engine does")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    agent = DQNAgent(Config(variant="unit_cost"), seed=0)
    agent.load(CKPT)
    models = (agent.params, load_model(CKPT, device="cpu"))
    edges = synth_duplex_edges(args.n, 6, np.random.default_rng(args.seed))
    n = args.n
    e0, e1 = edges
    if args.full:
        print(json.dumps(dict(n=n, seed=args.seed, engine=args.full,
                              **_full_run(models, edges, n, args.full))))
        return
    jb, _, (j0, j1) = jax_build(n, e0, e1)
    jsol, _, _ = jax_dismantle(models[0], jb, jax_make_env(n, j0, j1), precise=True,
                               max_steps=args.removals)
    tb, _, (t0, t1) = build_banded_duplex(n, e0, e1, device="cpu")
    tsol, _, _ = dismantle_greedy_banded(models[1], tb, make_host_env(n, t0, t1),
                                         max_steps=args.removals)
    k = next((i for i, (a, b) in enumerate(zip(jsol, tsol)) if a != b), None)
    print(f"n={n} seed={args.seed}: first difference at removal {k} "
          f"of {args.removals}")
    if k is None:
        return
    qj, qt, q64 = _q_after(models, edges, tsol[:k], n=n)
    for name, q in (("jax f32", qj), ("port f32", qt), ("port f64", q64)):
        a, b = jsol[k], tsol[k]
        print(f"{name}: Q[{a}] = {q[a]!r}  Q[{b}] = {q[b]!r}  "
              f"Q[{b}] - Q[{a}] = {float(q[b]) - float(q[a]):.3e}")


if __name__ == "__main__":
    main()
