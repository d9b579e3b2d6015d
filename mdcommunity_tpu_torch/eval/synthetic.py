"""Synthetic evaluation sweep (reference: Evaluate :563-600 + testSynthetic.py).

Network sizes x GMM generator settings, on GMM graphs generated on the fly
from a seed (the JAX package's stream, graphs/gmm.py); evaluate_synthetic_sweep
sweeps one generator parameter at a fixed size, and evaluate_synthetic_dir
reads stored adjacency pairs.  Reports AUDC mean/std, solve time and cost per
size, and writes rows in the reference's result-file format.  The model
runs on the graphs' device through eval/metrics.dismantle_greedy.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np

from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy
from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers, edges_from_dense_adj
from mdcommunity_tpu_torch.utils.device import resolve_device


def _row(size, scores, times, costs) -> dict:
    def stat(fn, xs):
        return float(fn(xs)) if xs else float("nan")

    return dict(size=size, score_mean=stat(np.mean, scores),
                score_std=stat(np.std, scores), time_mean=stat(np.mean, times),
                cost_mean=stat(np.mean, costs))


def variant_options(variant: str) -> dict:
    """duplex_from_layers' options for a variant's graphs: degree cost its
    costs, CE its community prior (Config().comm_prior_feature, as
    evaluate_real attaches "boundary"), HCA its communities.  The JAX
    package's synthetic evaluation builds CE and HCA graphs without them, so
    its CE model reads a zero prior column and its HCA model sees no
    community (every Q the same -1e9 sentinel); the port does not copy
    that."""
    from mdcommunity_tpu_torch.rl.dqn import VARIANTS
    from mdcommunity_tpu_torch.utils.config import Config

    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return dict(degree_cost=variant == "degree_cost",
                prior_feature=Config().comm_prior_feature if variant == "ce" else None,
                hca=variant == "hca")


def evaluate_synthetic_dir(
    net,
    data_dir: str,
    size_name: str,
    n_graphs: int = 20,
    variant: str = "unit_cost",
    device=None,
) -> Tuple[float, float, float, float, float]:
    """Evaluate stored adj1_i.npy/adj2_i.npy pairs under data_dir/syn_<size>/
    (i = 0, 1, ... up to n_graphs or the first missing pair), each with its
    variant's structure (variant_options), dismantled greedily on `device`
    (CUDA unless named).

    Returns (score_mean, score_std, time_mean, time_std, cost_mean), the
    reference Evaluate's return contract (:600)."""
    device = resolve_device(device)
    net = net.to(device)
    scores, times, costs = [], [], []
    for i in range(n_graphs):
        a1 = os.path.join(data_dir, f"syn_{size_name}", f"adj1_{i}.npy")
        a2 = os.path.join(data_dir, f"syn_{size_name}", f"adj2_{i}.npy")
        if not (os.path.exists(a1) and os.path.exists(a2)):
            break
        adj1, adj2 = np.load(a1), np.load(a2)
        g = duplex_from_layers(adj1.shape[0], edges_from_dense_adj(adj1),
                               edges_from_dense_adj(adj2), device=device,
                               **variant_options(variant))
        t0 = time.time()
        sol, score, _ = dismantle_greedy(net, g, variant=variant)
        times.append(time.time() - t0)
        scores.append(score)
        costs.append(len(sol) / int(g.n_nodes))
    if not scores:
        raise FileNotFoundError(f"no synthetic pairs under {data_dir}/syn_{size_name}")
    return (
        float(np.mean(scores)), float(np.std(scores)),
        float(np.mean(times)), float(np.std(times)), float(np.mean(costs)),
    )


def evaluate_synthetic_generated(
    net,
    sizes: List[int],
    n_graphs: int = 20,
    variant: str = "unit_cost",
    seed: int = 0,
    g_corr: float = 0.5,
    gamma: float = 2.5,
    kbar: Optional[float] = None,
    device=None,
) -> List[dict]:
    """GMM graphs generated from `seed` (graphs whose intact LMCC is 1 are
    skipped), each with its variant's structure (variant_options),
    dismantled greedily on `device` (CUDA unless named); one result row per
    size."""
    device = resolve_device(device)
    net = net.to(device)
    rng = np.random.default_rng(seed)
    rows = []
    for n in sizes:
        scores, times, costs = [], [], []
        for _ in range(n_graphs):
            e0, e1 = gmm_duplex_edges(
                n, rng, g=g_corr, gamma1=gamma, gamma2=gamma, kbar1=kbar, kbar2=kbar
            )
            g = duplex_from_layers(n, e0, e1, device=device, **variant_options(variant))
            if int(g.max_rank) <= 1:
                continue
            t0 = time.time()
            sol, score, _ = dismantle_greedy(net, g, variant=variant)
            times.append(time.time() - t0)
            scores.append(score)
            costs.append(len(sol) / n)
        rows.append(_row(n, scores, times, costs))
    return rows


def evaluate_synthetic_sweep(
    net,
    sweep_param: str,
    values: List[float],
    size: int = 128,
    n_graphs: int = 20,
    variant: str = "unit_cost",
    seed: int = 0,
    device=None,
) -> List[dict]:
    """Sweep one GMM generator parameter (the reference's data_g /
    data_gamma / data_k dataset families, testSynthetic.py:14-39): angular
    correlation g, degree exponent gamma, or mean degree k̄, the others at
    g = 0.5, gamma = 2.5, k̄ from the generator.  Each value draws its
    graphs from `seed` afresh, as the JAX package's sweep.  One result row
    per value, with the value under `sweep_param`."""
    if sweep_param not in ("g", "gamma", "k"):
        raise ValueError(f"sweep_param must be g, gamma or k, got {sweep_param!r}")
    key = {"g": "g_corr", "gamma": "gamma", "k": "kbar"}[sweep_param]
    rows = []
    for v in values:
        kw = dict(g_corr=0.5, gamma=2.5, kbar=None)
        kw[key] = v
        (row,) = evaluate_synthetic_generated(
            net, [size], n_graphs=n_graphs, variant=variant, seed=seed,
            device=device, **kw,
        )
        row[sweep_param] = v
        rows.append(row)
    return rows


def write_result_rows(path: str, rows: List[dict], variant: str):
    """One `<size> <mean>±<std> time <s>s cost <c>` line per row."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(
                f"{r['size']} {r['score_mean']:.8f}±{r['score_std']:.8f} "
                f"time {r['time_mean']:.4f}s cost {r['cost_mean']:.6f}\n"
            )
