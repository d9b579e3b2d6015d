"""Synthetic evaluation sweep (reference: Evaluate :563-600 + testSynthetic.py).

Network sizes x GMM generator settings, on GMM graphs generated on the fly
from a seed (the JAX package's stream, graphs/gmm.py).  Reports AUDC mean/std, solve time and cost per
size, and writes rows in the reference's result-file format.  The model
runs on the graphs' device through eval/metrics.dismantle_greedy.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy
from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges
from mdcommunity_tpu_torch.graphs.io import duplex_from_layers
from mdcommunity_tpu_torch.utils.device import resolve_device


def _row(size, scores, times, costs) -> dict:
    def stat(fn, xs):
        return float(fn(xs)) if xs else float("nan")

    return dict(size=size, score_mean=stat(np.mean, scores),
                score_std=stat(np.std, scores), time_mean=stat(np.mean, times),
                cost_mean=stat(np.mean, costs))


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
    skipped), dismantled greedily on `device` (CUDA unless named); one
    result row per size."""
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
            g = duplex_from_layers(n, e0, e1, degree_cost=(variant == "degree_cost"),
                                   device=device)
            if int(g.max_rank) <= 1:
                continue
            t0 = time.time()
            sol, score, _ = dismantle_greedy(net, g, variant=variant)
            times.append(time.time() - t0)
            scores.append(score)
            costs.append(len(sol) / n)
        rows.append(_row(n, scores, times, costs))
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
