"""Result-file writers matching the reference's output formats byte-for-layout.

Reference formats (EvaluateRealData :645-709, testReal.py :88-95):
  Soluion_<name>_<la><lb>.txt        one removed node id per line
  NormalizedLMCC_<name>_<la><lb>.txt rank/max_rank per removal (padded with the
                                     1/max_rank floor up to N lines), then the
                                     score mean and std appended
  time&audc_<name>.csv               "name,time,audc" rows
(the "Soluion" typo is the reference's own and is preserved for drop-in
compatibility of downstream tooling like drawUnweight.py / analysis_comparison.py)
"""

from __future__ import annotations

import csv
import os
from typing import Sequence


def write_solution(path: str, solution: Sequence[int]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for a in solution:
            f.write(f"{int(a)}\n")


def write_lmcc_curve(
    path: str,
    curve: Sequence[float],
    n_nodes: int,
    max_rank: int,
    score_mean: float,
    score_std: float,
):
    """Curve entries per removal; pad to n_nodes lines with the 1/max_rank floor
    (reference :695-701), then append mean and std of the score."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for j in range(n_nodes):
            if j < len(curve):
                f.write(f"{float(curve[j]):.8f}\n")
            else:
                f.write(f"{1.0 / max_rank:.8f}\n")
        f.write(f"{score_mean:.8f}\n")
        f.write(f"{score_std:.8f}\n")


def append_time_audc(path: str, name: str, solve_time: float, audc: float):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["dataset", "time", "audc"])
        w.writerow([name, f"{solve_time:.6f}", f"{audc:.8f}"])


def write_cost_curve(path: str, weights, solution, n_nodes: int, score: float):
    """Degree-cost cumulative-cost curve (reference Cost_* file,
    MultiDismantler_degree_cost/MultiDismantler_torch.py:669-679): starts at 0,
    adds each node's normalized mean-layer weight in removal order (solution,
    then the surviving nodes except the last), and appends the final score."""
    import numpy as np

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    w = np.asarray(weights, np.float64)[:, :n_nodes]  # [2, n]
    tot = np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    per_node = (w / tot).mean(axis=0)  # (w0/Σw0 + w1/Σw1)/2
    removed = set(solution)
    order = list(solution) + [v for v in range(n_nodes) if v not in removed][:-1]
    with open(path, "w") as f:
        f.write("0.00000000\n")
        total = 0.0
        for v in order:
            total += per_node[v]
            f.write(f"{total:.8f}\n")
        f.write(f"{score:.8f}\n")
