"""Real multiplex network evaluation (reference EvaluateRealData :645-709 and
testReal.py): load a `.edges` multiplex, pick the coupled layer pair, run the
greedy dismantling rollout with stepRatio batching, and write the
reference's result files.

Graphs above `blocked_threshold` nodes take the large-graph path: locality
ordering, the dense-band forward on the card and the cascade on the host.
Graphs at or below it take the small-graph path: a padded DuplexGraph with
the forward and the cascade on the card (eval/metrics.dismantle_greedy, its
dense engine up to 2,048 padded nodes and the segment engine above).  Pass
blocked_threshold=0 to run every graph banded.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy, dismantle_greedy_banded
from mdcommunity_tpu_torch.eval.writers import (
    append_time_audc,
    write_lmcc_curve,
    write_solution,
)
from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
from mdcommunity_tpu_torch.graphs.io import (
    REAL_DATASETS,
    load_real_duplex,
    read_multiplex_edges,
)
from mdcommunity_tpu_torch.env.host_env import make_host_env
from mdcommunity_tpu_torch.utils.device import resolve_device


def evaluate_real(
    net,
    data_path: str,
    dataset: str,
    save_dir: str,
    step_ratio: float = 0.0,
    layers: Optional[Tuple[int, int]] = None,
    n_nodes: Optional[int] = None,
    blocked_threshold: int = 4096,
    batch_env: bool = False,
    fuse_sage: Optional[bool] = None,
    device=None,
    engine: str = "auto",
    stats: Optional[Dict] = None,
) -> Tuple[list, float, float]:
    """Dismantle one real dataset with a unit-cost DuplexQNet; returns
    (solution in original ids, solve_time, score).

    Output files (in <save_dir>/StepRatio_<r>/) mirror the reference:
      Soluion_<name>_<la><lb>.txt, NormalizedLMCC_<name>_<la><lb>.txt,
    and <save_dir>/time&audc_real.csv gains one row.
    device: where the forward runs (CUDA unless given); engine: the host
    env of the large-graph path (env/host_env.make_host_env).  stats, when
    given, receives the rollout's model-call counts and times, and on the
    large-graph path the host engine and the build's spill and mirror
    sizes."""
    device = resolve_device(device)
    if dataset in REAL_DATASETS:
        fname, n_default, pair_default = REAL_DATASETS[dataset]
    else:
        fname, n_default, pair_default = dataset, None, None
    n_nodes = n_nodes or n_default
    layers = layers or pair_default
    if n_nodes is None or layers is None:
        raise ValueError(f"unknown dataset {dataset}: pass n_nodes and layers")
    step = max(int(step_ratio * n_nodes), 1) if step_ratio > 0 else 1
    path = os.path.join(data_path, fname)
    net = net.to(device)
    if n_nodes <= blocked_threshold:
        g = load_real_duplex(path, n_nodes, layers, device=device)
        t0 = time.time()
        sol, score, curve = dismantle_greedy(net, g, step=step, stats=stats)
        solve_time = time.time() - t0
        max_rank = int(g.max_rank)
    else:
        raw = read_multiplex_edges(path, n_nodes)
        e0 = raw.get(layers[0], np.zeros((0, 2), np.int32))
        e1 = raw.get(layers[1], np.zeros((0, 2), np.int32))
        banded, perm, (oe0, oe1) = build_banded_duplex(n_nodes, e0, e1, device=device)
        env = make_host_env(n_nodes, oe0, oe1, engine=engine)
        t0 = time.time()
        sol, score, curve = dismantle_greedy_banded(
            net, banded, env, step=step, batch_env=batch_env, fuse_sage=fuse_sage,
            stats=stats,
        )
        solve_time = time.time() - t0
        sol = [int(perm[v]) for v in sol]  # back to original node ids
        max_rank = banded.max_rank
        if stats is not None:
            stats.update(
                host_env=env.engine,
                spill=(banded.dbg0.spill.nnz, banded.dbg1.spill.nnz),
                mirror_C=(banded.dbg0.C, banded.dbg1.C),
            )

    sub = os.path.join(save_dir, f"StepRatio_{step_ratio:.4f}")
    tag = f"{dataset.split('.')[0]}_{layers[0]}{layers[1]}"
    write_solution(os.path.join(sub, f"Soluion_{tag}.txt"), sol)
    # curve[0] is the leading 1.0; per-removal entries follow
    write_lmcc_curve(
        os.path.join(sub, f"NormalizedLMCC_{tag}.txt"),
        curve, n_nodes, max_rank, score_mean=score, score_std=0.0,
    )
    append_time_audc(
        os.path.join(save_dir, "time&audc_real.csv"), dataset, solve_time, score
    )
    return sol, solve_time, score
