"""Greedy dismantling of a large banded duplex, and AUDC scoring.

Reference call sites: GetSolution :711-736 (greedy rollout taking `step`
nodes per model call) and mvc_env.stepWithoutReward :74-87 (score +=
rank/(max_rank·N) per removal; the MaxCCList curve starts at [1]).

AUDC = Σ_t rank_t/(max_rank·N): the area under the normalised-LMCC curve.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.graphs.banded import BandedDuplex, apply_severs
from mdcommunity_tpu_torch.models.net import DuplexQNet, banded_test_forward
from mdcommunity_tpu_torch.utils.device import set_precise_matmul


def audc_from_curve(curve: List[float], n: int) -> float:
    """AUDC from a rank/max_rank curve (excluding the leading 1.0 entry)."""
    return float(np.sum(curve[1:]) / n)


def top_k_stable(q: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The k largest values of q and their indices, equal values lowest
    index first (jax.lax.top_k's order; torch.topk on CUDA promises no order
    among ties, and nodes with identical neighbourhoods give bit-equal Q)."""
    vals, order = torch.sort(q, descending=True, stable=True)
    return vals[:k].cpu().numpy(), order[:k].cpu().numpy()


def dismantle_greedy_banded(
    net: DuplexQNet,
    banded: BandedDuplex,
    env,
    step: int = 1,
    max_steps: Optional[int] = None,
    batch_env: bool = False,
    fuse_sage: Optional[bool] = None,
    stats: Optional[Dict[str, float]] = None,
) -> Tuple[List[int], float, List[float]]:
    """Greedy Q rollout on a large BandedDuplex with a host env.

    Each model call runs the banded Q forward on the banded duplex's device,
    in true f32, and takes its top `step` nodes; the cascade runs on the
    host.  Severs the env reports are applied to the band in place, so a
    BandedDuplex serves one rollout.

    step == 1 and not batch_env (StepRatio 0): sever -> cover -> forward ->
    top-1 per removal.  Otherwise the top `step` nodes are removed one by
    one (each with its own cascade), or with batch_env=True in ONE cascade
    per batch (env.step_many; the final state equals sequential stepping,
    and the curve takes the post-batch rank for each node of the batch,
    biasing AUDC by at most step/n).

    fuse_sage: run each message-passing round as the fused SAGE step
    (kernel K2); None decides per build, on the host: fused exactly when
    both layers' spill sets are empty, as the JAX package's packed engine
    decides.  stats, when given, receives the number of model calls and
    their total seconds (forward + top-k + the fetch that ends them).

    Returns (solution in banded ids, score = AUDC, curve)."""
    set_precise_matmul()
    fuse = banded.spill_free if fuse_sage is None else bool(fuse_sage)
    device = banded.device
    pad_n, n = banded.pad_n, env.n
    max_steps = max_steps or n
    sol: List[int] = []
    calls, call_s = 0, 0.0

    def apply(layer: int, ns: np.ndarray) -> None:
        # a cascade report of any size, the t≈0 one of a badly coupled graph
        # included, is one sever call: mirror and spill edges match by
        # sorted keys, so the JAX package's chunking (which bounds its
        # pairwise match matrix) has no counterpart here
        if len(ns):
            e = torch.from_numpy(np.asarray(ns, np.int64)).to(device)
            ok = torch.ones(len(ns), dtype=torch.bool, device=device)
            apply_severs(banded, layer, e[:, 0], e[:, 1], ok)

    def q_top(covered: torch.Tensor, k: int):
        nonlocal calls, call_s
        t0 = time.perf_counter()
        q = banded_test_forward(net, banded, covered, fuse_sage=fuse)
        out = top_k_stable(q, k)
        call_s += time.perf_counter() - t0
        calls += 1
        return out

    # sync the band with the edges the env severed at reset (the t=0
    # cascade usually severs some: the two layers' partitions rarely agree)
    for layer in range(2):
        apply(layer, env.edges[layer][env.sever[layer]])

    # covered stays on the device; the env only ever covers chosen nodes
    covered = torch.from_numpy(
        np.pad(env.covered, (0, pad_n - n), constant_values=True)
    ).to(device)

    if step == 1 and not batch_env:
        vals, order = q_top(covered, 1)
        while not env.terminal and len(sol) < max_steps:
            v, a = float(vals[0]), int(order[0])
            if not np.isfinite(v) or env.covered[a]:
                break
            _, new_sev = env.step(a)
            sol.append(a)
            if env.terminal or len(sol) >= max_steps:
                break
            for layer in range(2):
                apply(layer, new_sev[layer])
            covered[a] = True
            vals, order = q_top(covered, 1)
    else:
        while not env.terminal and len(sol) < max_steps:
            vals, order = q_top(covered, step)
            if batch_env and step > 1:
                # ONE cascade for the whole batch; keep the valid prefix of
                # the top-k, as the sequential loop does
                ok = np.isfinite(vals) & ~env.covered[order]
                cut = int(np.argmin(ok)) if not ok.all() else len(ok)
                acts = order[:cut][: max_steps - len(sol)]
                if len(acts) == 0:
                    break
                _, new_sev, _ = env.step_many(acts)
                sol.extend(int(a) for a in acts)
                covered[torch.from_numpy(acts.astype(np.int64)).to(device)] = True
                for layer in range(2):
                    apply(layer, new_sev[layer])
                continue
            for v, a in zip(vals, order):
                if env.terminal or len(sol) >= max_steps:
                    break
                if not np.isfinite(v) or env.covered[a]:
                    break
                _, new_sev = env.step(int(a))
                sol.append(int(a))
                covered[int(a)] = True
                for layer in range(2):
                    apply(layer, new_sev[layer])
    if stats is not None:
        stats.update(model_calls=calls, model_call_s=call_s, fuse_sage=fuse)
    return sol, float(env.score), list(env.curve)
