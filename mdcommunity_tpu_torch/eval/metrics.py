"""Greedy dismantling rollouts and scoring (AUDC / normalised-LMCC curves).

Reference call sites: GetSolution :711-736 (greedy rollout taking `step`
nodes per model call), Test :738-755 (validation score + remaining/(max_rank·N))
and mvc_env.stepWithoutReward :74-87 (score += rank/(max_rank·N) per
removal; the MaxCCList curve starts at [1]).

`dismantle_greedy` runs a padded graph with the cascade on the device: the
dense engine (pad_n <= 2048), the segment engine, or over a BlockedDuplex
the blocked-pair kernel K4.  `dismantle_greedy_banded` runs a large
BandedDuplex with the cascade on the host.  Both run every variant (unit
cost, degree cost, CE, HCA) through the JAX package's routes.

AUDC = Σ_t rank_t/(max_rank·N): the area under the normalised-LMCC curve.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.env.env import batched_reset, batched_step
from mdcommunity_tpu_torch.graphs.banded import BandedDuplex, apply_severs
from mdcommunity_tpu_torch.graphs.blocked import BlockedDuplex
from mdcommunity_tpu_torch.graphs.duplex import DuplexGraph, stack_graphs
from mdcommunity_tpu_torch.models.hca_banded import banded_hca_forward
from mdcommunity_tpu_torch.models.net import (
    DuplexQNet,
    banded_test_forward,
    make_blocked_aggregate,
)
from mdcommunity_tpu_torch.rl.dqn import predict_q
from mdcommunity_tpu_torch.utils.device import matmul_precision, set_precise_matmul
from mdcommunity_tpu_torch.utils.profiling import span


def audc_from_curve(curve: List[float], n: int) -> float:
    """AUDC from a rank/max_rank curve (excluding the leading 1.0 entry)."""
    return float(np.sum(curve[1:]) / n)


def dismantle_greedy(
    net: DuplexQNet,
    g,
    step: int = 1,
    variant: str = "unit_cost",
    dense: Optional[bool] = None,
    max_steps: Optional[int] = None,
    syn_stop: bool = False,
    stats: Optional[Dict[str, float]] = None,
) -> Tuple[List[int], float, List[float]]:
    """Greedy Q rollout on one padded graph (a DuplexGraph, or a
    BlockedDuplex whose model calls aggregate through kernel K4), with the
    cascade on the graph's device.

    Removes the top-`step` nodes per model call (reference GetSolution's
    argsort(-pred)[:step]; a stable sort, so equal Q go lowest index first),
    with a cascade after each removal; max_steps is tested before each
    model call, as the JAX package tests it.  dense None picks the dense engine
    for pad_n <= 2048 and the segment engine above.  syn_stop=True stops
    once rank <= sqrt(N) (the baselines' `_syn` convention,
    hda_2max_syn.py:78-81).  stats, when given, receives the number of model
    calls and their total seconds (forward + fetch of Q).

    Returns (solution node list, score = AUDC, MaxCCList curve from 1.0)."""
    set_precise_matmul()
    aggregate_fn = None
    if isinstance(g, BlockedDuplex) and variant == "hca":
        raise ValueError("the blocked engine runs the base model's aggregation, not HCA's")
    if isinstance(g, BlockedDuplex):
        aggregate_fn = make_blocked_aggregate(g)
        g = g.g
        dense = False
    if dense is None:
        dense = g.pad_n <= 2048
    degree_cost = variant == "degree_cost"
    gb = stack_graphs([g])
    state = batched_reset(gb)
    sol: List[int] = []
    curve: List[float] = [1.0]
    n = int(g.n_nodes)
    max_rank = float(g.max_rank)
    max_steps = max_steps or n
    stop_rank = float(np.sqrt(n)) if syn_stop else 0.0
    calls, call_s = 0, 0.0

    while (not bool(state.terminal[0]) and len(sol) < max_steps
           and float(state.rank[0]) > stop_rank):
        t0 = time.perf_counter()
        q = predict_q(net, gb, state.covered, state.sever, variant, dense=dense,
                      aggregate_fn=aggregate_fn)
        q_np = q[0].cpu().numpy()
        call_s += time.perf_counter() - t0
        calls += 1
        order = np.argsort(-q_np, kind="stable")[:step]
        for a in order:
            if bool(state.terminal[0]) or float(state.rank[0]) <= stop_rank:
                break
            if not np.isfinite(q_np[a]):
                break
            act = torch.tensor([int(a)], device=gb.device)
            state, _ = batched_step(gb, state, act, degree_cost)
            sol.append(int(a))
            curve.append(float(state.rank[0]) / max_rank)
    if stats is not None:
        stats.update(model_calls=calls, model_call_s=call_s)
    return sol, float(state.score[0]), curve


def dismantle_batch_greedy(
    net: DuplexQNet, gb: DuplexGraph, variant: str = "unit_cost"
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy argmax rollout over a batch of graphs at once; returns
    (scores, covered counts)."""
    from mdcommunity_tpu_torch.rl.dqn import greedy_rollout

    set_precise_matmul()
    state = greedy_rollout(net, gb, batched_reset(gb), variant,
                           degree_cost=variant == "degree_cost")
    covered_cnt = torch.sum(state.covered & gb.node_mask, dim=1)
    return state.score.cpu().numpy(), covered_cnt.cpu().numpy()


def validation_score(score: float, n: int, covered: int, max_rank: int) -> float:
    """Reference Test() metric: rollout score + untouched-node tail."""
    return score + (n - covered) / (max_rank * n)


def solution_robustness(g: DuplexGraph, solution: List[int], degree_cost: bool = False):
    """Score a full removal order by replaying it against the cascade
    (reference: Utils.getRobustness, utils.py:53-97, which rebuilds the
    duplex in reverse insertion order; replaying forward over the same order
    visits identical states).  Returns (score = AUDC, normalised-LMCC curve)."""
    gb = stack_graphs([g])
    state = batched_reset(gb)
    curve = []
    max_rank = float(g.max_rank)
    for a in solution:
        if bool(state.terminal[0]):
            break
        act = torch.tensor([int(a)], device=gb.device)
        state, _ = batched_step(gb, state, act, degree_cost)
        curve.append(float(state.rank[0]) / max_rank)
    return float(state.score[0]), curve


def reinsert_solution(g: DuplexGraph, solution: List[int], each_step: int = 1) -> List[int]:
    """Greedy reinsertion post-processing (reference: Utils.reInsert :12-51;
    the strategy is the standard component-merge count): starting from the
    dismantled graph, re-add the removed nodes that merge the fewest
    components (union of both layers) first, and return the reversed
    insertion order as the improved removal order."""
    n = int(g.n_nodes)
    src, dst, em = (t.cpu().numpy() for t in (g.src, g.dst, g.edge_mask))
    adj = [[] for _ in range(n)]
    for l in range(2):
        for s, d in zip(src[l][em[l]], dst[l][em[l]]):
            adj[int(s)].append(int(d))

    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def attach(v):
        for u in adj[v]:
            if present[u]:
                ra, rb = find(v), find(u)
                if ra != rb:
                    parent[ra] = rb

    present = np.zeros(n, bool)
    removed = set(solution)
    keep = [v for v in range(n) if v not in removed]
    present[keep] = True
    for v in keep:
        attach(v)

    left = list(dict.fromkeys(int(v) for v in solution))
    inserted = []
    while left:
        scored = sorted((len({find(u) for u in adj[v] if present[u]}), v) for v in left)
        for _, v in scored[:each_step]:
            left.remove(v)
            inserted.append(v)
            present[v] = True
            attach(v)
    inserted.reverse()
    return inserted


SENTINEL = -1e8  # below it, an HCA node the decoder left unselected (Q = -1e9·w)


def tie_scale(q: np.ndarray, i: int, j: int) -> Optional[float]:
    """The scale a gap between q[i] and q[j] is read against, to tell an
    f32 near-tie (a gap under about 1e-5 of it) from a real difference:
    max|Q| over the finite Q above SENTINEL when both lie above it (every
    Q of the base variants), |Q| itself when both lie below it (HCA's
    unselected nodes at -1e9·w, where the f32 spacing is 32-64 and a gap
    of a few spacings is rounding), None (no tie) when they straddle it."""
    qi, qj = float(q[i]), float(q[j])
    if qi > SENTINEL and qj > SENTINEL:
        fin = np.isfinite(q) & (q > SENTINEL)
        return float(np.abs(q[fin]).max())
    if qi <= SENTINEL and qj <= SENTINEL:
        return max(abs(qi), abs(qj))
    return None


def top_k_stable(q: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The k largest values of q and their indices, equal values lowest
    index first (jax.lax.top_k's order; torch.topk on CUDA promises no order
    among ties, and nodes with identical neighbourhoods give bit-equal Q)."""
    vals, order = torch.sort(q, descending=True, stable=True)
    return vals[:k].cpu().numpy(), order[:k].cpu().numpy()


def _comm_launches() -> int:
    """Launches of the HCA community pass so far (ops/hca_kernels: one a
    layer a call)."""
    from mdcommunity_tpu_torch.ops.hca_kernels import launches

    return sum(launches.values())


def dismantle_greedy_banded(
    net: DuplexQNet,
    banded: BandedDuplex,
    env,
    step: int = 1,
    max_steps: Optional[int] = None,
    batch_env: bool = False,
    fuse_sage: Optional[bool] = None,
    stats: Optional[Dict[str, float]] = None,
    precise: bool = True,
    act_dtype: torch.dtype = torch.float32,
    shadow: Optional[Callable] = None,
    variant: str = "unit_cost",
    hca_data=None,
) -> Tuple[List[int], float, List[float]]:
    """Greedy Q rollout on a large BandedDuplex with a host env.

    Each model call runs the banded Q forward on the banded duplex's device
    and takes its top `step` nodes.  The env's cascade runs on the same
    device: the loop calls env.to(banded.device) first (the native engine
    moves its cascade onto a card in place, native.NativeDuplexEnv.to; on
    the CPU it stays the C++ engine).  precise
    (default True): the forward runs in true f32, aggregation operands and
    dense layers (TF32 off).  precise=False is the JAX package's fast eval:
    K1's and K2's bf16 modes, h stored in `act_dtype`, dense layers in TF32.
    Greedy quality is sensitive to that rounding (RESULTS.md:244-270), so it
    is a throughput knob only.  The matmul flags are set for each forward
    and restored after it (utils/device.matmul_precision).  Severs the env
    reports are applied to the band in place, so a BandedDuplex serves one
    rollout.

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
    their total seconds (forward + top-k + the fetch that ends them), the
    mode (fuse_sage, precise, act_dtype), and under "batches" one row per
    model call: host seconds of utils/profiling.span, t_call_s (the call),
    t_env_s (the env steps of its batch), t_sever_s (the covered update and
    the band's severs, with no wait for the card), and the env's
    cascade_stats (summed over the batch's cascades, but on_device, 1 when
    the card ran them; none when the env removed nothing).

    shadow, when given, watches a batch_env rollout (step > 1) without
    changing it: each model call, before its batch is taken, it is called
    as shadow(env, q, covered, acts) with the host env, the call's Q and
    covered mask (on the device) and the nodes the batch takes
    (chip_smoke.py holds the main path to the CPU's forward through it).
    Its seconds are kept out of model_call_s and given as stats["shadow_s"].

    variant: "unit_cost", "degree_cost" and "ce" run banded_test_forward
    with that variant's inputs (the band holds the weights and the prior);
    degree cost also scores each removal by its cost (env.step(a,
    degree_cost=True)).  "hca" needs hca_data (models/hca_banded.HcaBandData
    in banded order) and runs banded_hca_forward: K1 for its pooling,
    ops/hca_kernels.comm_adj for its community pass, never the fused step,
    f32 storage only; its rows add the forward's spans (hca_node_pool,
    hca_comm_graph, hca_decode) and the counters n_comms (a layer), c_pad
    and comm_launches (the community pass's launches of the call,
    hca_kernels.launches: 2 on the card, 0 on the CPU).

    Returns (solution in banded ids, score = AUDC, curve)."""
    if shadow is not None and not (batch_env and step > 1):
        raise ValueError("shadow watches batch_env rollouts with step > 1")
    hca = variant == "hca"
    if hca and (hca_data is None or act_dtype != torch.float32 or fuse_sage):
        raise ValueError("variant='hca' needs hca_data, f32 storage and no fused step")
    degree_cost = variant == "degree_cost"
    fuse = (not hca) and (banded.spill_free if fuse_sage is None else bool(fuse_sage))
    device = banded.device
    env.to(device)
    pad_n, n = banded.pad_n, env.n
    max_steps = max_steps or n
    sol: List[int] = []
    rows: List[dict] = []
    shadow_s = 0.0

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
        """One model call; its row is rows[-1] (the rows are kept for stats
        only)."""
        if stats is None:
            rows.clear()
        row: dict = {}
        rows.append(row)
        with span(row, "t_call_s"):
            with matmul_precision(precise):
                if hca:
                    before = _comm_launches()
                    q = banded_hca_forward(net, banded, hca_data, covered, precise=precise,
                                           row=row)
                    row.update(n_comms=list(hca_data.n_comms), c_pad=hca_data.c_pad,
                               comm_launches=_comm_launches() - before)
                else:
                    q = banded_test_forward(net, banded, covered, fuse_sage=fuse,
                                            precise=precise, act_dtype=act_dtype,
                                            variant=variant)
            vals, order = top_k_stable(q, k)
        return vals, order, q

    def count(counts: Dict[str, int]) -> None:
        row = rows[-1]
        for key, v in counts.items():
            row[key] = v if key == "on_device" else row.get(key, 0) + v

    # sync the band with the edges the env severed at reset (the t=0
    # cascade usually severs some: the two layers' partitions rarely agree)
    for layer in range(2):
        apply(layer, env.edges[layer][env.sever[layer]])

    # covered stays on the device; the env only ever covers chosen nodes
    covered = torch.from_numpy(
        np.pad(env.covered, (0, pad_n - n), constant_values=True)
    ).to(device)

    if step == 1 and not batch_env:
        vals, order, _ = q_top(covered, 1)
        while not env.terminal and len(sol) < max_steps:
            v, a = float(vals[0]), int(order[0])
            if not np.isfinite(v) or env.covered[a]:
                break
            with span(rows[-1], "t_env_s"):
                _, new_sev = env.step(a, degree_cost=degree_cost)
            count(env.cascade_stats)
            sol.append(a)
            if env.terminal or len(sol) >= max_steps:
                break
            with span(rows[-1], "t_sever_s"):
                for layer in range(2):
                    apply(layer, new_sev[layer])
                covered[a] = True
            vals, order, _ = q_top(covered, 1)
    else:
        while not env.terminal and len(sol) < max_steps:
            vals, order, q = q_top(covered, step)
            if batch_env and step > 1:
                # ONE cascade for the whole batch; keep the valid prefix of
                # the top-k, as the sequential loop does
                ok = np.isfinite(vals) & ~env.covered[order]
                cut = int(np.argmin(ok)) if not ok.all() else len(ok)
                acts = order[:cut][: max_steps - len(sol)]
                if shadow is not None:
                    t0 = time.perf_counter()
                    shadow(env, q, covered, acts)
                    shadow_s += time.perf_counter() - t0
                if len(acts) == 0:
                    break
                with span(rows[-1], "t_env_s"):
                    _, new_sev, removed = env.step_many(acts, degree_cost=degree_cost)
                if removed:
                    count(env.cascade_stats)
                sol.extend(int(a) for a in acts)
                with span(rows[-1], "t_sever_s"):
                    covered[torch.from_numpy(acts.astype(np.int64)).to(device)] = True
                    for layer in range(2):
                        apply(layer, new_sev[layer])
                continue
            for v, a in zip(vals, order):
                if env.terminal or len(sol) >= max_steps:
                    break
                if not np.isfinite(v) or env.covered[a]:
                    break
                with span(rows[-1], "t_env_s"):
                    _, new_sev = env.step(int(a), degree_cost=degree_cost)
                count(env.cascade_stats)
                sol.append(int(a))
                with span(rows[-1], "t_sever_s"):
                    covered[int(a)] = True
                    for layer in range(2):
                        apply(layer, new_sev[layer])
    if stats is not None:
        stats.update(model_calls=len(rows), model_call_s=sum(r["t_call_s"] for r in rows),
                     shadow_s=shadow_s, fuse_sage=fuse, precise=precise,
                     act_dtype=str(act_dtype).replace("torch.", ""), variant=variant,
                     batches=rows)
    return sol, float(env.score), list(env.curve)
