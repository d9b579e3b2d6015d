"""HCA-Dismantler greedy dismantling cells: the program's HCA path as
eval/real.evaluate_real takes it, hca_communities_and_features (each
layer's Louvain partition and the node features, set-up) ->
make_hca_band_data (at the configuration's c_pad) ->
dismantle_greedy_banded(variant="hca"), from removal 0.

The window is counted as in kinds/dismantle.py: whole batches, from the
call to the shadow hook of the first batch past --seconds, a rollout that
ends inside it followed by another on the pristine build.  A wrapper of
the rollout's banded_hca_forward marks where each model call begins (the
call runs to the hook: forward, top-k and the fetch that ends them).

The check (mdbench/reference_hca.py, float64, from the generated edges,
the program's partition and the checkpoint) at batch 0 and samples − 1
batches drawn from the seed in [1, reach): start_gap and cascade_gap
exact; sel_gap, the nodes whose per-layer community selection differs
from the reference's outside the near-ties (communities whose reference
score lies within sel_tie · max |score| of the k_top-th); q_err, max |ΔQ|
/ max |Q| over the nodes both layers select; pick_gap.

Traffic keys: those of kinds/dismantle.py (fuse_sage false: HCA has no
fused step).  A run at another size than the traffic's n (a rehearsal or
a test) sizes the community tables to its own count.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from mdbench import common
from mdbench.trace import band_time

RANGES = ("hca_comm_graph", "hca_node_pool", "hca_decode")


def run(ctx: common.Ctx) -> None:
    # the program's HCA entry points first: a program without them stops here
    from mdcommunity_tpu_torch.graphs.louvain import louvain_labels  # noqa: F401
    from mdcommunity_tpu_torch.graphs.hca import hca_communities_and_features
    from mdcommunity_tpu_torch import native

    lib = native.load()
    if lib is None or not hasattr(lib, "mdc_louvain_create"):
        raise RuntimeError("the program's native Louvain is not available")

    from mdbench import reference_hca
    from mdbench.trace_ranges import RangeTracer
    from mdcommunity_tpu_torch.eval import metrics
    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import fork_banded, restore_banded
    from mdcommunity_tpu_torch.models.hca_banded import COMM_CHUNK, make_hca_band_data
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    tr, cfg = ctx.traffic, ctx.config
    k = max(int(ctx.n * tr["step_ratio"]), 1)
    precise = bool(tr["precise"])

    # ---- set-up: inputs, build, communities and features, env, weights, warm forward
    s = common.build(ctx)
    comm_stats: dict = {}
    comm_id, n_comms, feat = hca_communities_and_features(
        ctx.n, s.edges[0], s.edges[1], seed=cfg["community"]["seed"], stats=comm_stats)
    ctx.mark("communities")
    c_pad = cfg["c_pad"] if ctx.n == int(tr["n"]) else None
    hd = make_hca_band_data(comm_id, n_comms, feat, s.perm, s.banded.pad_n, c_pad=c_pad,
                            device=ctx.device)
    env = common.EnvProxy(common.host_env(ctx, s), tracing=ctx.trace)
    pristine = fork_banded(s.banded)
    covered0 = torch.from_numpy(np.pad(env.covered, (0, s.banded.pad_n - ctx.n),
                                       constant_values=True)).to(ctx.device)
    warm = fork_banded(s.banded)
    with matmul_precision(precise):
        q = metrics.banded_hca_forward(s.net, warm, hd, covered0, precise=precise)
    top_k_stable(q, k)
    del warm, q
    ctx.sync()
    ctx.mark("warm-up")
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_process

    # ---- the window
    rng = np.random.default_rng([ctx.seed, 1])
    reach = max(2, int(tr["check"]["reach"]))
    picks = rng.choice(np.arange(1, reach), size=min(tr["check"]["samples"] - 1, reach - 1),
                       replace=False)
    sample = {0, *map(int, picks)}
    caps, pending = {}, []
    batches = []          # [hook time, batch size, rollout, traced]
    trace_cfg = tr.get("trace", {})
    tracer = RangeTracer(RANGES) if ctx.trace else None
    stretch = {"tries": 0, "at": None, "done": None}
    rollout = [0]
    deadline = [0.0]
    forward = metrics.banded_hca_forward
    call_at = [0.0]
    call_s = []           # each model call outside the profiled stretch
    traced_calls = [0]
    rows = []             # the rollouts' stats rows, a model call each

    def timed_forward(*args, **kwargs):
        call_at[0] = time.perf_counter()
        return forward(*args, **kwargs)

    def hook(env_, q, covered, acts):
        now = time.perf_counter()
        j = len(batches)
        if stretch["at"] is None:
            call_s.append(now - call_at[0])
        else:
            traced_calls[0] += 1
        batches.append([now, len(acts), rollout[0], stretch["at"] is not None])
        while pending:      # the state after the previous batch
            caps[pending.pop()]["post"] = common.read_state(env_)
        if now >= deadline[0]:
            env.stopped = True
            return
        if rollout[0] == 0 and j in sample:
            caps[j] = {"pre": common.read_state(env_), "q": q.detach().clone(),
                       "acts": np.array(acts, copy=True)}
            pending.append(j)
        if tracer is not None:
            _trace_step(j, env_)
            batches[-1][3] = batches[-1][3] or stretch["at"] is not None

    def _trace_step(j, env_):
        if stretch["at"] is None and stretch["done"] is None and j >= trace_cfg["start"] \
                and stretch["tries"] < trace_cfg["tries"]:
            st0 = common.read_state(env_)
            cov = st0.covered
            stretch["live_edges"] = [
                int(np.sum(~sev & ~cov[e[:, 0]] & ~cov[e[:, 1]]))
                for sev, e in zip(st0.sever, env_.edges)]
            stretch["bands"] = common.bands_of(s.banded)
            stretch["launches"] = dict(bk.launches)
            stretch["at"] = j
            stretch["tries"] += 1
            tracer.start()
        elif stretch["at"] is not None and j - stretch["at"] >= trace_cfg["batches"]:
            t0 = time.perf_counter()
            st = tracer.stop()
            ctx.layer.setdefault("trace_read_s", []).append(time.perf_counter() - t0)
            deadline[0] += ctx.layer["trace_read_s"][-1]   # reading the trace is no window time
            calls = j - stretch["at"]
            counts = {kk: bk.launches[kk] - stretch["launches"][kk] for kk in bk.launches}
            band_s = band_time(st, sum(counts.values()))
            stretch["at"] = None
            if st.device_events and band_s is not None:
                stretch["done"] = dict(
                    st=st, calls=calls, counts=counts, band_s=band_s, bands=stretch["bands"],
                    live_edges=stretch["live_edges"], range_s=dict(tracer.range_s),
                    placed=tracer.placed, lost=tracer.lost, c_pad=hd.c_pad,
                    n_comms=list(hd.n_comms),
                    comm_widths=[min(COMM_CHUNK, hd.c_pad - c0)
                                 for c0 in range(0, hd.c_pad, COMM_CHUNK)])

    metrics.banded_hca_forward = timed_forward
    t_start = time.perf_counter()
    deadline[0] = t_start + ctx.seconds
    try:
        while True:
            stats: dict = {}
            try:
                metrics.dismantle_greedy_banded(
                    s.net, s.banded, env, step=k, batch_env=tr["batch_env"], fuse_sage=False,
                    precise=precise, variant="hca", hca_data=hd, shadow=hook, stats=stats)
            finally:
                rows.extend(stats.get("batches", []))
            if pending:
                caps[pending.pop()]["post"] = common.read_state(env)
            if env.stopped:
                break
            # the rollout ended inside the window: another from removal 0
            rollout[0] += 1
            restore_banded(s.banded, pristine)
            env._env.reset()
    finally:
        metrics.banded_hca_forward = forward
    ctx.sync()
    if stretch["at"] is not None:
        tracer.stop()
    t_end = batches[-1][0]
    ctx.memory_peak_bytes = (torch.cuda.max_memory_allocated(ctx.device)
                             if ctx.device.type == "cuda" else 0)
    done = batches[:-1]
    window_s = t_end - t_start
    removals = sum(b[1] for b in done)
    ctx.attempted = len(done)
    ctx.e2e["removals_per_s"] = removals / window_s

    # ---- what the per-layer readers read
    steps = [b1[0] - b0[0] for b0, b1 in zip(batches[:-1], batches[1:])
             if b0[2] == b1[2] and not b0[3]]
    cascades = [c for c, b in zip(env.cascade_s, batches) if not b[3]]
    ctx.layer.update(
        kind="dismantle_hca", step_s=steps, cascade_s=cascades, call_s=call_s,
        traced_calls=traced_calls[0], n=ctx.n, k=k, stretch=stretch["done"],
        louvain_s=comm_stats.get("louvain_s"), louvain_levels=comm_stats.get("louvain_levels"),
        louvain_moves=comm_stats.get("louvain_moves"), hca_feat_s=comm_stats.get("hca_feat_s"),
        n_comms=list(hd.n_comms), c_pad=hd.c_pad,
        comm_launches=[r.get("comm_launches") for r in rows[:3]],
    )
    if tracer is not None and ctx.device.type == "cuda":
        if stretch["done"] is None:
            raise RuntimeError("no traced stretch held the band kernels' device records")
        st = stretch["done"]["st"]
        ctx.busy_s, ctx.window_s = st.busy_s, st.wall_s
        ctx.breakdown = {"device_ops": st.device_ops, "idle_gaps": st.idle_gaps,
                         "ranges_s": stretch["done"]["range_s"],
                         "kernels_placed": stretch["done"]["placed"],
                         "kernels_unplaced": stretch["done"]["lost"]}

    # ---- the check, once the program's state is freed
    judge_edges = [np.array(e, copy=True) for e in env.edges]
    capd = {j: c for j, c in caps.items() if "post" in c}
    for c in capd.values():
        c["q"] = c["q"].cpu()
    del env, pristine, caps, hd
    setup_keep = s
    setup_keep.banded = None
    setup_keep.net = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window")
    lim = ctx.limits
    judge = common.Judge(ctx, setup_keep, judge_edges)
    href = reference_hca.HcaReference(ctx.n, s.edges, comm_id, judge.params, judge.cfg_ref,
                                      ctx.device, top_frac=cfg["top_frac"],
                                      rounds=cfg["max_bp_iter"])
    perm = torch.from_numpy(s.perm)
    q_err = pick_gap = 0.0
    sel_gap = cascade_gap = excused = 0
    start_gap = judge.start_gap(capd[0]["pre"]) if 0 in capd else math.inf
    for j in sorted(capd):
        c = capd[j]
        state, _ = judge.to_ref(c["pre"])
        qp = torch.empty(ctx.n, dtype=torch.float64)
        qp[perm] = c["q"][: ctx.n].double()
        g = reference_hca.gaps(href.forward(state), href.cid, qp,
                               perm[torch.from_numpy(c["acts"].astype(np.int64))], k,
                               lim["sel_tie"])
        sel_gap += g.sel_gap
        excused += g.excused
        q_err, pick_gap = max(q_err, g.q_err), max(pick_gap, g.pick_gap)
        cascade_gap += judge.cascade_gap(c["pre"], c["acts"], c["post"])
    ctx.layer.update(checked_batches=sorted(capd), near_ties_excused=excused)
    ctx.mark("check")
    ok = [ctx.check("start_gap", start_gap, lim["start_gap"]),
          ctx.check("cascade_gap", cascade_gap, lim["cascade_gap"]),
          ctx.check("sel_gap", sel_gap, lim["sel_gap"]),
          ctx.check("q_err", q_err, lim["q_err"]),
          ctx.check("pick_gap", pick_gap, lim["pick_gap"])]
    ctx.failed = 0 if all(ok) else 1
