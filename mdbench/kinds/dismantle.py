"""Greedy dismantling cells: the window drives the program's own rollout,
mdcommunity_tpu_torch.eval.metrics.dismantle_greedy_banded, from removal 0.

Its `shadow` hook, called once a StepRatio batch before the batch's
cascade, gives the harness a timestamp a batch, the call's Q and the batch
it picks; a wrapper of the rollout's banded_test_forward marks where each
model call begins (the call runs to the hook: forward, top-k and the fetch
that ends them); the harness's env proxy times each cascade and, past
--seconds, stops: the rollout then ends at its next test.  The window
counts whole batches: from the call to the hook of the first batch past
the deadline.
A rollout that ends inside the window is followed by another on the
pristine build (restore_banded) and a reset env.

Traffic keys: n, avg_deg, shuffle, step_ratio, batch_env, precise,
fuse_sage (null: fused exactly when the build is spill-free), check
{samples, reach}: the batches whose state and Q the reference judges, batch
0 and samples − 1 drawn from the seed in [1, reach); trace {start,
batches, tries}: the stretch the traced run profiles.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from mdbench import common
from mdbench.trace import Tracer, band_time


def run(ctx: common.Ctx) -> None:
    from mdcommunity_tpu_torch.eval import metrics
    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import fork_banded, restore_banded
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    tr = ctx.traffic
    variant = ctx.config["variant"]
    k = max(int(ctx.n * tr["step_ratio"]), 1)
    precise = bool(tr["precise"])

    # ---- set-up: inputs, build, env, weights, one warm forward on a fork
    s = common.build(ctx)
    env = common.EnvProxy(common.host_env(ctx, s), tracing=ctx.trace)
    pristine = fork_banded(s.banded)
    fuse = s.banded.spill_free if tr["fuse_sage"] is None else bool(tr["fuse_sage"])
    covered0 = torch.from_numpy(np.pad(env.covered, (0, s.banded.pad_n - ctx.n),
                                       constant_values=True)).to(ctx.device)
    warm = fork_banded(s.banded)
    with matmul_precision(precise):
        q = banded_test_forward(s.net, warm, covered0, fuse_sage=fuse, precise=precise,
                                variant=variant)
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
    tracer = Tracer() if ctx.trace else None
    stretch = {"tries": 0, "at": None, "done": None}
    rollout = [0]
    deadline = [0.0]
    forward = metrics.banded_test_forward
    call_at = [0.0]
    call_s = []           # each model call outside the profiled stretch
    traced_calls = [0]

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
            _trace_step(j)
            batches[-1][3] = batches[-1][3] or stretch["at"] is not None

    def _trace_step(j):
        if stretch["at"] is None and stretch["done"] is None and j >= trace_cfg["start"] \
                and stretch["tries"] < trace_cfg["tries"]:
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
                stretch["done"] = dict(st=st, calls=calls, counts=counts, band_s=band_s,
                                       bands=stretch["bands"])

    metrics.banded_test_forward = timed_forward
    t_start = time.perf_counter()
    deadline[0] = t_start + ctx.seconds
    try:
        while True:
            metrics.dismantle_greedy_banded(
                s.net, s.banded, env, step=k, batch_env=tr["batch_env"],
                fuse_sage=tr["fuse_sage"], precise=precise, variant=variant, shadow=hook)
            if pending:
                caps[pending.pop()]["post"] = common.read_state(env)
            if env.stopped:
                break
            # the rollout ended inside the window: another from removal 0
            rollout[0] += 1
            restore_banded(s.banded, pristine)
            env._env.reset()
    finally:
        metrics.banded_test_forward = forward
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
        kind="dismantle", step_s=steps, cascade_s=cascades, call_s=call_s,
        traced_calls=traced_calls[0],
        n=ctx.n, k=k, stretch=stretch["done"],
    )
    if tracer is not None and ctx.device.type == "cuda":
        if stretch["done"] is None:
            raise RuntimeError("no traced stretch held the band kernels' device records")
        st = stretch["done"]["st"]
        ctx.busy_s, ctx.window_s = st.busy_s, st.wall_s
        ctx.breakdown = {"device_ops": st.device_ops, "idle_gaps": st.idle_gaps}

    # ---- the check, once the program's state is freed
    judge_edges = [np.array(e, copy=True) for e in env.edges]
    capd = {j: c for j, c in caps.items() if "post" in c}
    for c in capd.values():
        c["q"] = c["q"].cpu()
    del env, pristine, caps
    setup_keep = s
    setup_keep.banded = None
    setup_keep.net = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window")
    judge = common.Judge(ctx, setup_keep, judge_edges)
    q_err = pick_gap = 0.0
    cascade_gap = 0
    start_gap = judge.start_gap(capd[0]["pre"]) if 0 in capd else math.inf
    for j in sorted(capd):
        c = capd[j]
        state, _ = judge.to_ref(c["pre"])
        e, g = judge.q_gaps(c["q"], c["acts"], judge.q_ref(state), k)
        q_err, pick_gap = max(q_err, e), max(pick_gap, g)
        cascade_gap += judge.cascade_gap(c["pre"], c["acts"], c["post"])
    ctx.layer["checked_batches"] = sorted(capd)
    ctx.mark("check")
    lim = ctx.limits
    ok = [ctx.check("start_gap", start_gap, lim["start_gap"]),
          ctx.check("cascade_gap", cascade_gap, lim["cascade_gap"]),
          ctx.check("q_err", q_err, lim["q_err"]),
          ctx.check("pick_gap", pick_gap, lim["pick_gap"])]
    ctx.failed = 0 if all(ok) else 1
