"""Training cells: the window drives the program's own loop,
mdcommunity_tpu_torch.rl.big_trainer.train_banded_loop, from a fresh
episode with the configuration's checkpoint as the warm start.

Its `on_iter` hook gives the harness each iteration's history row as the
iteration ends.  The window opens at the first of them, so the loop's own
set-up (its forks of the build, the episode's reset, the copies of the
net) and its first iteration count as set-up; past --seconds the hook
raises the harness's WindowClosed, and the window counts the iterations
completed after it opened.  The harness's env proxy times each cascade and
keeps the first iterations' actions and states; a wrapper of the loop's
top_k_stable keeps the first selection's Q and picks; a global optimizer
hook (torch.optim's step post-hook) keeps Adam's state after the first
step and the parameters after the checked steps.

Traffic keys: n, avg_deg, shuffle, k, lr, eps_start, eps_end, iters (the
eps schedule's length), target_update, fits_per_step, alpha_recon, gamma,
packed, precise, check {steps}: the first steps the reference follows;
trace {start, iters, tries}: the stretch of iterations the traced run
profiles.
"""

from __future__ import annotations

import copy
import gc
import math
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from mdbench import common, reference as ref
from mdbench.trace import Tracer, band_time


class WindowClosed(Exception):
    """Raised from on_iter once the window's time is up."""


def run(ctx: common.Ctx) -> None:
    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import fork_banded
    from mdcommunity_tpu_torch.models.net import banded_test_forward, banded_train_loss
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.rl import big_trainer
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    tr = ctx.traffic
    variant = ctx.config["variant"]
    k, precise = int(tr["k"]), bool(tr["precise"])
    if ctx.n != tr["n"]:    # a rehearsal's graph: the same share of its nodes a batch
        k = max(round(k * ctx.n / tr["n"]), 2)
    steps = int(tr["check"]["steps"])

    # ---- set-up: inputs, build, env, weights, one warm forward and fit on a fork
    s = common.build(ctx)
    env = common.EnvProxy(common.host_env(ctx, s), tracing=ctx.trace)
    fuse = bool(tr["packed"]) and s.banded.spill_free
    warm = fork_banded(s.banded)
    covered0 = torch.from_numpy(np.pad(env.covered, (0, s.banded.pad_n - ctx.n),
                                       constant_values=True)).to(ctx.device)
    net_w = copy.deepcopy(s.net).requires_grad_(True)
    opt_w = torch.optim.Adam(net_w.parameters(), lr=tr["lr"])
    with matmul_precision(precise):
        q = banded_test_forward(net_w, warm, covered0, fuse_sage=fuse, precise=precise,
                                variant=variant)
    _, order = top_k_stable(q, k)
    acts = torch.from_numpy(order.astype(np.int64)).to(ctx.device)
    with matmul_precision(precise):
        loss = banded_train_loss(net_w, warm, covered0, acts,
                                 torch.zeros(k, device=ctx.device), alpha=tr["alpha_recon"],
                                 precise=precise, variant=variant)
        loss.backward()
    opt_w.step()
    del warm, q, net_w, opt_w, loss, acts
    ctx.sync()
    ctx.mark("warm-up")

    # ---- the window, from the end of the loop's first iteration
    names = [name for name, _ in s.net.named_parameters()]
    theta0 = {name: p.detach().double().cpu() for name, p in s.net.named_parameters()}
    cap = {"acts": [], "post": [], "pre0": None, "g0": None, "theta": None, "opt_steps": 0,
           "q0": None, "order0": None}
    top_k = big_trainer.top_k_stable

    def first_top_k(q, kk):
        """The loop's top-k; the first call's Q and order (iteration 0's
        selection) are kept for the check."""
        vals, order = top_k(q, kk)
        if cap["q0"] is None:
            cap["q0"], cap["order0"] = q.detach().clone(), np.array(order, copy=True)
        return vals, order

    def before_step(actions):
        if cap["pre0"] is None:
            cap["pre0"] = common.read_state(env._env)

    def after_step(actions):
        if len(cap["acts"]) < steps:
            cap["acts"].append(np.array(actions, np.int64, copy=True))
            cap["post"].append(common.read_state(env._env))

    env.before_step, env.after_step = before_step, after_step

    def opt_hook(opt, args, kwargs):
        cap["opt_steps"] += 1
        params = opt.param_groups[0]["params"]
        if cap["opt_steps"] == 1 and all("exp_avg" in opt.state.get(p, {}) for p in params):
            b1 = opt.param_groups[0]["betas"][0]
            cap["g0"] = {name: (opt.state[p]["exp_avg"] / (1 - b1)).detach().double().cpu()
                         for name, p in zip(names, params)}
        if cap["opt_steps"] == steps:
            cap["theta"] = {name: p.detach().double().cpu() for name, p in zip(names, params)}

    rows = []             # [on_iter time, row, traced]
    trace_cfg = tr.get("trace", {})
    tracer = Tracer() if ctx.trace else None
    stretch = {"tries": 0, "at": None, "done": None}
    deadline = [math.inf]

    def on_iter(row):
        now = time.perf_counter()
        rows.append([now, row, stretch["at"] is not None])
        if len(rows) == 1:
            deadline[0] = now + ctx.seconds
        if tracer is not None:
            _trace_step(len(rows))
            rows[-1][2] = rows[-1][2] or stretch["at"] is not None
        if now >= deadline[0]:
            raise WindowClosed

    def _trace_step(i):
        if stretch["at"] is None and stretch["done"] is None and i >= trace_cfg["start"] \
                and stretch["tries"] < trace_cfg["tries"]:
            stretch["launches"] = dict(bk.launches)
            stretch["at"] = i
            stretch["tries"] += 1
            tracer.start()
        elif stretch["at"] is not None and i - stretch["at"] >= trace_cfg["iters"]:
            t0 = time.perf_counter()
            st = tracer.stop()
            ctx.layer.setdefault("trace_read_s", []).append(time.perf_counter() - t0)
            deadline[0] += ctx.layer["trace_read_s"][-1]   # reading the trace is no window time
            traced = [r[1] for r in rows[stretch["at"]:i]]
            counts = {kk: bk.launches[kk] - stretch["launches"][kk] for kk in bk.launches}
            band_s = band_time(st, sum(counts.values()))
            stretch["at"] = None
            if st.device_events and band_s is not None:
                stretch["done"] = dict(
                    st=st, counts=counts, band_s=band_s, selects=len(traced),
                    targets=sum(1 for r in traced if r["maxq"] != 0.0),
                    fits=sum(1 for r in traced if not math.isnan(r["loss"])))

    handle = register_optimizer_step_post_hook(opt_hook)
    big_trainer.top_k_stable = first_top_k
    try:
        big_trainer.train_banded_loop(
            s.net, s.banded, env, iters=int(tr["iters"]), k=k, variant=variant, lr=tr["lr"],
            gamma=tr["gamma"], alpha_recon=tr["alpha_recon"], eps_start=tr["eps_start"],
            eps_end=tr["eps_end"], target_update=int(tr["target_update"]),
            fits_per_step=int(tr["fits_per_step"]), packed=bool(tr["packed"]),
            precise=precise, seed=ctx.seed, log=lambda *a, **kw: None, on_iter=on_iter)
    except WindowClosed:
        pass
    finally:
        big_trainer.top_k_stable = top_k
        handle.remove()
    ctx.sync()
    if stretch["at"] is not None:
        tracer.stop()
    ctx.memory_peak_bytes = (torch.cuda.max_memory_allocated(ctx.device)
                             if ctx.device.type == "cuda" else 0)
    if len(rows) < 2:
        raise RuntimeError("the loop ended before an iteration of the window")
    ctx.e2e["setup_s"] = rows[0][0] - ctx.t_process
    ctx.attempted = len(rows) - 1
    ctx.e2e["train_iter_ms"] = 1e3 * (rows[-1][0] - rows[0][0]) / ctx.attempted

    # ---- what the per-layer readers read
    if stretch["done"] is not None:
        stretch["done"]["bands"] = common.bands_of(s.banded)
    ctx.layer.update(kind="train", rows=[r[1] for r in rows[1:] if not r[2]], n=ctx.n, k=k,
                     stretch=stretch["done"])
    if tracer is not None and ctx.device.type == "cuda":
        if stretch["done"] is None:
            raise RuntimeError("no traced stretch held the band kernels' device records")
        st = stretch["done"]["st"]
        ctx.busy_s, ctx.window_s = st.busy_s, st.wall_s
        ctx.breakdown = {"device_ops": st.device_ops, "idle_gaps": st.idle_gaps}

    # ---- the check, once the program's state is freed
    judge_edges = [np.array(e, copy=True) for e in env.edges]
    losses = [r[1]["loss"] for r in rows[:steps]]
    if cap["q0"] is not None:
        cap["q0"] = cap["q0"].cpu()
    del env
    s.banded = None
    s.net = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("window")
    judge = common.Judge(ctx, s, judge_edges)
    gaps = follow(ctx, judge, cap, theta0, losses, k, steps)
    ctx.layer["leaves"] = {key: gaps[key] for key in ("dropped_leaves", "grad_leaves",
                                                      "update_leaves", "losses") if key in gaps}
    ctx.mark("check")
    lim = ctx.limits
    ok = [ctx.check(name, gaps[name], lim[name]) for name in
          ("start_gap", "cascade_gap", "q_err", "pick_gap", "loss_gap", "grad_gap",
           "update_gap")]
    ctx.failed = 0 if all(ok) else 1


def leaf_gaps(prog: dict, mine: dict, keep) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger, for the leaves in keep; the worst of them is compared."""
    norms = {name: float(torch.linalg.vector_norm(mine[name])) for name in keep}
    med = float(np.median(list(norms.values())))
    return {name: abs(float(torch.linalg.vector_norm(prog[name])) - norms[name])
            / max(norms[name], med) for name in keep}


def follow(ctx, judge: common.Judge, cap: dict, theta0: dict, losses, k: int,
           steps: int) -> dict:
    """The reference follows the program's first `steps` iterations from
    the intact graph: its own cascades of the program's actions (each
    against the program's state after it), its own targets (the target
    network is the starting weights), its own loss and gradient in float64
    and its own Adam.  Returns the numbers compared."""
    tr = ctx.traffic
    dev = judge.dev
    inf = math.inf
    out = {"start_gap": inf, "cascade_gap": inf, "q_err": inf, "pick_gap": inf,
           "loss_gap": inf, "grad_gap": inf, "update_gap": inf}
    if cap["pre0"] is None or len(cap["acts"]) < steps or len(losses) < steps:
        return out
    out["start_gap"] = judge.start_gap(cap["pre0"])
    st = judge.start()
    max_rank = st.rank
    n_edges = [len(e) for e in judge.edges]
    theta = dict(judge.params)
    target = ref.tensors(judge.params, dev)
    adam = ref.Adam(tr["lr"])
    cascade_gap, loss_gap, g_ref = 0, 0.0, None
    for t in range(steps):
        acts = judge.perm[cap["acts"][t]]
        inp = ref.inputs(st, n_edges, judge.weights, judge.cfg_ref, dev)
        if t == 0 and cap["q0"] is not None:
            # the first selection: its Q, and its greedy picks (the actions
            # the eps mixing left in the program's top-k)
            with torch.no_grad():
                q_r = ref.q_values(ref.tensors(judge.params, dev), inp)
            greedy = cap["acts"][0][np.isin(cap["acts"][0], cap["order0"])]
            out["q_err"], out["pick_gap"] = judge.q_gaps(cap["q0"], greedy, q_r, k,
                                                         of=len(cap["order0"]))
            del q_r
        nxt = ref.cascade(st.copy(), acts)
        theirs, bad = judge.to_ref(cap["post"][t])
        cascade_gap += ref.state_gap(nxt, theirs) + bad
        live = [(~L.sev & ~nxt.covered[L.u] & ~nxt.covered[L.v]).any() for L in nxt.layers]
        norm = nxt.rank / max(max_rank, 1)
        rewards = -norm * judge.cfg_ref.action_cost(acts, judge.weights, judge.n)
        maxq = 0.0
        if all(live):
            with torch.no_grad():
                q = ref.q_values(target, ref.inputs(nxt, n_edges, judge.weights,
                                                    judge.cfg_ref, dev))
            maxq = float(q.max())
        targets = torch.tensor(rewards + tr["gamma"] * maxq, dtype=torch.float64, device=dev)
        p = ref.tensors(theta, dev, grad=True)
        loss = ref.loss(p, inp, torch.from_numpy(acts).to(dev), targets, tr["alpha_recon"])
        loss.backward()
        g = {name: x.grad.detach() for name, x in p.items()}
        lv = float(loss.detach())
        loss_gap = max(loss_gap, abs(losses[t] - lv) / abs(lv) if lv else inf)
        out.setdefault("losses", []).append([losses[t], lv])
        if t == 0:
            g_ref = {name: x.cpu() for name, x in g.items()}
        theta = {name: x.cpu().numpy() for name, x in adam.step(
            {name: x.detach() for name, x in p.items()}, g).items()}
        st = nxt
        del p, loss, g, inp
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: a rule on the reference's gradient, not a name
    gn = {name: float(torch.linalg.vector_norm(x)) for name, x in g_ref.items()}
    med = float(np.median(list(gn.values())))
    keep = [name for name in gn if gn[name] >= 1e-3 * med]
    out["cascade_gap"], out["loss_gap"] = cascade_gap, loss_gap
    if cap["g0"] is not None:
        out["grad_leaves"] = leaf_gaps(cap["g0"], g_ref, keep)
        out["grad_gap"] = max(out["grad_leaves"].values())
    if cap["theta"] is not None:
        d_prog = {name: cap["theta"][name] - theta0[name] for name in keep}
        d_ref = {name: torch.from_numpy(theta[name]) - torch.from_numpy(judge.params[name])
                 for name in keep}
        out["update_leaves"] = leaf_gaps(d_prog, d_ref, keep)
        out["update_gap"] = max(out["update_leaves"].values())
    out["dropped_leaves"] = [name for name in gn if name not in keep]
    return out
