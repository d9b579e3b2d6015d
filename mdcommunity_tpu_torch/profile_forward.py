"""Where the time of one model call, or of one trainer iteration, goes on
the card.

Builds the `large_graph_demo` graph of each size (same generator and seed).
By default it runs a few warm-up model calls of the greedy loop (forward +
stable top-k + fetch), then profiles a steady window of them with
torch.profiler.  With --fit it runs the training loop of train_1m
(rl/big_trainer.py, k = 0.001·n) and profiles one iteration after the
warm-up ones: selection, host cascade, severs, target forward and the fit
(forward, backward, Adam).  Prints the device time by kernel, the host-clock
time, the device's busy share and the kernel launches.  --fast times the
model call of the fast eval (K1's and K2's bf16 modes, TF32 dense layers),
with h stored in --act-dtype (the counterpart of the JAX package's
scripts/bench_model_level.py act_dtype=bf16 runs).  With --dqn it profiles
the small-graph DQN trainer at Config()'s width instead (rl/dqn.DQNAgent,
after its pools and warm-up games): --calls fits, then one play_games(10)
at eps 0.9, each window on its own.

    python -m mdcommunity_tpu_torch.profile_forward --sizes 18222 1048576
    python -m mdcommunity_tpu_torch.profile_forward --fit --sizes 1048576
    python -m mdcommunity_tpu_torch.profile_forward --fast --act-dtype bfloat16
    python -m mdcommunity_tpu_torch.profile_forward --dqn --calls 50
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="models_tpu/unit_cost_full_r1/best_model.ckpt")
    ap.add_argument("--sizes", type=int, nargs="*", default=[18222, 1048576])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fit", action="store_true",
                    help="profile one trainer iteration instead of model calls")
    ap.add_argument("--fast", action="store_true",
                    help="the fast eval's model call (precise=False)")
    ap.add_argument("--act-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="storage of h in the fast eval")
    ap.add_argument("--dqn", action="store_true",
                    help="profile the small-graph DQN trainer's fit and play")
    args = ap.parse_args(argv)
    if args.dqn:
        return profile_dqn(args.calls, args.top)
    if args.fit and args.fast:
        ap.error("--fit profiles the precise trainer; --fast is for model calls")
    if args.act_dtype == "bfloat16" and not args.fast:
        ap.error("--act-dtype bfloat16 needs --fast (the precise eval stores f32)")
    warm = 3  # calls or iterations before the profiled ones

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop
    from mdcommunity_tpu_torch.utils.device import matmul_precision, resolve_device

    device = resolve_device(None)
    act_dtype = getattr(torch, args.act_dtype)
    net = load_model(args.model, device=device)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for n in args.sizes:
        e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
        banded, _, (o0, o1) = build_banded_duplex(n, e0, e1, max_rank=0, device=device)
        fuse = banded.spill_free
        k = max(int(0.001 * n), 1)

        if args.fit:
            env = make_host_env(n, o0, o1)
            sched = schedule(wait=0, warmup=warm, active=1, repeat=1)
            with profile(activities=activities, schedule=sched) as prof:
                _, hist = train_banded_loop(
                    net, banded, env, iters=warm + 1, k=k,
                    log=lambda *a: None, on_iter=lambda row: prof.step())
            row = [h for h in hist if "loss" in h][warm]
            wall, what = row["t_iter_s"], dict(iteration=row)
            reps = 1
        else:
            def call():
                with matmul_precision(not args.fast):
                    q = banded_test_forward(net, banded, ~banded.node_mask, fuse,
                                            precise=not args.fast, act_dtype=act_dtype)
                return top_k_stable(q, k)

            for _ in range(warm):
                call()
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    call()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            what = dict(calls=args.calls, call_ms=1e3 * wall / args.calls)
            reps = args.calls
        # device kernels only: ranges such as ProfilerStep*, BandSpmm or
        # Optimizer.step also appear on the device timeline, spanning kernels
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        busy_us = sum(e.self_device_time_total for e in events)
        print(json.dumps(dict(
            n=n, pad_n=banded.pad_n, fuse_sage=fuse, fit=args.fit,
            precise=not args.fast, act_dtype=args.act_dtype, **what,
            device_busy_ms=busy_us / 1e3 / reps,
            busy_share=busy_us / 1e6 / wall,
            kernel_launches=sum(e.count for e in events) / reps,
            device=torch.cuda.get_device_name(device),
        )), flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=args.top), flush=True)
        del banded


def _profiled(fn, reps):
    """(host-clock s, device kernel µs, kernel launches, profile) of fn()
    run reps times under torch.profiler, after a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    return (wall, sum(e.self_device_time_total for e in events),
            sum(e.count for e in events), prof)


def profile_dqn(fits: int, top: int):
    """The DQN trainer's fit and play windows (module doc): host ms, device
    busy ms and share, kernel launches, and the host-side operator count
    (aten calls) of one fit."""
    import dataclasses
    import tempfile

    import torch

    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.config import Config

    agent = DQNAgent(dataclasses.replace(Config(), max_iteration=1), device=None)
    with tempfile.TemporaryDirectory() as d:
        agent.train(save_dir=d, log=lambda *a: None)
    for _ in range(3):
        agent.fit()
    for what, fn, reps in (("fit", agent.fit, fits),
                           ("play", lambda: agent.play_games(10, 0.9), 1)):
        wall, busy_us, launches, prof = _profiled(fn, reps)
        ops = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::"))
        print(json.dumps(dict(
            dqn=what, reps=reps, host_ms=1e3 * wall / reps,
            device_busy_ms=busy_us / 1e3 / reps, busy_share=busy_us / 1e6 / wall,
            kernel_launches=launches / reps, aten_calls=ops / reps,
            device=torch.cuda.get_device_name(0))), flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=top),
              flush=True)


if __name__ == "__main__":
    main()
