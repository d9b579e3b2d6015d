"""DQN training on a 10^6-node duplex, on the card.

Builds the shuffled-id 2^20-node synthetic duplex of `large_graph_demo`
(the same generator and seed), warm-starts from a trained unit-cost
checkpoint, runs the banded training loop (rl/big_trainer.py: eps-greedy
StepRatio rollout, batched host cascade, TD targets, banded_train_loss
fits, target snapshots) on it, and measures greedy dismantling AUDC on the
same graph before and after.  The counterpart of the JAX package's
scripts/train_1m.py, with the same flags and phase lines.

    python -m mdcommunity_tpu_torch.train_1m [--n 1048576] [--iters 600] [-o DIR]

Prints one JSON line per phase (build, eval_before, train, checkpoint,
eval_after); writes the loop's history as JSONL and the trained weights
(models/checkpoint.save_params) to DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--k", type=int, default=1048)
    ap.add_argument("--model", default="models_tpu/unit_cost_full_r4/best_model.ckpt")
    ap.add_argument("--scratch", action="store_true",
                    help="random-init instead of warm-start")
    ap.add_argument("-o", "--output", default="runs/train1m")
    ap.add_argument("--avg-deg", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--eps-start", type=float, default=0.1)
    ap.add_argument("--eps-end", type=float, default=0.02)
    ap.add_argument("--target-update", type=int, default=100)
    ap.add_argument("--no-packed", action="store_true",
                    help="no fused SAGE steps (kernel K2) in the eval forward")
    ap.add_argument("--no-eval", action="store_true",
                    help="skip the greedy before/after AUDC evals")
    ap.add_argument("--skip-pre-eval", action="store_true",
                    help="skip only the before eval")
    ap.add_argument("--eval-k", type=int, default=None,
                    help="StepRatio batch of the greedy evals (default: --k)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy_banded
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex, fork_banded
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model, save_params
    from mdcommunity_tpu_torch.models.net import from_jax_params, init_params
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop
    from mdcommunity_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.scratch:
        net = from_jax_params(
            init_params(torch.Generator().manual_seed(args.seed)), device=device)
    else:
        net = load_model(args.model, device=device)
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(args.output, f"train1m_n{args.n}.jsonl")
    on_card = device.type == "cuda"

    with open(out_path, "w") as out:

        def emit(row):
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            out.flush()

        rng = np.random.default_rng(args.seed)
        t0 = time.time()
        e0, e1 = synth_duplex_edges(args.n, args.avg_deg, rng, shuffle=True)
        banded, _, (oe0, oe1) = build_banded_duplex(args.n, e0, e1, device=device)
        emit({"phase": "build", "n": args.n, "edges": int(len(e0) + len(e1)),
              "build_s": round(time.time() - t0, 1),
              "spill_free": banded.spill_free,
              "device": torch.cuda.get_device_name(device) if on_card else "cpu"})

        packed = not args.no_packed
        eval_k = args.eval_k or args.k

        def greedy_eval(model, tag):
            # the eval severs its band in place: it runs on a copy
            env_e = make_host_env(args.n, oe0, oe1)
            t1 = time.time()
            sol, score, _ = dismantle_greedy_banded(
                model, fork_banded(banded), env_e, step=eval_k, batch_env=True,
                fuse_sage=None if packed else False,
            )
            emit({"phase": f"eval_{tag}", "audc": round(score, 6),
                  "removals": len(sol), "solve_s": round(time.time() - t1, 1)})

        if not args.no_eval and not args.skip_pre_eval:
            greedy_eval(net, "before")

        env = make_host_env(args.n, oe0, oe1)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t2 = time.time()
        net2, hist = train_banded_loop(
            net, banded, env, iters=args.iters, k=args.k, lr=args.lr,
            eps_start=args.eps_start, eps_end=args.eps_end,
            target_update=args.target_update, packed=packed, seed=args.seed,
        )
        t_train = time.time() - t2
        for h in hist:
            out.write(json.dumps(h) + "\n")
        out.flush()
        rows = [h for h in hist if "loss" in h]
        losses = [h["loss"] for h in rows]
        split = ("t_select_s", "t_env_s", "t_sever_s", "t_target_s", "t_fit_s")
        emit({"phase": "train", "iters": len(rows),
              "fit_iters": int(np.isfinite(losses).sum()),
              "train_wall_s": round(t_train, 1),
              "t_iter_mean_s": float(np.mean([h["t_iter_s"] for h in rows])),
              "t_iter_p50_s": float(np.median([h["t_iter_s"] for h in rows])),
              "t_split_p50_s": {k: float(np.median([h[k] for h in rows])) for k in split},
              "loss_first": losses[0],
              "loss_first10": float(np.nanmean(losses[:10])),
              "loss_last10": float(np.nanmean(losses[-10:])),
              "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                               if on_card else None)})

        ckpt = os.path.join(args.output, f"train1m_n{args.n}.ckpt")
        save_params(ckpt, net2)
        emit({"phase": "checkpoint", "path": ckpt})

        if not args.no_eval:
            greedy_eval(net2, "after")


if __name__ == "__main__":
    main()
