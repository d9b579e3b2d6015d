"""Command-line entry points of the port (the JAX package's cli.py, for the
subcommands the port runs).

Usage:
  python -m mdcommunity_tpu_torch.cli train --variant {unit_cost,degree_cost,ce,hca} \\
      [--smoke] [--resume] [--save-dir DIR] [--seed S] [--max-iteration N] \\
      [--prioritized] [--gmm-g G]
  python -m mdcommunity_tpu_torch.cli test-real --model M --data DIR -o OUT \\
      [--variant V] [--datasets ...] [--step-ratio R] [--batch-env] [--packed] [--fast]
  python -m mdcommunity_tpu_torch.cli test-synthetic --model M [--variant V] [--sizes 32 64 ...]
  python -m mdcommunity_tpu_torch.cli test-synthetic --model M --sizes 128 \\
      --sweep-param g --sweep-values 0.1 0.5 0.9
  python -m mdcommunity_tpu_torch.cli check-features --variant {ce,hca} \\
      [--feature {boundary,participation}] [--size N] [--seed S]

A model is a JAX-package checkpoint (`models_tpu/*/best_model.ckpt`) or a
reference torch checkpoint.  Everything runs on the CUDA card unless --cpu
is given, which runs the plain PyTorch versions on the CPU.  The JAX
package's baseline, analyze, summarize-edges and draw subcommands are not
ported yet.  train, test-real and test-synthetic run every variant
(unit_cost, degree_cost, ce, hca; for the tests --variant names the
model's).  As in the JAX package there is no --fusion flag: a fusion mode
is Config(fusion=...) of rl/dqn.DQNAgent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _device(args):
    return "cpu" if args.cpu else None


def cmd_train(args):
    """The small-graph DQN trainer (rl/dqn.DQNAgent) with the JAX package's
    options, save directory and SMOKE_TEST handling."""
    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.config import Config, smoke_requested
    from mdcommunity_tpu_torch.utils.device import resolve_device

    import dataclasses as _dc

    device = resolve_device(_device(args))
    cfg = Config(variant=args.variant, seed=args.seed)
    over = {}
    if args.max_iteration:
        over["max_iteration"] = args.max_iteration
    if args.gmm_g is not None:
        over["gmm_g"] = None if args.gmm_g < 0 else args.gmm_g
    if args.prioritized:
        over["use_prioritized"] = True
    if over:
        cfg = _dc.replace(cfg, **over)
    smoke = args.smoke or smoke_requested()
    if smoke:
        cfg = cfg.smoke
    save_dir = args.save_dir or f"./models_tpu/{args.variant}_GMM_{cfg.num_min}_{cfg.num_max}"
    if smoke:
        save_dir += "_SMOKE"
    DQNAgent(cfg, device=device).train(save_dir=save_dir, resume=args.resume,
                                       log=lambda m: print(m, flush=True))


def cmd_test_real(args):
    from mdcommunity_tpu_torch.eval.real import evaluate_real
    from mdcommunity_tpu_torch.graphs.io import REAL_DATASETS
    from mdcommunity_tpu_torch.models.torch_convert import load_any_model
    from mdcommunity_tpu_torch.utils.device import resolve_device

    device = resolve_device(_device(args))
    net = load_any_model(args.model, device=device)
    names = args.datasets or list(REAL_DATASETS)
    os.makedirs(args.output, exist_ok=True)
    for name in names:
        stats = {}
        try:
            sol, t, score = evaluate_real(
                net, args.data, name, args.output,
                step_ratio=args.step_ratio, n_nodes=args.n_nodes,
                layers=tuple(args.layers) if args.layers else None,
                batch_env=args.batch_env,
                # --packed: the fused SAGE step (K2) where the build has no
                # spill; without it every round runs K1
                fuse_sage=None if args.packed else False,
                device=device, precise=not args.fast, stats=stats,
                variant=args.variant,
            )
            calls = stats["model_calls"]
            print(f"{name}: audc={score:.6f} time={t:.2f}s removed={len(sol)} "
                  f"model_calls={calls} "
                  f"model_call_ms={1e3 * stats['model_call_s'] / max(calls, 1):.3f}",
                  flush=True)
        except FileNotFoundError as e:
            print(f"{name}: SKIP ({e})", file=sys.stderr)


def cmd_test_synthetic(args):
    from mdcommunity_tpu_torch.eval.synthetic import (
        evaluate_synthetic_generated,
        evaluate_synthetic_sweep,
        write_result_rows,
    )
    from mdcommunity_tpu_torch.models.torch_convert import load_any_model
    from mdcommunity_tpu_torch.utils.device import resolve_device

    device = resolve_device(_device(args))
    net = load_any_model(args.model, device=device)
    if args.sweep_param:
        rows = evaluate_synthetic_sweep(
            net, args.sweep_param, args.sweep_values, size=args.sizes[0],
            n_graphs=args.n_graphs, variant=args.variant, device=device,
        )
    else:
        rows = evaluate_synthetic_generated(
            net, sizes=args.sizes, n_graphs=args.n_graphs, variant=args.variant,
            device=device,
        )
    out = args.output or f"./result_synthetic_{args.variant}.txt"
    write_result_rows(out, rows, args.variant)
    for r in rows:
        print(json.dumps(r))


def cmd_check_features(args):
    """Sanity check of CE's community prior or HCA's node features on a
    fresh GMM graph, with the JAX package's output (reference
    check_features.py: shape, range in [0, 1])."""
    import numpy as np

    from mdcommunity_tpu_torch.graphs.gmm import generate_pool
    from mdcommunity_tpu_torch.utils.device import resolve_device

    rng = np.random.default_rng(args.seed)
    prior = "hca" if args.variant == "hca" else args.feature
    (g,) = generate_pool(rng, 1, args.size, args.size, 64, 2048, False, prior,
                         device=resolve_device(_device(args)))
    if args.variant == "hca":
        feats = g.hca_feat.cpu().numpy()[: args.size]
        print("hca_feat shape (f_het, f_impact, f_roi):", feats.shape)
        print("first 5 rows:\n", feats[:5])
        print("f_het within [0,1]:", bool((feats[:, 0] >= 0).all() and (feats[:, 0] <= 1).all()))
    else:
        feats = g.node_feat.cpu().numpy()[:, : args.size]
        print("prior feature shape:", feats.shape)
        print("first 5 cols:\n", feats[:, :5])
        print("min:", feats.min(), "max:", feats.max())
        print("values within [0,1]:", bool((feats >= 0).all() and (feats <= 1).all()))


def main(argv=None):
    p = argparse.ArgumentParser(prog="mdcommunity_tpu_torch")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    # --cpu also accepted after the subcommand
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--cpu", action="store_true", default=argparse.SUPPRESS,
                        help="run on the CPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", parents=[common])
    t.add_argument("--variant", default="unit_cost",
                   choices=["unit_cost", "degree_cost", "ce", "hca"])
    t.add_argument("--smoke", action="store_true",
                   help="SMOKE_TEST sizes (Config.smoke)")
    t.add_argument("--resume", action="store_true",
                   help="continue from SAVE_DIR/latest.ckpt")
    t.add_argument("--save-dir", default=None)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--max-iteration", type=int, default=0,
                   help="override Config.max_iteration (0 = default)")
    t.add_argument("--prioritized", action="store_true",
                   help="prioritized replay sampling (IsPrioritizedSampling)")
    t.add_argument("--gmm-g", type=float, default=None,
                   help="GMM angular correlation; negative = U(0,1) per graph")
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("test-real", parents=[common])
    r.add_argument("--model", required=True)
    r.add_argument("--data", required=True, help="directory with .edges files")
    r.add_argument("-o", "--output", required=True)
    r.add_argument("--datasets", nargs="*", default=None)
    r.add_argument("--step-ratio", type=float, default=0.0)
    r.add_argument("--variant", default="unit_cost",
                   choices=["unit_cost", "degree_cost", "ce", "hca"],
                   help="the model's variant (its checkpoint's)")
    r.add_argument("--packed", action="store_true",
                   help="large-graph path: the fused SAGE step (kernel K2) "
                        "when the build has no spill")
    r.add_argument("--n-nodes", type=int, default=None,
                   help="node count for datasets not in the built-in table")
    r.add_argument("--layers", type=int, nargs=2, default=None,
                   help="coupled layer pair for datasets not in the table")
    r.add_argument("--batch-env", action="store_true",
                   help="ONE host cascade per StepRatio batch "
                        "(env.step_many; AUDC bias <= step/n)")
    r.add_argument("--fast", action="store_true",
                   help="bf16 eval forward (precise=False: K1/K2 bf16 modes, "
                        "TF32 dense layers); default is the f32-precise path")
    r.set_defaults(fn=cmd_test_real)

    s = sub.add_parser("test-synthetic", parents=[common])
    s.add_argument("--model", required=True)
    s.add_argument("--sizes", type=int, nargs="*",
                   default=[32, 64, 128, 256, 512, 1024])
    s.add_argument("--n-graphs", type=int, default=20)
    s.add_argument("--variant", default="unit_cost",
                   choices=["unit_cost", "degree_cost", "ce", "hca"],
                   help="the model's variant (its checkpoint's)")
    s.add_argument("-o", "--output", default=None)
    s.add_argument("--sweep-param", default=None, choices=["g", "gamma", "k"],
                   help="sweep a generator parameter instead of sizes "
                        "(reference data_g/data_gamma/data_k)")
    s.add_argument("--sweep-values", type=float, nargs="*",
                   default=[0.1, 0.3, 0.5, 0.7, 0.9])
    s.set_defaults(fn=cmd_test_synthetic)

    cf = sub.add_parser("check-features", parents=[common])
    cf.add_argument("--variant", default="ce", choices=["ce", "hca"])
    cf.add_argument("--feature", default="boundary", choices=["boundary", "participation"])
    cf.add_argument("--size", type=int, default=30)
    cf.add_argument("--seed", type=int, default=0)
    cf.set_defaults(fn=cmd_check_features)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
