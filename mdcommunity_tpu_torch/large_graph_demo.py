"""Large-graph dismantling demo on synthetic duplex networks.

The reference ships no real multiplex data, so this demo runs the whole
testReal pipeline (eval/real.py: locality ordering, dense-band forward on
the card, host cascade) on synthetic duplexes of the real datasets' scale,
written in the reference's `.edges` format.  The generator and its seed
stream are the JAX package's (scripts/large_graph_demo.py), so a size gives
the same graph in both packages.

Usage:
    python -m mdcommunity_tpu_torch.large_graph_demo --sizes 18222
    python -m mdcommunity_tpu_torch.large_graph_demo --sizes 1048576 \\
        --step-ratio 0.001 --batch-env
    python -m mdcommunity_tpu_torch.large_graph_demo --sizes 18222 --fast --packed

Prints one JSON line per size.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def synth_duplex_edges(n, avg_deg, rng, shuffle=True):
    """Locality-ordered duplex surrogate: circular power-law offsets per
    layer.  shuffle=True permutes the ids so the pipeline's reordering does
    real work; shuffle=False keeps the generator's angular order (a
    well-banded build)."""
    perm = rng.permutation(n) if shuffle else np.arange(n)
    layers = []
    for _ in range(2):
        e = n * avg_deg // 2
        src = rng.integers(0, n, e)
        off = (8.0 * (rng.pareto(2.5, e) + 1.0)).astype(np.int64)
        off = np.minimum(off, n // 2 - 1) * rng.choice(np.array([-1, 1]), e)
        dst = (src + off) % n
        keep = src != dst
        layers.append(np.stack([perm[src[keep]], perm[dst[keep]]], 1))
    return layers


def write_edges(path: str, e0: np.ndarray, e1: np.ndarray) -> None:
    """Both layers as a 1-based `.edges` file (layer ids 1 and 2)."""
    with open(path, "w") as f:
        for lid, edges in ((1, e0), (2, e1)):
            rows = np.column_stack([np.full(len(edges), lid), edges + 1])
            np.savetxt(f, rows, fmt="%d")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="models_tpu/unit_cost_full_r1/best_model.ckpt")
    ap.add_argument("--sizes", type=int, nargs="*", default=[4092, 18222])
    ap.add_argument("--avg-deg", type=int, default=6)
    ap.add_argument("-o", "--output", default="runs/large_demo")
    ap.add_argument("--packed", action="store_true",
                    help="fused SAGE steps (kernel K2) when the build has no "
                         "spill; without it every round runs kernel K1")
    ap.add_argument("--variant", default="unit_cost", choices=["unit_cost"])
    ap.add_argument("--step-ratio", type=float, default=0.0,
                    help="testReal stepRatio batching (0 = one node per call)")
    ap.add_argument("--batch-env", action="store_true",
                    help="ONE host cascade per StepRatio batch "
                         "(env.step_many; AUDC bias <= step/n)")
    ap.add_argument("--fast", action="store_true",
                    help="bf16 eval forward (precise=False): K1/K2 bf16 modes, "
                         "TF32 dense layers")
    ap.add_argument("--no-shuffle", action="store_true",
                    help="keep the generator's angular order")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    import torch

    from mdcommunity_tpu_torch.eval.real import evaluate_real
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    net = load_model(args.model, device=device)
    os.makedirs(args.output, exist_ok=True)
    # reference solve times for the same N (different graphs; scale context
    # only): results/final_comparison_report.csv rows 9 & 11
    ref_times = {4092: 107.14, 18222: 1582.64}
    rng = np.random.default_rng(0)
    for n in args.sizes:
        e0, e1 = synth_duplex_edges(n, args.avg_deg, rng, shuffle=not args.no_shuffle)
        name = f"synthetic_{n}_multiplex.edges"
        write_edges(os.path.join(args.output, name), e0, e1)
        stats = {}
        t0 = time.time()
        sol, solve_time, score = evaluate_real(
            net, args.output, name, os.path.join(args.output, "results"),
            n_nodes=n, layers=(1, 2), step_ratio=args.step_ratio,
            batch_env=args.batch_env, fuse_sage=None if args.packed else False,
            device=device, stats=stats, precise=not args.fast,
        )
        print(json.dumps(dict(
            n=n, edges=int(len(e0) + len(e1)), solve_s=round(solve_time, 2),
            total_s=round(time.time() - t0, 2), audc=round(float(score), 6),
            removed=len(sol), ref_same_scale_s=ref_times.get(n),
            device=(torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
            fuse_sage=stats["fuse_sage"], precise=stats["precise"],
            host_env=stats["host_env"],
            model_calls=stats["model_calls"],
            model_call_ms=1e3 * stats["model_call_s"] / max(stats["model_calls"], 1),
        )), flush=True)


if __name__ == "__main__":
    main()
