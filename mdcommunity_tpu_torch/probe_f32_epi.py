"""What K2's bf16 epilogue (f32_epi=False) does to Q, and what the f32 one
costs.

The port's counterpart of the JAX package's scripts/probe_f32_epi.py, on the
same demo graph (large_graph_demo's generator, 18,222 nodes, seed 0) and the
committed unit-cost checkpoint.  Configurations, each at precise=False (the
JAX script's packed engine) and at precise=True: the unfused forward (K1
and torch.matmul dense layers), the fused forward with the f32 epilogue
(K2, f32_epi=True) and with the bf16 one (f32_epi=False); at precise=False
the fused ones also with h stored in bf16 (act_dtype=bfloat16).  The dense
layers run at each mode's matmul precision (utils/device.matmul_precision).
A --n whose build spills raises ValueError (the fused step needs a
spill-free build): no configuration is dropped.

For each it reports Q's error against the precise unfused forward on four
states (random covers of 0, 10, 25 and 45% of the nodes): the JAX script's
max relative error (|Δ| / (|ref| + 1e-6)), the max absolute error over
max|Q|, top-1 agreement and top-32 overlap; the same on the 10% state after
four rounds of 300 random severs a layer (a copy of the build, severed as
the demo loop severs); and, on the card, the forward's ms (CUDA events,
median of --reps after warm-ups).  Prints one JSON line, with the card's
name and power limit.  On the CPU (--device cpu, a small --n) it runs the
same comparisons and times nothing.

    python -m mdcommunity_tpu_torch.probe_f32_epi
    python -m mdcommunity_tpu_torch.probe_f32_epi --device cpu --n 2048
"""

from __future__ import annotations

import argparse
import json

import numpy as np

FRACS = (0.0, 0.1, 0.25, 0.45)


def q_stats(qa, qb):
    """(max relative error, max abs error / max|qb|, top-1 agreement, top-32
    overlap) of Q qa against qb over the nodes finite in both."""
    qa, qb = qa.double().cpu().numpy(), qb.double().cpu().numpy()
    fa = np.isfinite(qa) & np.isfinite(qb)
    d = np.abs(qa[fa] - qb[fa])
    rel = float(np.max(d / (np.abs(qb[fa]) + 1e-6)))
    absr = float(np.max(d) / max(np.max(np.abs(qb[fa])), 1e-30))
    ma, mb = np.where(fa, qa, -np.inf), np.where(fa, qb, -np.inf)
    top1 = bool(np.argmax(ma) == np.argmax(mb))
    k = min(32, int(fa.sum()))
    ta, tb = set(np.argsort(-ma, kind="stable")[:k]), set(np.argsort(-mb, kind="stable")[:k])
    return rel, absr, top1, len(ta & tb) / max(k, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="models_tpu/unit_cost_full_r1/best_model.ckpt")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=18222)
    ap.add_argument("--severs", type=int, default=300, help="random severs a layer and round")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from mdcommunity_tpu_torch.graphs.banded import (
        apply_severs, build_banded_duplex, fork_banded)
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.utils.device import matmul_precision, resolve_device
    from mdcommunity_tpu_torch.utils.timing import cuda_ms, gpu_line

    device = resolve_device(args.device)
    n = args.n
    rng = np.random.default_rng(0)
    e0, e1 = synth_duplex_edges(n, 6, rng)
    banded, _, ordered = build_banded_duplex(n, e0, e1, max_rank=n, device=device)
    net = load_model(args.model, device=device)
    pad_n = banded.pad_n
    if not banded.spill_free:
        raise ValueError(f"--n {n}: the build spills, and the fused configurations need a "
                         "spill-free one")
    states = []
    for frac in FRACS:
        cov = rng.random(pad_n) < frac
        cov[n:] = True
        states.append(torch.from_numpy(cov).to(device))

    # (name, precise, fuse_sage, f32_epi, act_dtype)
    configs = [(f"{'precise' if p else 'fast'}_{name}", p, fuse, epi, torch.float32)
               for p in (False, True)
               for name, fuse, epi in (("unfused", False, True), ("fused_f32epi", True, True),
                                       ("fused_bf16epi", True, False))]
    # the fast fused steps with h stored in bf16
    configs += [(f"fast_{name}_bf16act", False, True, epi, torch.bfloat16)
                for name, epi in (("fused_f32epi", True), ("fused_bf16epi", False))]

    def forward(bdx, cov, precise, fuse, f32_epi, act=torch.float32):
        with matmul_precision(precise):
            return banded_test_forward(net, bdx, cov, fuse, precise=precise, f32_epi=f32_epi,
                                       act_dtype=act)

    def evaluate(bdx, covs):
        refs = [forward(bdx, c, True, False, True) for c in covs]
        res = {}
        for name, *config in configs:
            stats = [q_stats(forward(bdx, c, *config), r) for c, r in zip(covs, refs)]
            res[name] = dict(
                q_max_rel_err=max(s[0] for s in stats),
                q_max_abs_err_of_max=max(s[1] for s in stats),
                top1_agree=f"{sum(s[2] for s in stats)}/{len(stats)}",
                top32_overlap=float(np.mean([s[3] for s in stats])))
        return res

    out = dict(probe="f32_epi", n=n, pad_n=pad_n, device=str(device), gpu=gpu_line(),
               configs=evaluate(banded, states))
    if device.type == "cuda":
        for name, *config in configs:
            out["configs"][name]["fwd_ms"] = cuda_ms(
                lambda: forward(banded, states[1], *config), args.reps, args.warm)

    # rounds of random severs a layer, on a copy, then the 10% state again
    severed = fork_banded(banded)
    for _ in range(args.rounds):
        for layer in range(2):
            e = ordered[layer]
            pick = rng.choice(len(e), min(args.severs, len(e)), replace=False)
            k = max(512, len(pick))   # padded, as the demo loop pads its batches
            src, dst = np.zeros(k, np.int64), np.zeros(k, np.int64)
            valid = np.zeros(k, bool)
            m = len(pick)
            src[:m], dst[:m], valid[:m] = e[pick, 0], e[pick, 1], True
            apply_severs(severed, layer, *(torch.from_numpy(a).to(device)
                                           for a in (src, dst, valid)))
    out["after_severs"] = evaluate(severed, states[1:2])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
