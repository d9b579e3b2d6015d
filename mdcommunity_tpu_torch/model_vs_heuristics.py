"""Model against the adaptive heuristics on the same seeded GMM duplex graphs,
scored alike: the head-to-head table of RESULTS.md (the port's counterpart of
scripts/model_vs_heuristics.py).

For each size the graphs come from np.random.default_rng(seed), skipping
those whose intact LMCC is at most max(1, sqrt(N)); on each, the model's
greedy rollout (eval/metrics.dismantle_greedy) and hda_2max, hda_add and
ci_2max (eval/baselines.heuristic_dismantle) run on the card (--cpu: on the
CPU).  --syn-stop applies the baseline `_syn` scripts' early stop (once the
LMCC rank is <= sqrt(N), hda_2max_syn.py:78-81) to the model and every
heuristic alike; by default they dismantle to rank 1 (the real-data
convention).  Prints one JSON line a size (mean AUDC per method, rounded to
4 places as the JAX script rounds it), then one with the device and, on the
card, its name and power limit.

Usage:
  python -m mdcommunity_tpu_torch.model_vs_heuristics [--model CKPT] \\
      [--sizes 64 128 256] [--n-graphs 15] [--syn-stop] [--seed 0] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(HERE, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
METHODS = (
    ("model", None, None),
    ("hda_2max", "degree", "max2"),
    ("hda_add", "degree", "add"),
    ("ci_2max", "ci", "max2"),
)


def run(net, sizes, n_graphs, syn_stop=False, seed=0, device=None):
    """One row a size: {n, convention, model, hda_2max, hda_add, ci_2max}."""
    from mdcommunity_tpu_torch.eval.baselines import heuristic_dismantle
    from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy
    from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges
    from mdcommunity_tpu_torch.graphs.io import duplex_from_layers

    rows = []
    for n in sizes:
        rng = np.random.default_rng(seed)
        scores = {name: [] for name, _, _ in METHODS}
        made = 0
        while made < n_graphs:
            e0, e1 = gmm_duplex_edges(n, rng)
            g = duplex_from_layers(n, e0, e1, device=device)
            if int(g.max_rank) <= max(1, int(np.sqrt(n))):
                continue
            made += 1
            for name, method, combine in METHODS:
                if name == "model":
                    _, s, _ = dismantle_greedy(net, g, syn_stop=syn_stop)
                else:
                    _, s, _ = heuristic_dismantle(g, method, combine, syn_stop=syn_stop)
                scores[name].append(s)
        row = dict(n=n, convention="syn" if syn_stop else "rank1")
        for name in scores:
            row[name] = round(float(np.mean(scores[name])), 4)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--sizes", type=int, nargs="*", default=[64, 128, 256])
    ap.add_argument("--n-graphs", type=int, default=15)
    ap.add_argument("--syn-stop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from mdcommunity_tpu_torch.models.torch_convert import load_any_model
    from mdcommunity_tpu_torch.utils.device import resolve_device
    from mdcommunity_tpu_torch.utils.timing import gpu_line

    device = resolve_device("cpu" if args.cpu else None)
    net = load_any_model(args.model, device=device)
    rows = []
    for n in args.sizes:
        (row,) = run(net, [n], args.n_graphs, args.syn_stop, args.seed, device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps(dict(device=str(device),
                          gpu=gpu_line() if device.type == "cuda" else None)), flush=True)
    return rows


if __name__ == "__main__":
    main()
