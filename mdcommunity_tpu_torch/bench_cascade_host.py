"""Host benchmark of the native cascade engine at 10^6-node scale: the
port's counterpart of scripts/bench_cascade_host.py.

The 10^6-node dismantling loop and train_1m's iterations spend much of
their time in the host cascade (env.step_many).  This isolates it, with no
kernel in the loop: it builds large_graph_demo's shuffled-id 2^20 duplex
(synth_duplex_edges, np.random.default_rng(seed)) in the port's native
engine (native.NativeDuplexEnv) and dismantles it in StepRatio-sized
batches chosen by a deterministic highest-degree-first order (a stand-in
for the model's hub-first picks), so two engine versions do bit-identical
work.  --band-order keeps the generator's angular order with the edges
sorted by their smaller end (cache-local union-find); --skip removes that
many hubs first in one untimed batch (the late phase); --max-batches stops
early (0: to terminal).  Times the host clock around each step_many.
--device cuda also runs the device engine (env/device_cascade.py, the
loops' engine on a card: NativeDuplexEnv.engage) beside it on the same
graph and batches, times its step_many the same way (each ends in a small
readback, so the card's work is in the time) and checks that both engines
give the same rank, removals and new severs every batch (`--device cpu`
runs its plain versions: a check, no timing worth keeping).

    python -m mdcommunity_tpu_torch.bench_cascade_host [--n 1048576] [--batch 1048] [--device cuda]

Prints one JSON line with the JAX script's keys (times unrounded), with
--device the device engine's under device_*, and the card's line (the
native engine runs on the host; the card is named for the record).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
from mdcommunity_tpu_torch.utils.timing import gpu_line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=1048)
    ap.add_argument("--max-batches", type=int, default=0)
    ap.add_argument("--avg-deg", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--band-order", action="store_true",
                    help="the generator's angular ids, edges sorted by their smaller end")
    ap.add_argument("--skip", type=int, default=0,
                    help="remove this many hubs first, untimed")
    ap.add_argument("--device", default=None,
                    help="also time the device engine on this device (cuda)")
    args = ap.parse_args(argv)

    from mdcommunity_tpu_torch import native

    rng = np.random.default_rng(args.seed)
    e0, e1 = synth_duplex_edges(args.n, args.avg_deg, rng, shuffle=not args.band_order)
    if args.band_order:
        e0, e1 = (e[np.argsort(e[:, 0], kind="stable")]
                  for e in (np.sort(e0, axis=1), np.sort(e1, axis=1)))
    t0 = time.perf_counter()
    env = native.NativeDuplexEnv(args.n, e0, e1)
    t_build = time.perf_counter() - t0
    dev = None
    if args.device:
        t0 = time.perf_counter()
        dev = native.NativeDuplexEnv(args.n, e0, e1).engage(args.device)
        t_dev_build = time.perf_counter() - t0

    deg = np.zeros(args.n, np.int64)
    for e in (e0, e1):
        np.add.at(deg, e[:, 0], 1)
        np.add.at(deg, e[:, 1], 1)
    order = np.argsort(-deg, kind="stable")  # hub-first, deterministic

    times, dev_times, removed_total, pos, same = [], [], 0, 0, True
    if args.skip:
        env.step_many(order[:args.skip])
        if dev is not None:
            dev.step_many(order[:args.skip])
        pos = args.skip
    while not env.terminal and pos < args.n:
        batch = order[pos:pos + args.batch]
        pos += args.batch
        t1 = time.perf_counter()
        rank, sev, removed = env.step_many(batch)
        times.append(time.perf_counter() - t1)
        removed_total += removed
        if dev is not None:
            t1 = time.perf_counter()
            d_rank, d_sev, d_removed = dev.step_many(batch)
            dev_times.append(time.perf_counter() - t1)
            same = same and (d_rank, d_removed) == (rank, removed) and all(
                np.array_equal(np.unique(a, axis=0), np.unique(b, axis=0))
                for a, b in zip(sev, d_sev))
        if args.max_batches and len(times) >= args.max_batches:
            break

    ms = 1e3 * np.asarray(times)
    out = {
        "n": args.n,
        "edges_directed": 2 * (len(e0) + len(e1)),
        "batch": args.batch,
        "batches": len(times),
        "removed": removed_total,
        "build_s": t_build,
        "cascade_total_s": float(ms.sum() / 1e3),
        "ms_per_batch_mean": float(ms.mean()),
        "ms_per_batch_p50": float(np.median(ms)),
        "ms_per_batch_max": float(ms.max()),
        "score": round(env.score, 6),
        "rank_final": env.rank,
        "terminal": env.terminal,
        "card": gpu_line(),
    }
    if dev is not None:
        dms = 1e3 * np.asarray(dev_times)
        out.update({
            "device": args.device,
            "device_build_s": t_dev_build,
            "device_cascade_total_s": float(dms.sum() / 1e3),
            "device_ms_per_batch_mean": float(dms.mean()),
            "device_ms_per_batch_p50": float(np.median(dms)),
            "device_ms_per_batch_max": float(dms.max()),
            "device_same": bool(same and dev.terminal == env.terminal
                                and abs(dev.score - env.score) <= 1e-12 * abs(env.score)),
            "device_last_stats": dev.cascade_stats,
        })
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
