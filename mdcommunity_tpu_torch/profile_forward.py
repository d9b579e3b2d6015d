"""Where the time of one model call goes, on the card.

Builds the `large_graph_demo` graph of each size (same generator and seed),
runs a few warm-up model calls of the greedy loop (forward + stable top-k +
fetch), then profiles a steady window of them with torch.profiler and prints
the device time by kernel, the host-clock time per call and the device's busy
share of the window.

    python -m mdcommunity_tpu_torch.profile_forward --sizes 18222 1048576
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
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.utils.device import resolve_device, set_precise_matmul

    device = resolve_device(None)
    set_precise_matmul()
    net = load_model(args.model, device=device)
    for n in args.sizes:
        e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
        banded, _, _ = build_banded_duplex(n, e0, e1, max_rank=0, device=device)
        covered = ~banded.node_mask
        fuse = banded.spill_free
        k = max(int(0.001 * n), 1)

        def call():
            return top_k_stable(banded_test_forward(net, banded, covered, fuse), k)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.calls):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        print(json.dumps(dict(
            n=n, pad_n=banded.pad_n, fuse_sage=fuse, calls=args.calls,
            call_ms=1e3 * wall / args.calls,
            device_busy_ms_per_call=busy_us / 1e3 / args.calls,
            busy_share=busy_us / 1e6 / wall,
            kernel_launches_per_call=sum(e.count for e in events) / args.calls,
            device=torch.cuda.get_device_name(device),
        )), flush=True)
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=args.top), flush=True)
        del banded


if __name__ == "__main__":
    main()
