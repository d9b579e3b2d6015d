"""The readings that `correct`'s limits are set from, many seeds in one
process on the card (the build and the libraries are made once):

    python3 -m mdbench.calibrate --workload <cell> --seeds 11 12 13 \\
        [--modes program control state half token] [--seconds 30] [--n N] [--rehearse N]

Each seed runs in each mode given.  Mode program runs the cell as a run does; control switches on the
program's own lower precision (the traffic's precise=False: K1's and K2's
bf16 modes, TF32 dense layers, the bf16 fit); state, half and token plant
the faults of faults.py.  --n runs the cell's traffic at N nodes on the
card (a test's size), --rehearse N on the CPU.  One JSON line a seed: the
numbers compared and whether the run came out correct.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

from mdbench import faults
from mdbench.common import Ctx
from mdbench.manifest import Manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["program"],
                    choices=("program", "control") + faults.NAMES)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--rehearse", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    man = Manifest.load(root)
    cell = man.cell(args.workload)
    config, plain = man.config(cell["config"]), man.traffic(cell["traffic"])
    if args.rehearse:
        device, n = torch.device("cpu"), args.rehearse
    else:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA card", file=sys.stderr)
            return 3
        device, n = torch.device("cuda", 0), int(args.n or plain["n"])
    kind = man.kind(plain)
    for seed, mode in [(s, m) for s in args.seeds for m in args.modes]:
        traffic = dict(plain, precise=False) if mode == "control" else plain
        t0 = time.perf_counter()
        ctx = Ctx(root=root, cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=args.seconds, trace=False, device=device, n=n, t_process=t0,
                  limits=man.limits(cell["name"]))
        err = None
        try:
            if mode in faults.NAMES:
                with faults.planted(mode, traffic["kind"]):
                    kind.run(ctx)
            else:
                kind.run(ctx)
        except Exception as e:  # a fault may crash the run: that is not correct
            err = f"{type(e).__name__}: {e}"
        print(json.dumps({
            "workload": cell["name"], "mode": mode, "seed": seed,
            "correct": ctx.correct if err is None else False, "error": err,
            "checks": {c["name"]: c["value"] for c in ctx.checks},
            "e2e": ctx.e2e, "attempted": ctx.attempted,
            "checked": ctx.layer.get("checked_batches"), "leaves": ctx.layer.get("leaves"),
            "s": round(time.perf_counter() - t0, 1),
        }), flush=True)
        del ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
