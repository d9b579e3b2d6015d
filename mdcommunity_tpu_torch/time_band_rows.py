"""Times the band kernels' rows of PERF.md §6 on the card, as chip_smoke.py
times them, and writes them as one JSON file.

It runs chip_smoke.py's timing phases (time_kernels, time_bf16_kernels,
time_halo_kernels, time_slice6) at the main path's shapes, 18,432 and 2^20
rows with D = 64, and tune_band --diag --proto (K1's attribution and the
prototypes), from the checkout it is run in.
The same file, copied into another checkout of the repository, times that
checkout's kernels with the same phases, so two commits compare on one card
in one call:

    python -m mdcommunity_tpu_torch.time_band_rows -o runs/band_rows.json

Each row is {ms, plain_ms, bound_ms, bound_by, library_ms, max_abs_err} by
counter and shape, ms the median of REPS calls with a CUDA-event pair
around each (utils/timing.cuda_ms: the window holds the wrapper's host work
too).  Beside each such time stands its device time, `device_ms` beside
`ms`, `plain_device_ms` beside `plain_ms`, `library_device_ms` beside
`library_ms` (any other `<x>_ms` gains `<x>_device_ms`, any other key `<k>`
`<k>_device_ms`): the kernels' own time, summed over the call's launches
(utils/timing.device_ms, torch.profiler over REPS calls).  tune_band's rows
gain theirs alike.  The file also holds the card's name and power limit.
Needs the card; it checks each kernel against its plain version first, as
chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPS, WARM = 100, 10   # CUDA-event launches a row (median), after warm-ups


class Timed(float):
    """A CUDA-event time in ms that also carries the same call's device time
    (`device_ms`), so that the phases that build the rows need not know."""

    device_ms: float


def with_device_times(node):
    """A copy of node (nested dicts and lists) in which each Timed value at
    key k gains a sibling holding its device time: k without its trailing
    `ms`, then `device_ms` (`ms` -> `device_ms`, `plain_ms` ->
    `plain_device_ms`), or `<k>_device_ms` for a key that does not end in
    `ms`."""
    if isinstance(node, list):
        return [with_device_times(x) for x in node]
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        out[k] = with_device_times(v)
        if isinstance(v, Timed):
            out[k[:-2] + "device_ms" if k.endswith("ms") else f"{k}_device_ms"] = v.device_ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--out", required=True, help="the JSON file to write")
    ap.add_argument("--no-tune", action="store_true", help="skip tune_band --diag --proto")
    args = ap.parse_args(argv)

    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "chip_smoke.py")):
        sys.exit("run from the root of a checkout (chip_smoke.py's directory)")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_band_rows needs the card")
    import chip_smoke as cs

    from mdcommunity_tpu_torch import tune_band
    from mdcommunity_tpu_torch.native import build as native_build
    from mdcommunity_tpu_torch.ops import band_kernels, probe_kernels
    from mdcommunity_tpu_torch.utils.device import set_precise_matmul
    from mdcommunity_tpu_torch.utils import timing

    event_ms = timing.cuda_ms

    def timed(fn, reps=REPS, warm=WARM):
        t = Timed(event_ms(fn, reps, warm))
        t.device_ms = timing.device_ms(fn, reps, warm)
        return t

    set_precise_matmul()
    # more launches a row than chip_smoke.py's 20: at 18,432 rows a launch
    # is mostly host time, and its spread is wide.  tune_band reads
    # timing.cuda_ms when it runs, so its rows carry device times too.
    cs.time_ms = timed
    timing.cuda_ms = timed
    t0 = time.perf_counter()
    for build in (band_kernels.build, probe_kernels.build, native_build.build):
        build()
    dev = "cuda"
    rows = {}
    main_graph = cs.synth_banded(18222, True, 0, dev)
    clean18 = cs.synth_banded(18222, False, 0, dev)
    rows["18,432"] = cs.time_kernels(dev, main_graph, "18,432 rows")
    rows["18,432"].update(cs.time_bf16_kernels(dev, main_graph, "18,432 rows"))
    rows["18,432"].update(cs.time_halo_kernels(dev, clean18, "18,432 rows"))
    rows["18,432"].update(cs.time_slice6(
        dev, main_graph, cs.synth_banded(18222, True, 0, dev, nibble=True),
        cs.synth_banded(18222, False, 0, dev, nibble=True), "18,432 rows"))
    del main_graph, clean18
    big = cs.synth_banded(1 << 20, False, 0, dev, reorder=False)
    rows["2^20"] = cs.time_kernels(dev, big, "2^20 rows")
    rows["2^20"].update(cs.time_bf16_kernels(dev, big, "2^20 rows"))
    rows["2^20"].update(cs.time_halo_kernels(dev, big, "2^20 rows"))
    big_nib = cs.synth_banded(1 << 20, False, 0, dev, reorder=False, simple=True, nibble=True)
    rows["2^20"].update(cs.time_slice6(dev, big, big_nib, big_nib, "2^20 rows"))
    del big, big_nib
    torch.cuda.empty_cache()
    out = dict(gpu=timing.gpu_line(), rows=rows)
    if not args.no_tune:
        out["tune_band"] = tune_band.main(["--diag", "--proto"])
    timing.cuda_ms = event_ms
    out = with_device_times(out)
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(gpu=out["gpu"], out=args.out, seconds=out["seconds"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
