"""Times the blocked-pair kernels' rows of PERF.md §6 on the card (K4, K4 as
BlockSpmm's backward, K5) and writes them as one JSON file.

At the main path's shapes, the RCM-ordered blocked builds of 18,222 and
2^20 nodes (S = T = 512, D = 64; chip_smoke.blocked_graph and
blocked_operands), each kernel is checked against its plain version, then
timed beside its bound (chip_smoke.blocked_bounds), its plain version and
its library call (torch.sparse.mm on a CSR of the same weights for K4,
torch.sparse.sampled_addmm on the real slots' pattern for K5), two ways:

  ms         CUDA events around each call, median of REPS calls: the
             window holds the wrapper's host work before the launch too;
  device_ms  the device time of the kernels one call launches, summed, from
             torch.profiler over REPS calls (utils/timing.device_ms).

The same file, copied with utils/timing.py into another checkout of the
repository, times that checkout's kernels, so two commits compare on one
card in one call:

    python -m mdcommunity_tpu_torch.time_blocked_rows -o runs/blocked_rows.json

The file also holds the card's name and power limit.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPS, WARM = 100, 10   # calls a row, after warm-ups


def blocked_calls(bk, bcoo, w, h, g):
    """[(name, kernel call, plain call, library call)] for K4, K4 as the
    backward (on the gradient g) and K5 on these operands; bk is the
    checkout's ops.blocked_kernels."""
    import torch

    n_real = int(bcoo.rowptr[-1])
    src, dst = bk._rows(bcoo, n_real)
    wr = w[:n_real].reshape(-1)
    real = torch.zeros(n_real * bcoo.T, dtype=torch.bool, device=h.device)
    real[bcoo.row_slot.long()] = True
    R = bcoo.n_rows
    a_csr = torch.sparse_coo_tensor(torch.stack([dst[real], src[real]]), wr[real],
                                    (R, R), check_invariants=True).coalesce().to_sparse_csr()
    pattern = torch.sparse_coo_tensor(torch.stack([src[real], dst[real]]),
                                      torch.zeros(int(real.sum()), device=h.device),
                                      (R, R), check_invariants=True).coalesce().to_sparse_csr()
    g_t = g.t().contiguous()
    return [
        ("spmm_block", lambda: bk.spmm_block(bcoo, w, h),
         lambda: bk.spmm_block_plain(bcoo, w, h), lambda: torch.sparse.mm(a_csr, h)),
        ("spmm_block_bwd", lambda: bk.spmm_block(bcoo, w, g, "spmm_block_bwd"),
         lambda: bk.spmm_block_plain(bcoo, w, g), lambda: torch.sparse.mm(a_csr, g)),
        ("sddmm_block", lambda: bk.sddmm_block(bcoo, h, g),
         lambda: bk.sddmm_block_plain(bcoo, h, g),
         lambda: torch.sparse.sampled_addmm(pattern, h, g_t)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--out", required=True, help="the JSON file to write")
    args = ap.parse_args(argv)

    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "chip_smoke.py")):
        sys.exit("run from the root of a checkout (chip_smoke.py's directory)")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("time_blocked_rows needs the card")
    import chip_smoke as cs

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk
    from mdcommunity_tpu_torch.utils.device import set_precise_matmul
    from mdcommunity_tpu_torch.utils.timing import cuda_ms, device_ms, gpu_line

    set_precise_matmul()
    t0 = time.perf_counter()
    bk.build()
    dev = "cuda"
    rows = {}
    for label, n in (("18,432", 18222), ("2^20", 1 << 20)):
        bd = cs.blocked_graph(n, dev, max_rank=0)
        bcoo, w, h = cs.blocked_operands(bd, 14, dev)
        g = torch.nn.functional.normalize(torch.randn_like(h), dim=-1)
        rows[label] = {}
        for name, kern, plain, lib in blocked_calls(bk, bcoo, w, h, g):
            err = cs.compare(f"{label} rows {name}", kern(), plain())
            bound_ms, bound_by = cs.blocked_bounds(bcoo, w, h.shape[1], name)
            rows[label][name] = row = dict(
                ms=cuda_ms(kern, REPS, WARM), device_ms=device_ms(kern, REPS, WARM),
                plain_ms=cuda_ms(plain, REPS, WARM), bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(lib, REPS, WARM),
                library_device_ms=device_ms(lib, REPS, WARM), max_abs_err=err)
            print(f"{label} rows {name}: " + json.dumps(row), flush=True)
        del bd, bcoo, w, h, g
        torch.cuda.empty_cache()
    out = dict(gpu=gpu_line(), rows=rows, seconds=time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(dict(gpu=out["gpu"], out=args.out, seconds=out["seconds"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
