"""calibrate.py for an HCA dismantling cell: the same seeds-by-modes loop,
with the faults planted by faults_hca.py, and a near-tie reading a run:

    python3 -m mdbench.calibrate_hca --workload hca.dismantle_banded_1m \\
        --seeds 11 12 13 [--modes program control state half token] [--n N] [--rehearse N]

Before calibrate.py's line of a run, a line `scores`: over the checked
calls, the largest |Δscore| / max |score| between the program's community
scores (read where models/hca.top_communities receives them) and the
reference's; sel_tie must lie above the program runs' readings.
"""

from __future__ import annotations

import json
import sys

from mdbench import calibrate, faults_hca


class _Faults:
    NAMES = faults_hca.NAMES
    planted = staticmethod(faults_hca.planted)


def main(argv=None) -> int:
    from mdbench import reference_hca
    from mdbench.kinds import dismantle_hca
    from mdcommunity_tpu_torch.models import hca

    calls, refs = [], []
    top, gaps, run = hca.top_communities, reference_hca.gaps, dismantle_hca.run

    def top_communities(scores, real, n_real, top_frac):
        calls.append(scores[real].detach().double().cpu())
        return top(scores, real, n_real, top_frac)

    def reading(out, *args):
        refs.append([s.cpu() for s in out.scores])
        return gaps(out, *args)

    def timed_run(ctx):
        calls.clear()
        refs.clear()
        try:
            run(ctx)
        finally:
            worst = 0.0
            # call 0 is the warm-up; window batch j is call j + 1, two layers a call
            for j, rs in zip(ctx.layer.get("checked_batches") or [], refs):
                for layer, r in enumerate(rs):
                    i = 2 * (j + 1) + layer
                    if i < len(calls) and calls[i].shape == r.shape:
                        worst = max(worst, float((calls[i] - r).abs().max() / r.abs().max()))
            print(json.dumps({"scores": {"seed": ctx.seed, "precise": ctx.traffic["precise"],
                                         "max_rel_gap": worst, "checked": len(refs)}}),
                  flush=True)

    faults = calibrate.faults
    calibrate.faults = _Faults
    hca.top_communities, reference_hca.gaps, dismantle_hca.run = top_communities, reading, timed_run
    try:
        return calibrate.main(argv)
    finally:
        calibrate.faults = faults
        hca.top_communities, reference_hca.gaps, dismantle_hca.run = top, gaps, run


if __name__ == "__main__":
    sys.exit(main())
