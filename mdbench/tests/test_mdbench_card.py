"""On the card, at 2^16 nodes (a size a test run holds): each cell's
program run comes out correct, and its control (the program's own
precise=False) and each planted fault come out not correct.  Skips
without a card."""

import gc

import pytest
import torch

from mdbench import faults
from mdbench.common import Ctx
from mdbench.manifest import Manifest

CELLS = ["degree_cost.dismantle_banded_1m", "unit_cost.train_1m",
         "degree_cost.train_banded_1m"]
N = 1 << 16


def _run(root, device, cell, mode, seed):
    man = Manifest.load(root)
    w = man.cell(cell)
    traffic = man.traffic(w["traffic"])
    if mode == "control":
        traffic = dict(traffic, precise=False)
    ctx = Ctx(root=root, cell=w, config=man.config(w["config"]), traffic=traffic, seed=seed,
              seconds=10.0, trace=False, device=device, n=N, t_process=0.0,
              limits=man.limits(cell))
    try:
        if mode in faults.NAMES:
            with faults.planted(mode, traffic["kind"]):
                man.kind(traffic).run(ctx)
        else:
            man.kind(traffic).run(ctx)
    except Exception:
        if mode == "program":
            raise
        return False
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    return ctx.correct


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_control_and_faults_not(root, card, cell):
    for seed in (2200000101, 2200000102, 2200000103):
        assert _run(root, card, cell, "program", seed)
        assert not _run(root, card, cell, "control", seed)
    for mode in faults.NAMES:
        assert not _run(root, card, cell, mode, 2200000104)
