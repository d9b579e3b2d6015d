"""The faults of faults.py planted underneath an HCA dismantling run
(kinds/dismantle_hca.py), which they must bring to not correct:

  state    the host env's step_many removes nothing (faults.py's)
  half     the rollout's top-k keeps half of the picks (faults.py's)
  token    the answer altered where it is produced: banded_hca_forward's Q
           at its best node moved by a hundredth of the largest |Q| over
           the nodes both layers select (Q above the −1e9 sentinel's reach)

`planted(name, kind)` has faults.planted's form, so that calibrate.py's
loop runs with it (calibrate_hca.py).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from mdbench import faults

NAMES = faults.NAMES


def _token(fwd):
    def forward(*args, **kwargs):
        q = fwd(*args, **kwargs)
        sel = q > -1e8
        i = int(torch.argmax(torch.where(sel, q, torch.full_like(q, -float("inf")))))
        q = q.clone()
        q[i] += 0.01 * float(q[sel].abs().max())
        return q
    return forward


@contextlib.contextmanager
def planted(name: str, kind: str = "dismantle_hca") -> Iterator[None]:
    """Plant fault `name` for an HCA dismantling run."""
    from mdcommunity_tpu_torch.eval import metrics

    if name == "token":
        with faults._patched(metrics, "banded_hca_forward", _token(metrics.banded_hca_forward)):
            yield
    elif name in NAMES:
        with faults.planted(name, "dismantle"):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
