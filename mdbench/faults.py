"""Faults planted in the program underneath a run.  Each is a context
manager that patches the program's module attributes the timed path calls
and restores them.  A run with any of them on must come out not correct
(mdbench/tests on the CPU; calibrate.py on the card).

  state    the step returns its state unchanged: the host env's step_many
           removes nothing (dismantling), Adam's step leaves the weights
           as they are (training)
  half     half of the batch left out: the rollout's top-k keeps half of
           the picks; the fit's loss is the mean over half of the actions
  token    an answer altered where it is produced: the forward's Q at one
           node moved by a hundredth of the largest |Q|

The control is no patch: it is the program's own lower precision, the
traffic's precise=False (K1's and K2's bf16 modes, TF32 dense layers, the
bf16 fit), which calibrate.py switches on.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch

NAMES = ("state", "half", "token")


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _token(fwd):
    def forward(*args, **kwargs):
        q = fwd(*args, **kwargs)
        fin = torch.isfinite(q)
        i = int(torch.argmax(torch.where(fin, q, torch.full_like(q, -float("inf")))))
        q = q.clone()
        q[i] += 0.01 * float(q[fin].abs().max())
        return q
    return forward


@contextlib.contextmanager
def planted(name: str, kind: str) -> Iterator[None]:
    """Plant fault `name` for a run of `kind` ("dismantle" or "train")."""
    from mdcommunity_tpu_torch import native
    from mdcommunity_tpu_torch.eval import metrics
    from mdcommunity_tpu_torch.rl import big_trainer

    with contextlib.ExitStack() as stack:
        if name == "state" and kind == "dismantle":
            def step_many(self, actions, degree_cost=False):
                empty = np.zeros((0, 2), np.int64)
                return self.rank, [empty, empty], len(actions)
            stack.enter_context(_patched(native.NativeDuplexEnv, "step_many", step_many))
        elif name == "state":
            def step(self, closure=None):
                return None
            stack.enter_context(_patched(torch.optim.Adam, "step", step))
        elif name == "half" and kind == "dismantle":
            top = metrics.top_k_stable
            stack.enter_context(_patched(metrics, "top_k_stable",
                                         lambda q, k: top(q, max(k // 2, 1))))
        elif name == "half":
            loss = big_trainer.banded_train_loss

            def half_loss(net, bdx, covered, actions, targets, **kw):
                h = max(len(actions) // 2, 1)
                return loss(net, bdx, covered, actions[:h], targets[:h], **kw)
            stack.enter_context(_patched(big_trainer, "banded_train_loss", half_loss))
        elif name == "token":
            mod = metrics if kind == "dismantle" else big_trainer
            stack.enter_context(_patched(mod, "banded_test_forward",
                                         _token(mod.banded_test_forward)))
        else:
            raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
        yield

