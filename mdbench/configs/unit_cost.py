"""Plain reference of the unit_cost configuration's inputs (the reference's
MultiDismantler_unit_cost): node features [deg/maxdeg, deg/maxdeg] of the
live degree on active nodes, every removal costing 1/n."""

import numpy as np
import torch


def node_input(deg: torch.Tensor, active: torch.Tensor, weights) -> torch.Tensor:
    """deg [2, n] live degrees, active bool [n] -> features [2, n, 2]."""
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    maxdeg = torch.amax(torch.where(active[None], deg, zero), dim=1)
    nd = torch.where(active[None], deg / torch.clamp(maxdeg, min=1e-12)[:, None], zero)
    return torch.stack([nd, nd], dim=-1)


def action_cost(acts: np.ndarray, weights, n: int) -> np.ndarray:
    return np.full(len(acts), 1.0 / n)
