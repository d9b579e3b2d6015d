"""Plain reference of the degree_cost configuration's inputs (the
reference's MultiDismantler_degree_cost): node features [w_l, 1] on active
nodes, w_l = deg/maxdeg of the intact layer; a removal costs
(w_0/Σw_0 + w_1/Σw_1)/2."""

import numpy as np
import torch


def node_input(deg: torch.Tensor, active: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """weights [2, n] node costs -> features [2, n, 2]."""
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    base = torch.stack([weights, torch.ones_like(weights)], dim=-1)
    return torch.where(active[None, :, None], base, zero)


def action_cost(acts: np.ndarray, weights: np.ndarray, n: int) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    return 0.5 * (w[0, acts] / w[0].sum() + w[1, acts] / w[1].sum())
