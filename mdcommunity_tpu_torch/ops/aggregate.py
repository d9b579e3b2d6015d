"""Row-wise helpers shared by the model forward."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization over the last axis, x * rsqrt(max(Σx², eps²)):
    torch.nn.functional.normalize's value, with zero rows staying zero (the
    JAX package's form, kept for parity)."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))
