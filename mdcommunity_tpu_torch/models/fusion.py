"""Cross-layer fusion modules (the reference's MRGNN family).

The live configuration is BitwiseMultipyLogis (reference
MRGNN/mutil_layer_weight.py:252-301): each row borrows representation from
the other duplex layer, weighted by a learned logistic score of the
elementwise product of the two layers' transformed embeddings.

Per row, with layer embeddings e_0, e_1 (predicting layer l):
  f_k   = tanh(e_k @ trans + bias)
  a_k   = sigmoid((f_k * f_l) @ w + b)
  w_k   = softmax over k of a_k
  out_l = f_l + w_o * f_o

The three attention alternatives (LayerNodeAttention, Cosine_similarity,
SemanticAttention) reduce exactly to out_l = f_l + f_o for a duplex graph,
because their cross-layer weights cancel at two layers.  Modes are chosen by
the parameter dict's keys, as in the JAX package; all four modes therefore
run through `fuse`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

FusionParams = Dict[str, torch.Tensor]


def bitwise_logis_fuse(
    p: FusionParams, e0: torch.Tensor, e1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse two layers' row embeddings [..., D] -> (out0, out1)."""
    f0 = torch.tanh(e0 @ p["trans"] + p["bias"])
    f1 = torch.tanh(e1 @ p["trans"] + p["bias"])

    def one(fl, fo):
        a_self = torch.sigmoid((fl * fl) @ p["logis_w"] + p["logis_b"])
        a_other = torch.sigmoid((fo * fl) @ p["logis_w"] + p["logis_b"])
        w = torch.softmax(torch.cat([a_self, a_other], dim=-1), dim=-1)
        return fl + w[..., 1:2] * fo

    return one(f0, f1), one(f1, f0)


def additive_fuse(
    p: FusionParams, e0: torch.Tensor, e1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The duplex closed form of the three attention alternatives:
    out_l = f_l + f_o."""
    f0 = torch.tanh(e0 @ p["trans"] + p["bias"])
    f1 = torch.tanh(e1 @ p["trans"] + p["bias"])
    return f0 + f1, f1 + f0


def fuse(p: FusionParams, e0: torch.Tensor, e1: torch.Tensor):
    """Dispatch on the fusion parameters' keys."""
    if "logis_w" in p:
        return bitwise_logis_fuse(p, e0, e1)
    return additive_fuse(p, e0, e1)
