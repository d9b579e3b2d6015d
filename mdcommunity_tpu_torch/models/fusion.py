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
because their cross-layer weights cancel at two layers: their attention
parameters (FUSION_INITS) are kept for the parameter count and get a
gradient of exactly 0, as in the reference and the JAX package.  Modes are
chosen by the parameter dict's keys, as in the JAX package; all four modes
therefore run through `fuse`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.utils.device import row_matmul

FusionParams = Dict[str, torch.Tensor]


def _uniform(generator: torch.Generator, shape, bound: float) -> np.ndarray:
    return ((torch.rand(shape, generator=generator) * 2 - 1) * bound).numpy()


def _identity(dim: int) -> Dict[str, np.ndarray]:
    return {"trans": np.eye(dim, dtype=np.float32), "bias": np.zeros(dim, np.float32)}


def init_bitwise_logis(generator: torch.Generator, dim: int) -> Dict[str, np.ndarray]:
    """BitwiseMultipyLogis' parameters (the JAX package's
    init_bitwise_logis): trans = I, bias = 0, the logistic head uniform in
    ±1/√dim.  Draws come from `generator` (the JAX package's from
    jax.random: the same distributions, other numbers)."""
    bound = 1.0 / np.sqrt(dim)
    return {**_identity(dim), "logis_w": _uniform(generator, (dim, 1), bound),
            "logis_b": _uniform(generator, (1,), bound)}


def _xavier(generator: torch.Generator, shape) -> np.ndarray:
    """torch.nn.init.xavier_uniform_ with gain 1.414 (the reference's init
    of the attention and semantic parameters, mutil_layer_weight.py:20-21,
    69-75), with the JAX package's fans: (shape[-2], shape[-1])."""
    fan_in, fan_out = (shape[-2] if len(shape) > 1 else shape[-1]), shape[-1]
    return _uniform(generator, shape, 1.414 * np.sqrt(6.0 / (fan_in + fan_out)))


def init_layer_node_attention(generator: torch.Generator, dim: int) -> Dict[str, np.ndarray]:
    """LayerNodeAttention_weight's parameters (reference :18-24)."""
    return {**_identity(dim), "attention": _xavier(generator, (1, 2 * dim))}


def init_cosine(generator: torch.Generator, dim: int) -> Dict[str, np.ndarray]:
    """Cosine_similarity's parameters (reference :88-94)."""
    return {**_identity(dim), "cos_attention": _xavier(generator, (1, 2 * dim))}


def init_semantic(generator: torch.Generator, dim: int) -> Dict[str, np.ndarray]:
    """SemanticAttention's parameters (reference :161-176)."""
    return {**_identity(dim),
            "attention": _xavier(generator, (1, 2 * dim)),
            "sem_W": _xavier(generator, (dim, dim)),
            "sem_b": _xavier(generator, (1, dim)),
            "sem_q": _xavier(generator, (dim, 1))}


FUSION_INITS = {
    "bitwise_logis": init_bitwise_logis,
    "layer_node_attention": init_layer_node_attention,
    "cosine": init_cosine,
    "semantic": init_semantic,
}


def bitwise_logis_fuse(
    p: FusionParams, e0: torch.Tensor, e1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse two layers' row embeddings [..., D] -> (out0, out1); the row
    products over utils/device.row_matmul's fixed row chunks."""
    f0 = torch.tanh(row_matmul(e0, p["trans"]) + p["bias"])
    f1 = torch.tanh(row_matmul(e1, p["trans"]) + p["bias"])

    def one(fl, fo):
        a_self = torch.sigmoid(row_matmul(fl * fl, p["logis_w"]) + p["logis_b"])
        a_other = torch.sigmoid(row_matmul(fo * fl, p["logis_w"]) + p["logis_b"])
        w = torch.softmax(torch.cat([a_self, a_other], dim=-1), dim=-1)
        return fl + w[..., 1:2] * fo

    return one(f0, f1), one(f1, f0)


def additive_fuse(
    p: FusionParams, e0: torch.Tensor, e1: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The duplex closed form of the three attention alternatives:
    out_l = f_l + f_o."""
    f0 = torch.tanh(row_matmul(e0, p["trans"]) + p["bias"])
    f1 = torch.tanh(row_matmul(e1, p["trans"]) + p["bias"])
    return f0 + f1, f1 + f0


def fuse(p: FusionParams, e0: torch.Tensor, e1: torch.Tensor):
    """Dispatch on the fusion parameters' keys."""
    if "logis_w" in p:
        return bitwise_logis_fuse(p, e0, e1)
    return additive_fuse(p, e0, e1)
