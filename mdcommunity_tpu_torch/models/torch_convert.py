"""The reference's PyTorch checkpoints (bare state_dicts) to and from the
port's DuplexQNet.

The reference saves `state_dict()`s (MultiDismantler_torch.SaveModel
:787-789) with keys
  w_n2l, p_node_conv, p_node_conv2, p_node_conv3, h1_weight, h2_weight, last_w,
  cross_product, w_layer1, w_layer2,
  layerNodeAttention_weight.{trans, bias, logis.parameter.weight, logis.parameter.bias}.
`last_w` aliases `h2_weight` when reg_hidden > 0 (net :69) and is dropped.
An HCA net's state_dict adds w_macro, w_comm_score and w_micro_score,
carried both ways (the JAX package's converter reads them and writes none).
The logistic head is a torch Linear ([out, in] weight), transposed to the
matmul convention of the JAX package's parameter tree, which the port's
models/net.from_jax_params takes.  The mapping is the JAX package's
models/torch_convert.py, as the port's own copy.
"""

from __future__ import annotations

import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

_PREFIX = "layerNodeAttention_weight"
_PLAIN = (
    "w_n2l", "p_node_conv", "p_node_conv2", "p_node_conv3", "h1_weight",
    "h2_weight", "cross_product", "w_layer1", "w_layer2",
)
_HCA = ("w_macro", "w_comm_score", "w_micro_score")


def state_dict_to_params(sd: Mapping) -> Dict:
    """A reference state_dict -> the JAX package's parameter tree, as f32
    numpy arrays (fusion leaves under "fusion")."""
    def arr(k):
        v = sd[k]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return np.ascontiguousarray(v, np.float32)

    params: Dict = {k: arr(k) for k in _PLAIN}
    params["fusion"] = {
        "trans": arr(f"{_PREFIX}.trans"),
        "bias": arr(f"{_PREFIX}.bias"),
        "logis_w": np.ascontiguousarray(arr(f"{_PREFIX}.logis.parameter.weight").T),
        "logis_b": arr(f"{_PREFIX}.logis.parameter.bias"),
    }
    # an HCA net's heads (HCA net __init__: w_n2l [3, 64] and the macro and
    # decoder weights)
    params.update({k: arr(k) for k in _HCA if k in sd})
    return params


def params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse: the reference's state_dict (with `last_w`), CPU tensors."""

    def t(x):
        return torch.tensor(np.asarray(x, np.float32))

    fusion = params["fusion"]
    out = {k: t(params[k]) for k in _PLAIN}
    out["last_w"] = t(params["h2_weight"])
    out[f"{_PREFIX}.trans"] = t(fusion["trans"])
    out[f"{_PREFIX}.bias"] = t(fusion["bias"])
    out[f"{_PREFIX}.logis.parameter.weight"] = t(np.asarray(fusion["logis_w"]).T)
    out[f"{_PREFIX}.logis.parameter.bias"] = t(fusion["logis_b"])
    out.update({k: t(params[k]) for k in _HCA if k in params})
    return out


def state_dict_to_net(sd: Mapping, device=None):
    """A reference state_dict -> DuplexQNet (HcaQNet for an HCA net's) on
    `device` (CUDA unless named)."""
    from mdcommunity_tpu_torch.models.net import from_jax_params

    return from_jax_params(state_dict_to_params(sd), device=device)


def net_to_state_dict(net) -> Dict[str, torch.Tensor]:
    """DuplexQNet -> the reference's state_dict."""
    from mdcommunity_tpu_torch.models.net import to_jax_params

    return params_to_state_dict(to_jax_params(net))


def load_torch_checkpoint(path: str, device=None):
    """A reference checkpoint file (torch.save of a state_dict) as a
    DuplexQNet on `device`."""
    return state_dict_to_net(torch.load(path, map_location="cpu", weights_only=True),
                             device=device)


def load_any_model(path: str, device=None):
    """The CLI's model loader: a reference torch checkpoint (a torch.save
    zip archive) or a JAX-package checkpoint (a pickle of the agent's state,
    read by models/checkpoint.load_model without importing jax)."""
    if zipfile.is_zipfile(path):
        return load_torch_checkpoint(path, device=device)
    from mdcommunity_tpu_torch.models.checkpoint import load_model

    return load_model(path, device=device)
