"""Loading the JAX package's committed checkpoints (weights only).

A `models_tpu/*/best_model.ckpt` is a pickle of the JAX agent's full state:
params, target params, the optax optimizer state, the RNG state and the
config.  Its optimizer state references optax's NamedTuple classes, and
importing optax would import jax.  The unpickler below lets numpy, builtins
and collections through and turns every other class into a stub tuple, so
the params (plain dicts of f32 numpy arrays) load with neither jax nor optax
imported.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

_PASS = ("numpy", "builtins", "collections", "copyreg", "_codecs")


class _Stub(tuple):
    """Stands in for a class the port does not import (optax states)."""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


class _WeightsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in _PASS:
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": module})


def load_params(path: str) -> Dict[str, Any]:
    """The `params` tree of a JAX-package checkpoint, as numpy arrays."""
    with open(path, "rb") as f:
        state = _WeightsUnpickler(f).load()
    return state["params"]


def load_model(path: str, device="cpu"):
    """load_params composed with models.net.from_jax_params."""
    from mdcommunity_tpu_torch.models.net import from_jax_params

    return from_jax_params(load_params(path), device=device)
