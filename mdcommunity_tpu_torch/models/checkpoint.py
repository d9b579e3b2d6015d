"""Loading the JAX package's committed checkpoints (weights only), saving
the port's weights in the same layout, and the DQN agent's full-state file.

A `models_tpu/*/best_model.ckpt` is a pickle of the JAX agent's full state:
params, target params, the optax optimizer state, the RNG state and the
config.  Its optimizer state references optax's NamedTuple classes, and
importing optax would import jax.  The unpickler below lets numpy, builtins
and collections through and turns every other class into a stub tuple, so
the params (plain dicts of f32 numpy arrays) load with neither jax nor optax
imported.

The agent's file (save_agent_state) is a pickle of numpy arrays and Python
values: params and target_params in the JAX package's layout, so both this
module's loaders and the JAX package's DQNAgent.load(path, weights_only=True)
read it, and the port's own keys for the rest of its state
(rl/dqn.DQNAgent._state_dict).  The JAX package's Orbax store
(save_orbax/load_orbax) has no counterpart: Orbax is a JAX library.
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


def load_model(path: str, device=None):
    """load_params composed with models.net.from_jax_params: the module on
    `device`, CUDA unless the caller names one; a DuplexQNet, or an HcaQNet
    for an HCA checkpoint (its params hold w_macro)."""
    from mdcommunity_tpu_torch.models.net import from_jax_params

    return from_jax_params(load_params(path), device=device)


def save_params(path: str, net) -> None:
    """Write {"params": to_jax_params(net)} with pickle, the file the JAX
    package's scripts/train_1m.py writes: load_params and the JAX package's
    loaders read it back."""
    from mdcommunity_tpu_torch.models.net import to_jax_params

    with open(path, "wb") as f:
        pickle.dump({"params": to_jax_params(net)}, f)


def save_agent_state(path: str, state: Dict[str, Any]) -> None:
    """Pickle an agent's full state (numpy arrays and Python values only)."""
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_agent_state(path: str) -> Dict[str, Any]:
    """An agent file as a dict: the port's, or the JAX package's (its optax
    state then loads as stubs; params and target_params are numpy)."""
    with open(path, "rb") as f:
        return _WeightsUnpickler(f).load()
