"""forward: the mean of one HCA model call (forward, top-k and the fetch
that ends them), from the rollout's banded_hca_forward to the shadow hook,
over the window's calls outside the profiled stretch."""

import numpy as np


def read(layer):
    c = layer.get("call_s") or []
    return 1e3 * float(np.mean(c)) if c and layer.get("kind") == "dismantle_hca" else None
