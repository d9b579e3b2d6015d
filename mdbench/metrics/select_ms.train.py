"""loop: the mean of the history rows' t_select_s (forward, top-k and
the host's eps mixing), outside the profiled stretch."""

import numpy as np


def read(layer):
    r = layer.get("rows") or []
    return 1e3 * float(np.mean([x["t_select_s"] for x in r])) if r else None
