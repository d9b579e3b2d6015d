"""forward: the mean of the history rows' t_target_s (the target
network's forward and its max), over the rows that ran it."""

import numpy as np


def read(layer):
    r = [x for x in layer.get("rows") or [] if x["maxq"] != 0.0]
    return 1e3 * float(np.mean([x["t_target_s"] for x in r])) if r else None
