"""host env: the mean of the history rows' t_env_s (one native cascade
an iteration and the rewards)."""

import numpy as np


def read(layer):
    r = layer.get("rows") or []
    return 1e3 * float(np.mean([x["t_env_s"] for x in r])) if r else None
