"""loop: the mean of the history rows' t_sever_s (the next state's
covered mask and the severs applied to both operand sets, each followed by
a wait for the card)."""

import numpy as np


def read(layer):
    r = layer.get("rows") or []
    return 1e3 * float(np.mean([x["t_sever_s"] for x in r])) if r else None
