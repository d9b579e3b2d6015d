"""loop: the mean of the history rows' t_mix_s (the host's eps mixing
inside selection: the draw, the valid pool, the replacements and the
de-duplication)."""

import numpy as np


def read(layer):
    r = [x["t_mix_s"] for x in layer.get("rows") or [] if "t_mix_s" in x]
    return 1e3 * float(np.mean(r)) if r else None
