"""host env: the edges the native engine's relabels walked in an
iteration's cascade (the affected records' edge lists, both layers, every
round), edges_walked in the history rows, in millions, mean."""

import numpy as np


def read(layer):
    r = [x["edges_walked"] for x in layer.get("rows") or [] if "edges_walked" in x]
    return float(np.mean(r)) / 1e6 if r else None
