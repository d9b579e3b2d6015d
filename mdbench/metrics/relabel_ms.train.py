"""host env: the native engine's time relabelling affected component
records (union-find) in an iteration's cascade, relabel_ns in the history
rows, mean."""

import numpy as np


def read(layer):
    r = [x["relabel_ns"] for x in layer.get("rows") or [] if "relabel_ns" in x]
    return float(np.mean(r)) / 1e6 if r else None
