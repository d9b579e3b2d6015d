"""fit: the mean of the history rows' t_fit_s (banded_train_loss, its
backward and Adam), over the rows that fitted."""

import math

import numpy as np


def read(layer):
    r = [x for x in layer.get("rows") or [] if not math.isnan(x["loss"])]
    return 1e3 * float(np.mean([x["t_fit_s"] for x in r])) if r else None
