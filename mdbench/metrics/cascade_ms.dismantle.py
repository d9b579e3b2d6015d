"""host env: the mean of the harness's span around the env's step_many
(one native cascade a batch), outside the profiled stretch."""

import numpy as np


def read(layer):
    c = layer.get("cascade_s") or []
    return 1e3 * float(np.mean(c)) if c else None
