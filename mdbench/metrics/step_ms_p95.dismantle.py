"""loop: the 95th percentile of one batch's time (its cascade, its severs
and the next model call), from the shadow hook's timestamps over the
window's batches outside the profiled stretch."""

import numpy as np


def read(layer):
    s = layer.get("step_s") or []
    return 1e3 * float(np.percentile(s, 95)) if len(s) >= 20 else None
