"""kernels: the band launches' least time over their device time in the
traced stretch of iterations.  Launches by kind from ops/band_kernels'
counters; two band_spmm launches at width 2 (the degree passes) for each
selection forward, target forward and fit; each bound by roofline.pass_ms."""

from mdbench import roofline


def read(layer):
    st = layer.get("stretch")
    if not st:
        return None
    d2 = 2 * (st["selects"] + st["targets"] + st["fits"])
    bound = roofline.launches_ms(st["bands"], st["counts"], d2)
    return None if bound is None else 100.0 * bound / 1e3 / st["band_s"]
