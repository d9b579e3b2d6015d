"""kernels: the band launches' least time over their device time in the
traced stretch.  Launches by kind from ops/band_kernels' counters, two
band_spmm launches a model call at width 2 (the degree passes), each bound
by roofline.pass_ms; device time summed over the band_mma_kernel records."""

from mdbench import roofline


def read(layer):
    st = layer.get("stretch")
    if not st:
        return None
    bound = roofline.launches_ms(st["bands"], st["counts"], 2 * st["calls"])
    return None if bound is None else 100.0 * bound / 1e3 / st["band_s"]
