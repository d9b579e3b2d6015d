"""kernels: every band launch of the traced stretch at its least time (the
node pooling's band_spmm at width 64, the community pass's band_spmm_comm
at its chunk's width, mdbench/roofline_hca.py) over the band_mma_kernel
records' device time."""

from mdbench import roofline_hca


def read(layer):
    st = layer.get("stretch")
    if not st or "comm_widths" not in st:
        return None
    bound = roofline_hca.band_launches_ms(st["bands"], st["counts"], st["comm_widths"],
                                          st["calls"])
    return None if bound is None else 100.0 * bound / 1e3 / st["band_s"]
