"""device: the least time of the traced stretch's HCA model work at the
published peaks (roofline_hca.forward_ms a model call, the community graph
at two operations a live edge), over the stretch's wall time."""

from mdbench import roofline_hca


def read(layer):
    st = layer.get("stretch")
    if not st or "live_edges" not in st:
        return None
    work_ms = st["calls"] * roofline_hca.forward_ms(st["bands"], layer["n"], st["c_pad"],
                                                    sum(st["live_edges"]))
    return 100.0 * work_ms / 1e3 / st["st"].wall_s
