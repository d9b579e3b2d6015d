"""device: the least time of the traced stretch's model work at the
published peaks (roofline.forward_ms a model call: band passes and dense
products), over the stretch's wall time."""

from mdbench import roofline


def read(layer):
    st = layer.get("stretch")
    if not st:
        return None
    work_ms = st["calls"] * roofline.forward_ms(st["bands"], layer["n"])
    return 100.0 * work_ms / 1e3 / st["st"].wall_s
