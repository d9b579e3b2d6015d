"""device: the least time of the traced stretch's model work at the
published peaks (a selection and a target forward, roofline.forward_ms,
and a fit, roofline.fit_ms, where the iteration ran them), over the
stretch's wall time."""

from mdbench import roofline


def read(layer):
    st = layer.get("stretch")
    if not st:
        return None
    bands, n = st["bands"], layer["n"]
    work_ms = ((st["selects"] + st["targets"]) * roofline.forward_ms(bands, n)
               + st["fits"] * roofline.fit_ms(bands, n, layer["k"]))
    return 100.0 * work_ms / 1e3 / st["st"].wall_s
