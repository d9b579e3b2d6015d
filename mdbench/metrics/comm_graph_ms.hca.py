"""kernels: the device ms, a model call, of the kernels launched inside the
program's range mdc.hca_comm_graph (models/hca_banded.banded_hca_forward's
community pass: the one-hot operand, K1, the community sums, the
binarisation), over the traced stretch; kernels placed by their launch
(mdbench/trace_ranges.py).  None where the program opens no such range."""


def read(layer):
    st = layer.get("stretch")
    if not st or not st.get("range_s") or not st["calls"]:
        return None
    s = st["range_s"].get("hca_comm_graph", 0.0)
    return 1e3 * s / st["calls"] if s > 0 else None
