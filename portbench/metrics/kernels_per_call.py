"""kernels_per_call: the kernels the device ran in the traced window (rank
0 on a mesh), over the calls completed."""


def read(s):
    if not s["calls"] or not s["kernels"]:
        return None
    return s["kernels"] / s["calls"]
