"""Tiny copies of the benchmark's cells, for runs on the CPU."""

import copy

from portbench import harness

SIZES = {"dense_gauss_f32": (64, 2048, 256),
         "saso_k8_f32": (64, 2048, 128),
         "dense_gauss_rows_x4": (32, 1024, 64)}


def tiny(cell: str) -> dict:
    """The spec of ``cell`` with its operator and data cut to a tiny (d, m,
    n), every other setting as the benchmark states it."""
    spec = harness.find_cell(cell)
    call = spec.pop("call")             # a module: shared, not copied
    spec = copy.deepcopy(spec)
    spec["call"] = call
    d, m, n = SIZES[spec["cell"]["config"]]
    c = spec["config"]
    c["operator"]["d"], c["operator"]["m"] = d, m
    c["data"]["rows"], c["data"]["cols"] = m, n
    return spec
