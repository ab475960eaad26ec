"""The yardstick of the kernels layer: the published peaks of one H100
and the work a call of each cell needs.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
(no sparsity). A call's work counts each input byte read once and each
output byte written once; the operator, which the library never stores,
counts no bytes. Its operations are two a multiply-add of the product
the call computes, counted from the shapes, whatever kernels do it.
"""

from __future__ import annotations

PEAK_FLOPS = {              # per second, one card
    "float8_e4m3fn": 1979e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,       # outside the tensor cores
    "float64": 67e12,       # FP64 tensor cores
}
PEAK_BYTES = 3.35e12        # HBM3 bytes per second, one card
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def call_work(config: dict) -> tuple:
    """(operations, bytes) of one call: B = S @ A with S the
    configuration's (d, m) operator and A its (m, n) data."""
    op, data = config["operator"], config["data"]
    d, m, n = op["d"], op["m"], data["cols"]
    if op["kind"] == "dense":
        ops = 2 * d * m * n
    else:                     # k nonzeros in each of the m columns
        ops = 2 * op["vec_nnz"] * m * n
    size = ITEMSIZE[data["dtype"]]
    return ops, (m * n + d * n) * size


def least_seconds(config: dict, precision: str) -> float:
    """The least time of one call on the configuration's cards: its work
    spread over them, at the peak of ``precision`` or of the bandwidth,
    whichever bounds it."""
    ops, nbytes = call_work(config)
    chips = config["chips"]
    return max(ops / (chips * PEAK_FLOPS[precision]),
               nbytes / (chips * PEAK_BYTES))
