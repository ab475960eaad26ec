"""The yardstick of the kernels layer: the published peaks of one H100
and the least time of a call from its count of work.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
(no sparsity). A call's work is counted by its call module
(``calls/<call>.py``, ``work``): each input byte read once and each output
byte written once, operations two a multiply-add of what the call
computes, counted from the shapes, whatever kernels do it.
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


def least_seconds(ops: int, nbytes: int, chips: int,
                  precision: str) -> float:
    """The least time of one call of ``ops`` operations and ``nbytes``
    bytes (its call module's ``work``) spread over ``chips`` cards, at the
    peak of ``precision`` or of the bandwidth, whichever bounds it."""
    return max(ops / (chips * PEAK_FLOPS[precision]),
               nbytes / (chips * PEAK_BYTES))
