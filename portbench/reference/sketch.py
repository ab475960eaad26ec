"""The exact products a timed call is judged against, and the controls.

``exact`` computes B = S @ A in float64 from the operator the reference
regenerates (``gaussian``, ``fisher_yates``), in blocks of A's rows so it
fits beside the benchmark's data. ``control`` is the same product with
the operands rounded to the precision just below the one the
configuration states, accumulated in float32: the step a later change
might be tempted to take, which the comparison has to reject.
"""

from __future__ import annotations

import contextlib

import torch

from . import fisher_yates, gaussian

BLOCK = 8192

# the precision a configuration states -> the one just below it
BELOW = {"float64": "float32", "float32": "tf32",
         "bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}


def _operator_rows(op: dict, key: int, c0: int, rows: int, device):
    """The operator's columns c0 .. c0 + rows as a dense float64 (d, rows)
    block (the columns meet A's rows c0 .. c0 + rows)."""
    if op["kind"] == "dense":
        return gaussian.dense_block(key, op["d"], op["m"], c0, rows, device)
    idx, sgn = fisher_yates.saso_columns(key, op["d"], op["vec_nnz"], c0,
                                         rows, device)
    blk = torch.zeros((rows, op["d"]), dtype=torch.float64, device=device)
    blk.scatter_add_(1, idx, sgn)
    return blk.T


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to ``precision`` and held in float32 (TF32 keeps 10
    mantissa bits, rounded to nearest, ties away from zero)."""
    if precision == "tf32":
        bits = x.to(torch.float32).view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    return x.to(torch.float32).to(getattr(torch, precision)).to(
        torch.float32)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def exact(op: dict, key: int, a: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """float64 S[:, c0:c0 + rows] @ a, a the rows c0 .. c0 + rows of A."""
    out = torch.zeros((op["d"], a.shape[1]), dtype=torch.float64,
                      device=a.device)
    for r in range(0, a.shape[0], BLOCK):
        rows = min(BLOCK, a.shape[0] - r)
        s = _operator_rows(op, key, c0 + r, rows, a.device)
        out += s @ a[r:r + rows].to(torch.float64)
    return out


def control(op: dict, key: int, a: torch.Tensor, precision: str,
            c0: int = 0) -> torch.Tensor:
    """The product with both operands rounded to ``precision`` (the
    sparse operator's signs are exact in every precision) and float32
    sums; TF32 runs on the tensor cores where the card has them."""
    out = torch.zeros((op["d"], a.shape[1]), dtype=torch.float32,
                      device=a.device)
    native_tf32 = precision == "tf32" and a.is_cuda
    with _tf32(native_tf32):
        for r in range(0, a.shape[0], BLOCK):
            rows = min(BLOCK, a.shape[0] - r)
            s = _operator_rows(op, key, c0 + r, rows, a.device)
            blk = a[r:r + rows]
            if native_tf32:
                out += s.to(torch.float32) @ blk.to(torch.float32)
            else:
                out += _round(s, precision) @ _round(blk, precision)
    return out
