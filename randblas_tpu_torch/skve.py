"""sketch_vector: GEMV-like sketching (counterpart of randblas_tpu/skve.py).

The reference reduces sketch_vector to a RowMajor sketch_general with n=1
(skve.hh:153-258); here it reduces to sketch_general on a column vector,
so it takes the same routes, K1 and K2 included.
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import Op, require
from .skge import _as_op, sketch_general


def sketch_vector(
    S,
    x: torch.Tensor,
    *,
    op_s="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    m: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
) -> torch.Tensor:
    """y = alpha * op_s(submat(S)) @ x + beta * y.

    d, m: dimensions of submat(S) *before* op_s is applied (matching the
    (d, m) arguments of skve.hh:153-176: rows/cols in submat(S)). Defaults
    to the full operator.
    """
    op_s = _as_op(op_s)
    x = torch.as_tensor(x)
    require(x.dim() == 1, "x must be 1-D")
    if d is None and m is None:
        d, m = S.n_rows, S.n_cols
    require(d is not None and m is not None, "give both d and m or neither")
    # after op: output length is d for NoTrans, m for Trans
    out_len, in_len = (d, m) if op_s == Op.NoTrans else (m, d)
    require(x.shape[0] == in_len, "x length mismatch")
    out2 = out[:, None] if out is not None else None
    y = sketch_general(S, x[:, None], side="left", op_s=op_s, alpha=alpha,
                       beta=beta, out=out2, d=out_len, ro_s=ro_s, co_s=co_s)
    return y[:, 0]
