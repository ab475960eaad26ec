"""SpMM: sparse x dense products with submatrix offsets and op flags
(counterpart of randblas_tpu/sparse_data/spmm.py).

Every format funnels into the COO apply (ops/coo_apply.py); transposes
swap the index roles without copying. A BlockedELL operand goes through
the kernel K5 (ops/ell_spmm.py), and so may a full untransposed product
with CSR, CSC or COO data on a CUDA tensor: the data is converted to
BlockedELL once, on the host, and the result is cached on the matrix.
``blocked_ell_profitable`` decides, from the product's width, the slot
width bw that the conversion would give (counted from the triplets before
any table is built) and the tables' size, by the H100 boundaries of
gate_sweep.py's G5 (PERF.md, "H100 gates") and a cap on the tables. The reference's right-sided
``spmm`` passes B twice; that bug is not copied.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import base
from ..base import Op, require
from ..ops.coo_apply import coo_left_apply_auto as coo_left_apply
from .conversions import to_coo

# BlockedELL route for full untransposed CSR/CSC/COO products: "auto" takes
# K5 on CUDA tensors where ``blocked_ell_profitable`` holds; True also on
# CPU tensors (its plain version), at any shape; False never.
auto_blocked_ell = "auto"

# K5 against the COO route on an NVIDIA H100 80GB HBM3 at 700 W
# (gate_sweep.py G5, config 4b's 20000 x 10000, two calls of two runs each;
# PERF.md "H100 gates"). Steady state, tables cached: K5 wins at every n
# from 8 to 2048 up to bw 32 and at every nnz from 2^12 to 1e6, and at n = 1
# up to 2^19 entries; a vector at bw 8 (1e6 entries) and 16 went to the COO
# route in the first call's two runs but not in the second's, so K5 stays.
# The COO route wins at n = 1 at bw 32 in all four runs (K5 0.51-0.56 ms
# against 0.26-0.37), at n <= 8 at bw 64 and at n <= 32 at bw 136 (one full
# row), where the conversion also builds 0.77 and 1.64 GiB of tables in 3.6
# and 5.0-6.6 s (bw 32: 0.39 GiB, 1.8-2.3 s).
BLOCKED_ELL_MAX_BW = 32    # wider slots: the COO route
BLOCKED_ELL_VECTOR_N = 8   # at the widest slots kept, narrower products too
# The tables hold rows x ceil(cols / 128) x bw slots whatever the entries: a
# 200000 x 150000 matrix of 3e7 entries (0.1% dense, bw 8) needs 1.9e9 slots,
# 62 a stored entry, which took 53 s of host conversion (28 ns a slot) and
# 16.8 GiB of device memory, to save 36 of 138 ms a QB call (chip_smoke.py
# phase 14 (A2s), same card). Past 2^27 slots (1 GiB of tables, ~4 s):
# the COO route.
BLOCKED_ELL_MAX_SLOTS = 2 ** 27
def _as_op(op) -> Op:
    if isinstance(op, Op):
        return op
    s = str(op).strip().upper()
    if s in ("N", "NOTRANS"):
        return Op.NoTrans
    if s in ("T", "TRANS"):
        return Op.Trans
    raise ValueError(f"invalid op: {op!r}")


def blocked_ell_profitable(n: int, bw: int, slots: int = 0) -> bool:
    """Whether "auto" takes K5 on the card for a product of width n with
    sparse data whose BlockedELL has slot width bw and ``slots`` table
    slots (no entry-count gate: K5 wins at every swept nnz)."""
    if bw > BLOCKED_ELL_MAX_BW or slots > BLOCKED_ELL_MAX_SLOTS:
        return False
    return bw < BLOCKED_ELL_MAX_BW or n >= BLOCKED_ELL_VECTOR_N


def _blocked_ell_or_none(A, b_mat):
    """A BlockedELL form of A for K5, converted once on the host and
    cached on A, or None when the route is off or, under "auto", the gate
    declines (decided before any table is built; bw is cached on A)."""
    if auto_blocked_ell is False or (auto_blocked_ell == "auto"
                                     and not base.on_card(b_mat)):
        return None
    from ..ops.ell_spmm import BlockedELL, slot_width
    if auto_blocked_ell == "auto":
        bw = getattr(A, "_bell_bw", None)
        if bw is None:
            coo = to_coo(A)
            bw = slot_width(coo.rows, coo.cols, coo.vals, coo.n_cols)
            object.__setattr__(A, "_bell_bw", bw)
        slots = A.shape[0] * -(-A.shape[1] // 128) * bw
        if not blocked_ell_profitable(b_mat.shape[1], bw, slots):
            return None
    cached = getattr(A, "_bell_cache", None)
    if cached is not None and cached.device == b_mat.device:
        return cached
    from .ell import ELLMatrix
    bell = BlockedELL.from_ell(ELLMatrix.from_coo(to_coo(A)),
                               device=b_mat.device)
    object.__setattr__(A, "_bell_cache", bell)
    return bell


def _finish(prod, beta, out):
    if out is None:
        return prod
    require(tuple(out.shape) == tuple(prod.shape), "out shape mismatch")
    from ..ops.accumulate import accumulate
    return accumulate(prod, beta, out)


def left_spmm(A, B: torch.Tensor, *, op_a="N", op_b="N", alpha=1.0,
              beta=0.0, out: Optional[torch.Tensor] = None,
              d: Optional[int] = None, ro_a: int = 0,
              co_a: int = 0) -> torch.Tensor:
    """C = alpha * op_a(submat(A))[d x m] @ op_b(B)[m x n] + beta * C.

    A: COO/CSR/CSC/ELL/BlockedELL matrix or SparseSkOp; B dense (stored
    shape; op_b transposes). d defaults to the full (possibly transposed)
    sparse height. Submatrix offsets work for every format but
    BlockedELL, whose B rows are in storage order (see ops/ell_spmm.py).
    """
    op_a = _as_op(op_a)
    op_b = _as_op(op_b)
    B = torch.as_tensor(B)
    require(B.dim() == 2, "B must be 2-D")
    from ..ops import ell_spmm
    from .ell import ELLMatrix
    b_mat = B if op_b == Op.NoTrans else B.T
    full = op_a == Op.NoTrans and ro_a == 0 and co_a == 0 \
        and (d is None or d == getattr(A, "n_rows", None))
    if isinstance(A, ell_spmm.BlockedELL):
        require(full, "BlockedELL supports full untransposed left products; "
                "use to_coo() for general forms")
        require(A.b_rows == b_mat.shape[0],
                "inner dimension mismatch (word-major operands must be in "
                "storage order, ops/ell_spmm.py::to_word_major_rows)")
        return _finish(ell_spmm.blocked_ell_matmul(A, b_mat, alpha), beta,
                       out)
    if isinstance(A, ELLMatrix) and full:
        require(A.n_cols == b_mat.shape[0], "inner dimension mismatch")
        return _finish(A.matmul(b_mat, alpha), beta, out)
    if full and not isinstance(A, ELLMatrix) \
            and getattr(A, "n_cols", None) == b_mat.shape[0]:
        bell = _blocked_ell_or_none(A, b_mat)
        if bell is not None:
            return _finish(ell_spmm.blocked_ell_matmul(bell, b_mat, alpha),
                           beta, out)
    coo = to_coo(A)
    rows, cols = coo.rows, coo.cols
    n_rows_a, n_cols_a = coo.n_rows, coo.n_cols
    if op_a == Op.Trans:
        rows, cols = cols, rows
        ro_a, co_a = co_a, ro_a
        n_rows_a, n_cols_a = n_cols_a, n_rows_a
    m, n = b_mat.shape
    if d is None:
        d = out.shape[0] if out is not None else n_rows_a - ro_a
    require(n_rows_a >= d + ro_a, "sparse row range out of bounds")
    require(n_cols_a >= m + co_a, "sparse column range out of bounds")
    dev = b_mat.device
    prod = coo_left_apply(rows.to(dev), cols.to(dev),
                          coo.vals.to(device=dev, dtype=b_mat.dtype), b_mat,
                          d, m, ro_a, co_a, alpha)
    return _finish(prod, beta, out)


def right_spmm(A: torch.Tensor, B, *, op_a="N", op_b="N", alpha=1.0,
               beta=0.0, out: Optional[torch.Tensor] = None,
               d: Optional[int] = None, ro_b: int = 0,
               co_b: int = 0) -> torch.Tensor:
    """C = alpha * op_a(A)[m x k] @ op_b(submat(B))[k x d] + beta * C,
    through left_spmm on the transpose:
    C^T = op_b(submat(B))^T @ op_a(A)^T. The offsets pass through as they
    are; left_spmm swaps them for the flipped op."""
    op_a = _as_op(op_a)
    op_b = _as_op(op_b)
    A = torch.as_tensor(A)
    a_mat = A if op_a == Op.NoTrans else A.T
    flip_b = Op.NoTrans if op_b == Op.Trans else Op.Trans
    ct = left_spmm(B, a_mat.T, op_a=flip_b, op_b=Op.NoTrans, alpha=alpha,
                   d=d, ro_a=ro_b, co_a=co_b)
    return _finish(ct.T, beta, out)


def spmm(A, B, *, side="left", **kwargs) -> torch.Tensor:
    """side='left': sparse A @ dense B (left_spmm); side='right': dense A @
    sparse B (right_spmm)."""
    s = str(side).strip().lower()
    if s in ("l", "left"):
        return left_spmm(A, B, **kwargs)
    if s in ("r", "right"):
        return right_spmm(A, B, **kwargs)
    raise ValueError(f"invalid side: {side!r}")
