"""sketch_sparse: dense sketching operators applied to sparse data
(counterpart of randblas_tpu/sksp.py).

The operator block is filled from counters on the data's device (never the
full operator unless the block is the full operator), then combined with
the sparse data through the SpMM routes (sparse_data/spmm.py).

A word-major BlockedELL takes the block in natural row order: the kernel K5
reads it through the word-major map, so the block is never reordered. (The
JAX package hands its kernel the block in storage order, which the TPU's
plane fill produces for free.)
"""

from __future__ import annotations

from typing import Optional

import torch

from .base import Op, Side, dims_before_op, require
from .dense import DenseSkOp
from .skge import _as_op, _as_side
from .sparse_data.spmm import left_spmm


def _spmm(A, operand, op_a, alpha, d, ro_a, co_a):
    """left_spmm(A, operand, op_a=op_a, ...), with a word-major BlockedELL
    reading the natural-order operand through K5's map."""
    from .ops import ell_spmm
    if not (isinstance(A, ell_spmm.BlockedELL) and A.word_major):
        return left_spmm(A, operand, op_a=op_a, alpha=alpha, d=d, ro_a=ro_a,
                         co_a=co_a)
    require(op_a == Op.NoTrans and ro_a == 0 and co_a == 0
            and d == A.n_rows,
            "BlockedELL supports full untransposed left products; use "
            "to_coo() for general forms")
    require(operand.shape[0] == A.n_cols, "inner dimension mismatch")
    return ell_spmm.blocked_ell_matmul(A, operand, alpha, b_order="natural")


def sketch_sparse(
    S: DenseSkOp,
    A,
    *,
    side="left",
    op_s="N",
    op_a="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    m: Optional[int] = None,
    n: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
    ro_a: int = 0,
    co_a: int = 0,
) -> torch.Tensor:
    """left:  B = alpha * op_s(submat(S)) @ op_a(submat(A)) + beta * B
    right: B = alpha * op_a(submat(A)) @ op_s(submat(S)) + beta * B

    S is a dense sketching operator; A is sparse data (COO, CSR, CSC, ELL or
    BlockedELL). On the left, B is d x n and op_s(submat(S)) is d x m; m
    defaults to the operator's extent after (ro_s, co_s), capped by the
    data's, and n to the data's extent after (ro_a, co_a). On the right, B
    is m x d and op_a(submat(A)) is m x n, with the same defaults.
    """
    side = _as_side(side)
    op_s = _as_op(op_s)
    op_a = _as_op(op_a)
    require(isinstance(S, DenseSkOp),
            "sketch_sparse takes a dense sketching operator")
    if out is None:
        require(isinstance(beta, (int, float)) and beta == 0,
                "beta != 0 requires an `out` tensor to accumulate into")
    device = getattr(A, "device", None)
    coo_rows, coo_cols = A.n_rows, A.n_cols
    s_rows_av = S.n_rows - ro_s
    s_cols_av = S.n_cols - co_s
    if side == Side.Left:
        if d is None:
            d = out.shape[0] if out is not None else (
                s_rows_av if op_s == Op.NoTrans else s_cols_av)
        if m is None:
            m = s_cols_av if op_s == Op.NoTrans else s_rows_av
            m = min(m, coo_rows - ro_a if op_a == Op.NoTrans
                    else coo_cols - co_a)
        if n is None:
            n = (out.shape[1] if out is not None else
                 (coo_cols - co_a if op_a == Op.NoTrans else coo_rows - ro_a))
        rows_a_need, cols_a_need = (m, n) if op_a == Op.NoTrans else (n, m)
        require(coo_rows >= rows_a_need + ro_a, "A row range out of bounds")
        require(coo_cols >= cols_a_need + co_a,
                "A column range out of bounds")
        rows_s, cols_s = dims_before_op(d, m, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        # B = (op_a(submat(A))^T @ op_s(submat(S))^T)^T: left_spmm with the
        # flipped op, on op_s(submat(S))^T (submat^T for NoTrans, submat
        # itself for Trans)
        s_opnd = S.submat(rows_s, cols_s, ro_s, co_s, device=device)
        if op_s == Op.NoTrans:
            s_opnd = s_opnd.T
        flip_a = Op.NoTrans if op_a == Op.Trans else Op.Trans
        prod = _spmm(A, s_opnd, flip_a, alpha, n, ro_a, co_a).T
        expected = (d, n)
    else:
        if d is None:
            d = out.shape[1] if out is not None else (
                s_cols_av if op_s == Op.NoTrans else s_rows_av)
        if n is None:
            n = s_rows_av if op_s == Op.NoTrans else s_cols_av
            n = min(n, coo_cols - co_a if op_a == Op.NoTrans
                    else coo_rows - ro_a)
        if m is None:
            m = (out.shape[0] if out is not None else
                 (coo_rows - ro_a if op_a == Op.NoTrans else coo_cols - co_a))
        rows_a_need, cols_a_need = (m, n) if op_a == Op.NoTrans else (n, m)
        require(coo_rows >= rows_a_need + ro_a, "A row range out of bounds")
        require(coo_cols >= cols_a_need + co_a,
                "A column range out of bounds")
        rows_s, cols_s = dims_before_op(n, d, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        s_blk = S.submat(rows_s, cols_s, ro_s, co_s, device=device)
        if op_s == Op.Trans:
            s_blk = s_blk.T
        prod = _spmm(A, s_blk, op_a, alpha, m, ro_a, co_a)
        expected = (m, d)

    if out is not None:
        require(tuple(out.shape) == expected,
                f"out has shape {tuple(out.shape)}, expected {expected}")
        from .ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod
