"""BLAS-style compatibility API (counterpart of randblas_tpu/compat.py).

The reference's entry-point signatures, (layout, opS, opA, d, n, m, alpha,
S, ro_s, co_s, A, lda, beta, B, ldb), with flat numpy buffers and in-place
updates of B, so the reference's tests and downstream code port nearly
verbatim. Overloads resolve by the type of the argument in the operator's
position, as in C++: sketch_general(..., S, ro_s, co_s, A, lda, ...) is the
left sketch, sketch_general(..., A, lda, S, ro_s, co_s, ...) the right one.

A host-side shim over the functional API: each call copies its buffers to
``device`` (keyword-only; the card by default) and writes the result back.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Layout, Op, require
from .dense import DenseSkOp, default_device
from .skge import sketch_general as _sketch_general
from .sparse import SparseSkOp

ColMajor = Layout.ColMajor
RowMajor = Layout.RowMajor
NoTrans = Op.NoTrans
Trans = Op.Trans


def _as_layout(layout) -> Layout:
    if isinstance(layout, Layout):
        return layout
    s = str(layout).strip().lower()
    if s in ("c", "colmajor", "col"):
        return Layout.ColMajor
    if s in ("r", "rowmajor", "row"):
        return Layout.RowMajor
    raise ValueError(f"invalid layout: {layout!r}")


def read_mat(layout, buff, n_rows: int, n_cols: int, ld: int,
             offset: int = 0) -> np.ndarray:
    """The (n_rows, n_cols) matrix a flat buffer holds in ``layout`` with
    leading dimension ld (a numpy view)."""
    layout = _as_layout(layout)
    buff = np.asarray(buff).reshape(-1)
    if layout == Layout.ColMajor:
        require(ld >= n_rows, "lda must be >= n_rows for ColMajor")
        block = buff[offset:offset + ld * n_cols]
        return block.reshape(n_cols, ld).T[:n_rows, :]
    require(ld >= n_cols, "lda must be >= n_cols for RowMajor")
    block = buff[offset:offset + ld * n_rows]
    return block.reshape(n_rows, ld)[:, :n_cols]


def write_mat(layout, buff, mat, ld: int, offset: int = 0) -> None:
    """Write a 2-D matrix back into a flat buffer in layout order."""
    layout = _as_layout(layout)
    mat = mat.cpu().numpy() if isinstance(mat, torch.Tensor) \
        else np.asarray(mat)
    n_rows, n_cols = mat.shape
    flat = np.asarray(buff).reshape(-1)
    if layout == Layout.ColMajor:
        block = flat[offset:offset + ld * n_cols].reshape(n_cols, ld)
        block[:, :n_rows] = mat.T
    else:
        block = flat[offset:offset + ld * n_rows].reshape(n_rows, ld)
        block[:, :n_cols] = mat


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=default_device(device))


def _is_skop(x) -> bool:
    return isinstance(x, (DenseSkOp, SparseSkOp))


def sketch_general(layout, op1, op2, dim1, dim2, dim3, alpha, arg8, *rest,
                   device=None):
    """The reference's four overloads, resolved by argument types and
    counts as C++ resolves them. B (a numpy buffer) is updated in place.

    left  sub : (layout, opS, opA, d, n, m, alpha, S, ro_s, co_s, A, lda,
                 beta, B, ldb)
    left  full: (layout, opS, opA, d, n, m, alpha, S, A, lda, beta, B, ldb)
    right sub : (layout, opA, opS, m, d, n, alpha, A, lda, S, ro_s, co_s,
                 beta, B, ldb)
    right full: (layout, opA, opS, m, d, n, alpha, A, lda, S, beta, B, ldb)
    """
    layout = _as_layout(layout)
    if _is_skop(arg8):
        S = arg8
        if len(rest) == 7:      # left, submatrix
            ro_s, co_s, A, lda, beta, B, ldb = rest
        elif len(rest) == 5:    # left, full operator
            A, lda, beta, B, ldb = rest
            ro_s, co_s = 0, 0
            require((S.n_rows, S.n_cols) == ((dim1, dim3)
                                             if Op(op1) == Op.NoTrans
                                             else (dim3, dim1)),
                    "operator dims inconsistent with (d, m) and opS")
        else:
            raise TypeError(f"unexpected argument count: {len(rest)}")
        opS, opA = op1, op2
        d, n, m = dim1, dim2, dim3
        rows_a, cols_a = (m, n) if Op(opA) == Op.NoTrans else (n, m)
        a_mat = read_mat(layout, A, rows_a, cols_a, lda)
        b_mat = read_mat(layout, B, d, n, ldb)
        out = _sketch_general(S, _tensor(a_mat, device), side="left",
                              op_s=opS, op_a=opA, alpha=alpha, beta=beta,
                              out=_tensor(b_mat, device), d=d, ro_s=ro_s,
                              co_s=co_s)
        write_mat(layout, B, out, ldb)
        return
    opA, opS = op1, op2
    m, d, n = dim1, dim2, dim3
    A, lda = arg8, rest[0]
    S = rest[1]
    require(_is_skop(S), "expected a sketching operator argument")
    if len(rest) == 7:          # right, submatrix
        ro_s, co_s, beta, B, ldb = rest[2:]
    elif len(rest) == 5:        # right, full operator
        ro_s, co_s = 0, 0
        beta, B, ldb = rest[2:]
    else:
        raise TypeError(f"unexpected argument count: {len(rest)}")
    rows_a, cols_a = (m, n) if Op(opA) == Op.NoTrans else (n, m)
    a_mat = read_mat(layout, A, rows_a, cols_a, lda)
    b_mat = read_mat(layout, B, m, d, ldb)
    out = _sketch_general(S, _tensor(a_mat, device), side="right", op_s=opS,
                          op_a=opA, alpha=alpha, beta=beta,
                          out=_tensor(b_mat, device), d=d, ro_s=ro_s,
                          co_s=co_s)
    write_mat(layout, B, out, ldb)


def sketch_vector(opS, *args, device=None):
    """sketch_vector(opS[, d, m], alpha, S, [ro_s, co_s,] x, incx, beta, y,
    incy), as the reference's overloads; y is updated in place."""
    from .skve import sketch_vector as _sv
    if len(args) == 11:
        d, m, alpha, S, ro_s, co_s, x, incx, beta, y, incy = args
    elif len(args) == 7:
        alpha, S, x, incx, beta, y, incy = args
        d, m, ro_s, co_s = S.n_rows, S.n_cols, 0, 0
    else:
        raise TypeError(f"unexpected argument count: {len(args)}")
    out_len = d if Op(opS) == Op.NoTrans else m
    in_len = m if Op(opS) == Op.NoTrans else d
    xv = np.asarray(x).reshape(-1)[::incx][:in_len]
    yv = np.asarray(y).reshape(-1)
    y_view = yv[::incy][:out_len]
    out = _sv(S, _tensor(xv, device), op_s=opS, alpha=alpha, beta=beta,
              out=_tensor(y_view, device), d=d, m=m, ro_s=ro_s, co_s=co_s)
    yv[::incy][:out_len] = out.cpu().numpy()


def sketch_symmetric(layout, *args, sym_check_tol=0.0, device=None):
    """The reference's sketch_symmetric overloads, resolved by argument
    count and the operator's position:

    left  sub : (layout, d, n, alpha, S, ro_s, co_s, A, lda, beta, B, ldb)
    left  full: (layout, alpha, S, A, lda, beta, B, ldb)
    right sub : (layout, n, d, alpha, A, lda, S, ro_s, co_s, beta, B, ldb)
    right full: (layout, alpha, A, lda, S, beta, B, ldb)
    """
    from .sksy import sketch_symmetric as _ss
    layout = _as_layout(layout)
    if len(args) == 7 and _is_skop(args[1]):        # left full
        alpha, S, A, lda, beta, B, ldb = args
        d, n, ro_s, co_s = S.n_rows, S.n_cols, 0, 0
        side = "left"
    elif len(args) == 11 and _is_skop(args[3]):     # left submatrix
        d, n, alpha, S, ro_s, co_s, A, lda, beta, B, ldb = args
        side = "left"
    elif len(args) == 7 and _is_skop(args[3]):      # right full
        alpha, A, lda, S, beta, B, ldb = args
        n, d, ro_s, co_s = S.n_rows, S.n_cols, 0, 0
        side = "right"
    elif len(args) == 11 and _is_skop(args[5]):     # right submatrix
        n, d, alpha, A, lda, S, ro_s, co_s, beta, B, ldb = args
        side = "right"
    else:
        raise TypeError("unrecognized sketch_symmetric overload")
    a_mat = read_mat(layout, A, n, n, lda)
    b_mat = read_mat(layout, B, *((d, n) if side == "left" else (n, d)), ldb)
    out = _ss(S, _tensor(a_mat, device), side=side, alpha=alpha, beta=beta,
              out=_tensor(b_mat, device), d=d, ro_s=ro_s, co_s=co_s,
              sym_check_tol=sym_check_tol)
    write_mat(layout, B, out, ldb)


def fill_dense(layout, dist, n_rows, n_cols, ro_s, co_s, buff, seed,
               device=None):
    """Fill a flat buffer with the (ro_s, co_s) block of the operator in
    the requested layout; returns the next state."""
    from .dense import dist_to_layout, fill_dense_submat, major_axis_length
    from .ops.dense_fill import fill_next_state
    layout = _as_layout(layout)
    dtype = torch.from_numpy(np.zeros(0, np.asarray(buff).dtype)).dtype
    vals = fill_dense_submat(dist, seed, n_rows, n_cols, ro_s, co_s,
                             dtype=dtype, device=device)
    write_mat(layout, buff, vals,
              n_rows if layout == Layout.ColMajor else n_cols)
    ma_len = major_axis_length(dist)
    if dist_to_layout(dist) == Layout.ColMajor:
        n_rows_, n_cols_, ptr = n_cols, n_rows, ro_s + co_s * ma_len
    else:
        n_rows_, n_cols_, ptr = n_rows, n_cols, ro_s * ma_len + co_s
    return fill_next_state(ma_len, n_rows_, n_cols_, ptr, seed)


def omatcopy(m: int, n: int, a, irs_a: int, ics_a: int, b, irs_b: int,
             ics_b: int) -> None:
    """Strided out-of-place copy: element (i, j) of the m x n matrix is
    read at a[i*irs_a + j*ics_a] and written to b[i*irs_b + j*ics_b] (flat
    numpy buffers)."""
    a = np.asarray(a).reshape(-1)
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    b.reshape(-1)[i * irs_b + j * ics_b] = a[i * irs_a + j * ics_a]


def flip_layout(layout_in, m: int, n: int, a, lda: int, b, ldb: int) -> None:
    """Copy an m x n matrix stored in ``layout_in`` (leading dimension
    lda) into the other layout (leading dimension ldb)."""
    lin = _as_layout(layout_in)
    lout = Layout.ColMajor if lin == Layout.RowMajor else Layout.RowMajor
    write_mat(lout, b, read_mat(lin, a, m, n, lda), ldb)
