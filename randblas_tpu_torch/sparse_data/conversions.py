"""Format conversions and transpose views (counterpart of
randblas_tpu/sparse_data/conversions.py). Results stay on the source's
device."""

from __future__ import annotations

import torch

from .base import NonzeroSort, indices_to_ptr
from .coo import COOMatrix
from .csc import CSCMatrix
from .csr import CSRMatrix


def coo_to_csr(a: COOMatrix) -> CSRMatrix:
    """Sorts CSR-style first."""
    s = a.sorted(NonzeroSort.CSR)
    return CSRMatrix(indices_to_ptr(s.rows, a.n_rows), s.cols, s.vals,
                     a.n_rows, a.n_cols)


def csr_to_coo(a: CSRMatrix) -> COOMatrix:
    return COOMatrix(a.row_indices(), a.colidxs, a.vals, a.n_rows, a.n_cols,
                     NonzeroSort.CSR)


def coo_to_csc(a: COOMatrix) -> CSCMatrix:
    """Sorts CSC-style first."""
    s = a.sorted(NonzeroSort.CSC)
    return CSCMatrix(indices_to_ptr(s.cols, a.n_cols), s.rows, s.vals,
                     a.n_rows, a.n_cols)


def csc_to_coo(a: CSCMatrix) -> COOMatrix:
    return COOMatrix(a.rowidxs, a.col_indices(), a.vals, a.n_rows, a.n_cols,
                     NonzeroSort.CSC)


def transpose_as_csc(a: CSRMatrix) -> CSCMatrix:
    """A CSR matrix's arrays read as its transpose in CSC, no copy."""
    return CSCMatrix(a.rowptr, a.colidxs, a.vals, a.n_cols, a.n_rows)


def transpose_as_csr(a: CSCMatrix) -> CSRMatrix:
    """The inverse of ``transpose_as_csc``, no copy."""
    return CSRMatrix(a.colptr, a.rowidxs, a.vals, a.n_cols, a.n_rows)


def to_coo(a) -> COOMatrix:
    """Any supported sparse container, or a sparse sketching operator, as
    COO triplets without copying values. A lazy operator is filled on the
    card."""
    from ..sparse import SparseSkOp
    from .ell import ELLMatrix, ell_to_coo
    if isinstance(a, COOMatrix):
        return a
    if isinstance(a, CSRMatrix):
        return csr_to_coo(a)
    if isinstance(a, CSCMatrix):
        return csc_to_coo(a)
    if isinstance(a, ELLMatrix):
        return ell_to_coo(a)
    if isinstance(a, SparseSkOp):
        s = a.filled()
        return COOMatrix(s.rows.to(torch.int32), s.cols.to(torch.int32),
                         s.vals, s.n_rows, s.n_cols, NonzeroSort.NONE)
    raise TypeError(f"not a sparse matrix: {type(a)!r}")


def sort_coo_data(a: COOMatrix, order: NonzeroSort) -> COOMatrix:
    """A COOMatrix with triplets in CSR- or CSC-style order."""
    return a.sorted(order)
