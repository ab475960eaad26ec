"""COO sparse matrices (counterpart of randblas_tpu/sparse_data/coo.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..base import require
from .base import IndexBase, NonzeroSort, as_tensor, detect_coo_sort


@dataclasses.dataclass(frozen=True, eq=False)
class COOMatrix:
    """COO triplets with their shape and sort order.

    rows/cols: int32 (nnz,); vals: float (nnz,). Always zero-based.
    """
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int
    sort: NonzeroSort = NonzeroSort.NONE

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_arrays(n_rows: int, n_cols: int, rows, cols, vals,
                    index_base: IndexBase = IndexBase.Zero,
                    detect_sort: bool = True, device=None) -> "COOMatrix":
        """From index and value arrays (numpy, lists or tensors), on
        ``device`` (numpy input: the card by default)."""
        rows = as_tensor(rows, device=device)
        cols = as_tensor(cols, device=device)
        vals = as_tensor(vals, device=device)
        require(rows.shape == cols.shape == vals.shape,
                "rows/cols/vals must have equal length")
        if index_base == IndexBase.One:
            rows = rows - 1
            cols = cols - 1
        sort = detect_coo_sort(rows, cols) if detect_sort \
            else NonzeroSort.NONE
        return COOMatrix(rows.to(torch.int32), cols.to(torch.int32), vals,
                         int(n_rows), int(n_cols), sort)

    @staticmethod
    def from_dense(mat, abs_tol: float = 0.0, device=None) -> "COOMatrix":
        """The entries with |x| > abs_tol, in row-major order."""
        a = as_tensor(mat, device=device)
        require(a.dim() == 2, "dense input must be 2-D")
        r, c = torch.nonzero(a.abs() > abs_tol, as_tuple=True)
        return COOMatrix(r.to(torch.int32), c.to(torch.int32), a[r, c],
                         a.shape[0], a.shape[1], NonzeroSort.CSR)

    # -- ops ---------------------------------------------------------------

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.vals.dtype,
                            device=self.device)
        return dense.index_put_((self.rows.long(), self.cols.long()),
                                self.vals, accumulate=True)

    def transpose(self) -> "COOMatrix":
        """The transpose: index roles swap, no copy."""
        sort = {NonzeroSort.CSR: NonzeroSort.CSC,
                NonzeroSort.CSC: NonzeroSort.CSR,
                NonzeroSort.NONE: NonzeroSort.NONE}[self.sort]
        return COOMatrix(self.cols, self.rows, self.vals, self.n_cols,
                         self.n_rows, sort)

    def sorted(self, order: NonzeroSort) -> "COOMatrix":
        """A copy with triplets sorted CSR-style (row, col) or CSC-style
        (col, row); stable, as the JAX package's lexsort."""
        require(order in (NonzeroSort.CSR, NonzeroSort.CSC),
                "sort order must be CSR or CSC")
        if self.sort == order:
            return self
        major, minor = ((self.rows, self.cols) if order == NonzeroSort.CSR
                        else (self.cols, self.rows))
        perm = torch.sort(minor.long(), stable=True).indices
        perm = perm[torch.sort(major.long()[perm], stable=True).indices]
        return COOMatrix(self.rows[perm], self.cols[perm], self.vals[perm],
                         self.n_rows, self.n_cols, order)
