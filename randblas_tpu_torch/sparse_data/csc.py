"""CSC sparse matrices (counterpart of randblas_tpu/sparse_data/csc.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..base import require
from .base import IndexBase, as_tensor, indices_to_ptr, ptr_to_indices


@dataclasses.dataclass(frozen=True, eq=False)
class CSCMatrix:
    """colptr: int32 (n_cols+1,); rowidxs: int32 (nnz,); vals: (nnz,)."""
    colptr: torch.Tensor
    rowidxs: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.rowidxs.shape[0]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @staticmethod
    def from_arrays(n_rows: int, n_cols: int, colptr, rowidxs, vals,
                    index_base: IndexBase = IndexBase.Zero,
                    device=None) -> "CSCMatrix":
        colptr = as_tensor(colptr, device=device)
        rowidxs = as_tensor(rowidxs, device=device)
        vals = as_tensor(vals, device=device)
        require(colptr.shape[0] == n_cols + 1, "colptr must be n_cols+1 long")
        require(rowidxs.shape == vals.shape, "rowidxs/vals length mismatch")
        if index_base == IndexBase.One:
            rowidxs = rowidxs - 1
        return CSCMatrix(colptr.to(torch.int32), rowidxs.to(torch.int32),
                         vals, int(n_rows), int(n_cols))

    @staticmethod
    def from_dense(mat, abs_tol: float = 0.0, device=None) -> "CSCMatrix":
        a = as_tensor(mat, device=device)
        c, r = torch.nonzero(a.T.abs() > abs_tol, as_tuple=True)  # by column
        return CSCMatrix(indices_to_ptr(c.to(torch.int32), a.shape[1]),
                         r.to(torch.int32), a[r, c], a.shape[0], a.shape[1])

    def col_indices(self) -> torch.Tensor:
        """Per-entry column indices (pointer expansion)."""
        return ptr_to_indices(self.colptr, self.nnz)

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.vals.dtype,
                            device=self.device)
        return dense.index_put_((self.rowidxs.long(),
                                 self.col_indices().long()), self.vals,
                                accumulate=True)
