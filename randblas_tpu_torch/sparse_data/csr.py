"""CSR sparse matrices (counterpart of randblas_tpu/sparse_data/csr.py)."""

from __future__ import annotations

import dataclasses

import torch

from ..base import require
from .base import IndexBase, as_tensor, indices_to_ptr, ptr_to_indices


@dataclasses.dataclass(frozen=True, eq=False)
class CSRMatrix:
    """rowptr: int32 (n_rows+1,); colidxs: int32 (nnz,); vals: (nnz,)."""
    rowptr: torch.Tensor
    colidxs: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return self.colidxs.shape[0]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @staticmethod
    def from_arrays(n_rows: int, n_cols: int, rowptr, colidxs, vals,
                    index_base: IndexBase = IndexBase.Zero,
                    device=None) -> "CSRMatrix":
        rowptr = as_tensor(rowptr, device=device)
        colidxs = as_tensor(colidxs, device=device)
        vals = as_tensor(vals, device=device)
        require(rowptr.shape[0] == n_rows + 1, "rowptr must be n_rows+1 long")
        require(colidxs.shape == vals.shape, "colidxs/vals length mismatch")
        if index_base == IndexBase.One:
            colidxs = colidxs - 1
        return CSRMatrix(rowptr.to(torch.int32), colidxs.to(torch.int32),
                         vals, int(n_rows), int(n_cols))

    @staticmethod
    def from_dense(mat, abs_tol: float = 0.0, device=None) -> "CSRMatrix":
        a = as_tensor(mat, device=device)
        r, c = torch.nonzero(a.abs() > abs_tol, as_tuple=True)
        return CSRMatrix(indices_to_ptr(r.to(torch.int32), a.shape[0]),
                         c.to(torch.int32), a[r, c], a.shape[0], a.shape[1])

    def row_indices(self) -> torch.Tensor:
        """Per-entry row indices (pointer expansion)."""
        return ptr_to_indices(self.rowptr, self.nnz)

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.vals.dtype,
                            device=self.device)
        return dense.index_put_((self.row_indices().long(),
                                 self.colidxs.long()), self.vals,
                                accumulate=True)
