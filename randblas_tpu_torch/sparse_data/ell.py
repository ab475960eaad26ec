"""ELL (ELLPACK) sparse matrices: a fixed number of slots per row, padded
with zero values (counterpart of randblas_tpu/sparse_data/ell.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..base import require
from .base import NonzeroSort, as_tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ELLMatrix:
    """colidxs: int32 (n_rows, width); vals: (n_rows, width).

    Padding entries have val == 0 and a valid column index, so gathers stay
    in bounds.
    """
    colidxs: torch.Tensor
    vals: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def width(self) -> int:
        return self.colidxs.shape[1]

    @property
    def nnz(self) -> int:
        """Stored slots, padding included."""
        return self.colidxs.shape[0] * self.colidxs.shape[1]

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_coo(coo, width: int = None) -> "ELLMatrix":
        """Host-side conversion from a COOMatrix, onto its device; width
        defaults to the densest row's count. Repeated (row, col) entries
        keep separate slots (they add in products, as in COO)."""
        rows = coo.rows.cpu().numpy()
        cols = coo.cols.cpu().numpy()
        vals = coo.vals.cpu().numpy()
        counts = np.bincount(rows, minlength=coo.n_rows)
        w = int(counts.max(initial=0)) if width is None else width
        require(w >= int(counts.max(initial=0)),
                "width smaller than the densest row")
        w = max(w, 1)
        cidx = np.zeros((coo.n_rows, w), dtype=np.int32)
        cval = np.zeros((coo.n_rows, w), dtype=vals.dtype)
        order = np.argsort(rows, kind="stable")
        sr = rows[order]
        starts = np.searchsorted(sr, np.arange(coo.n_rows))
        slot = np.arange(len(sr)) - starts[sr]
        cidx[sr, slot] = cols[order]
        cval[sr, slot] = vals[order]
        dev = coo.device
        return ELLMatrix(torch.from_numpy(cidx).to(dev),
                         torch.from_numpy(cval).to(dev), coo.n_rows,
                         coo.n_cols)

    @staticmethod
    def from_dense(mat, abs_tol: float = 0.0, device=None) -> "ELLMatrix":
        from .coo import COOMatrix
        return ELLMatrix.from_coo(COOMatrix.from_dense(mat, abs_tol, device))

    # -- ops ---------------------------------------------------------------

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.vals.dtype,
                            device=self.device)
        rows = torch.arange(self.n_rows, device=self.device).repeat_interleave(
            self.width)
        return dense.index_put_((rows, self.colidxs.reshape(-1).long()),
                                self.vals.reshape(-1), accumulate=True)

    def blocked(self, kb: int = 128, bw_cap: int = None,
                word_major: int = 0):
        """One-time host-side conversion to BlockedELL, the format of the
        SpMM kernel K5 (ops/ell_spmm.py); bw_cap caps the slots per (row,
        column block) and sends the excess through a COO overflow pass;
        word_major=W builds the tables for word-major operand storage."""
        from ..ops.ell_spmm import BlockedELL
        return BlockedELL.from_ell(self, kb=kb, bw_cap=bw_cap,
                                   word_major=word_major)

    def matmul(self, b: torch.Tensor, alpha=1.0) -> torch.Tensor:
        """self @ b by one gather pass per slot:
        out[r] = sum_t vals[r, t] * b[colidxs[r, t]]."""
        b = as_tensor(b, device=self.device)
        require(b.dim() == 2 and b.shape[0] == self.n_cols,
                "operand height must equal n_cols")
        acc = torch.zeros((self.n_rows, b.shape[1]), dtype=b.dtype,
                          device=b.device)
        for t in range(self.width):
            acc = acc + self.vals[:, t].to(b.dtype)[:, None] * \
                b[self.colidxs[:, t].long()]
        return torch.as_tensor(alpha, dtype=b.dtype) * acc


def coo_to_ell(coo, width: int = None) -> ELLMatrix:
    return ELLMatrix.from_coo(coo, width)


def ell_to_coo(a: ELLMatrix):
    """Padding slots stay as explicit zeros (products are unchanged)."""
    from .coo import COOMatrix
    rows = torch.arange(a.n_rows, dtype=torch.int32,
                        device=a.device).repeat_interleave(a.width)
    return COOMatrix(rows, a.colidxs.reshape(-1), a.vals.reshape(-1),
                     a.n_rows, a.n_cols, NonzeroSort.CSR)
