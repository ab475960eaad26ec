"""Sparse-matrix containers: shared helpers (counterpart of
randblas_tpu/sparse_data/base.py).

Containers are frozen dataclasses of index and value tensors with their
shape as plain ints. They are always zero-based inside; one-based input is
reindexed at construction. Built from numpy arrays or lists they go to the
card unless ``device="cpu"`` is given; built from tensors they stay where
the tensors are.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..dense import default_device


class IndexBase(enum.Enum):
    Zero = "Z"
    One = "O"


class NonzeroSort(enum.Enum):
    """Sort order of COO triplets."""
    CSC = "CSC"   # sorted by (col, row)
    CSR = "CSR"   # sorted by (row, col)
    NONE = "None"


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device unless ``device`` is
    given; anything else goes to ``device``, the card by default."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.as_tensor(np.array(x), dtype=dtype,
                           device=default_device(device))


def detect_coo_sort(rows, cols) -> NonzeroSort:
    """Host-side sort detection on index arrays."""
    r = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows)
    c = np.asarray(cols.cpu() if isinstance(cols, torch.Tensor) else cols)
    if len(r) == 0:
        return NonzeroSort.CSR
    csr_key = r.astype(np.int64) * (int(c.max(initial=0)) + 1) + c
    if (np.diff(csr_key) >= 0).all():
        return NonzeroSort.CSR
    csc_key = c.astype(np.int64) * (int(r.max(initial=0)) + 1) + r
    if (np.diff(csc_key) >= 0).all():
        return NonzeroSort.CSC
    return NonzeroSort.NONE


def ptr_to_indices(ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand a compressed pointer array: int32 (nnz,) holding i for the
    entries in [ptr[i], ptr[i+1])."""
    positions = torch.arange(nnz, dtype=ptr.dtype, device=ptr.device)
    return (torch.searchsorted(ptr, positions, right=True) - 1).to(
        torch.int32)


def indices_to_ptr(idxs: torch.Tensor, dim: int) -> torch.Tensor:
    """Compressed pointer array from sorted per-entry indices:
    ptr[i] = #entries with index < i."""
    boundaries = torch.arange(dim + 1, dtype=idxs.dtype, device=idxs.device)
    return torch.searchsorted(idxs.contiguous(), boundaries).to(torch.int32)


def nnz_in_dense(mat, abs_tol: float = 0.0) -> int:
    """Count of entries with |x| > abs_tol."""
    if isinstance(mat, torch.Tensor):
        return int((mat.abs() > abs_tol).sum())
    return int((np.abs(np.asarray(mat)) > abs_tol).sum())
