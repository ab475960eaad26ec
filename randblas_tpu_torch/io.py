"""MatrixMarket reading and writing into the port's containers (counterpart
of randblas_tpu/io.py); scipy.io parses the files."""

from __future__ import annotations

import numpy as np
import torch

from .base import require
from .dense import default_device


def load_matrix_market(path: str, format: str = "coo", device=None):
    """Read a MatrixMarket file into a sparse container ('coo', 'csr',
    'csc', 'ell') or a dense float32 tensor ('dense'), on ``device`` (the
    card by default)."""
    try:
        from scipy.io import mmread
    except ImportError as e:
        raise ImportError(
            "load_matrix_market needs scipy (pip extra: test)") from e
    from .sparse_data import COOMatrix, coo_to_csc, coo_to_csr, coo_to_ell

    mat = mmread(path)
    fmt = format.lower()
    if fmt == "dense":
        dense = mat.todense() if hasattr(mat, "todense") else mat
        return torch.as_tensor(np.asarray(dense, dtype=np.float32),
                               device=default_device(device))
    sp = mat.tocoo() if hasattr(mat, "tocoo") else None
    require(sp is not None, "file does not contain a sparse matrix")
    coo = COOMatrix.from_arrays(sp.shape[0], sp.shape[1], sp.row, sp.col,
                                sp.data.astype(np.float32), device=device)
    if fmt == "coo":
        return coo
    if fmt == "csr":
        return coo_to_csr(coo)
    if fmt == "csc":
        return coo_to_csc(coo)
    if fmt == "ell":
        return coo_to_ell(coo)
    raise ValueError(f"unknown format {format!r}")


def save_matrix_market(path: str, a) -> None:
    """Write a sparse container (or a dense tensor or array) to a
    MatrixMarket file."""
    try:
        from scipy.io import mmwrite
        from scipy.sparse import coo_matrix
    except ImportError as e:
        raise ImportError(
            "save_matrix_market needs scipy (pip extra: test)") from e
    from .sparse_data import to_coo

    if hasattr(a, "nnz"):
        coo = to_coo(a)
        sp = coo_matrix((coo.vals.cpu().numpy(),
                         (coo.rows.cpu().numpy(), coo.cols.cpu().numpy())),
                        shape=coo.shape)
        mmwrite(path, sp)
    else:
        mmwrite(path, a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))
