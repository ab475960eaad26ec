"""Embedding-family factory shared by the linalg tier (counterpart of
randblas_tpu/linalg/embed.py)."""

from __future__ import annotations

import torch

from ..base import require
from ..dense import DenseDist, DenseSkOp
from ..rng.state import RNGState
from ..sparse import SparseDist, SparseSkOp
from ..trig import TrigDist, TrigSkOp


def make_embedding(operator: str, d: int, m: int, state: RNGState, *,
                   vec_nnz: int = 8, dtype=torch.float32):
    """A (d, m) sketching operator of the requested family: 'saso' (sparse
    sign), 'gaussian' (dense) or 'srht' (subsampled randomized Hadamard,
    O(m n log m) to apply whatever d is; dense data only)."""
    if operator == "saso":
        return SparseSkOp(SparseDist(d, m, vec_nnz=min(vec_nnz, d)), state)
    if operator == "gaussian":
        return DenseSkOp(DenseDist(d, m), state, dtype=dtype)
    if operator == "srht":
        return TrigSkOp(TrigDist(d, m), state, dtype=dtype)
    require(False, f"unknown embedding family {operator!r}; "
                   "expected 'saso', 'gaussian', or 'srht'")
