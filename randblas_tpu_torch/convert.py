"""Carry operators and sparse data across from the JAX package without
importing it.

A dense sketch is fully determined by its distribution and its seed state,
and a lazy sparse one by its distribution and seed too, so these take the
plain values the JAX package exposes: ``RNGState.to_dict()``, the
dimensions, ``vec_nnz``, and the enum names (or values). Filled operators
and sparse containers come across as their numpy arrays. Nothing here
imports jax.
"""

from __future__ import annotations

import torch

from .base import MajorAxis
from .dense import DenseDist, DenseDistName, DenseSkOp
from .rng.state import RNGState


def _enum(cls, x):
    if isinstance(x, cls):
        return x
    x = str(x)
    if x in cls.__members__:
        return cls[x]
    return cls(x)


def state_from_jax(d: dict) -> RNGState:
    """The state of a JAX ``RNGState.to_dict()`` snapshot."""
    return RNGState.from_dict(d)


def dist_from_jax(n_rows: int, n_cols: int, family: str,
                  major_axis: str) -> DenseDist:
    """A DenseDist from dimensions and enum names ("Gaussian", "Long") or
    values ("G", "L")."""
    return DenseDist(int(n_rows), int(n_cols),
                     _enum(DenseDistName, family),
                     _enum(MajorAxis, major_axis))


def skop_from_jax(n_rows: int, n_cols: int, family: str, major_axis: str,
                  state: dict, dtype=torch.float32) -> DenseSkOp:
    """A lazy DenseSkOp with the same values as the JAX operator built from
    the same distribution and ``state`` (a ``to_dict()`` snapshot)."""
    return DenseSkOp(dist_from_jax(n_rows, n_cols, family, major_axis),
                     state_from_jax(state), dtype=dtype)


def sparse_skop_from_jax(n_rows: int, n_cols: int, vec_nnz: int,
                         major_axis: str, state: dict, rows=None, cols=None,
                         vals=None, canonical: bool = False, device=None):
    """A SparseSkOp with the same entries as the JAX operator built from the
    same distribution and ``state`` (a ``to_dict()`` snapshot). Without
    triplets it is lazy; with (rows, cols, vals) numpy arrays (a filled or
    user-supplied operator's) it holds them on ``device`` (the card by
    default). ``canonical`` is the JAX operator's flag: True for triplets
    from its ``filled()``."""
    from .sparse import SparseDist, SparseSkOp
    dist = SparseDist(int(n_rows), int(n_cols), int(vec_nnz),
                      _enum(MajorAxis, major_axis))
    if rows is None:
        return SparseSkOp(dist, state_from_jax(state))
    from .sparse_data.base import as_tensor
    return SparseSkOp(dist, state_from_jax(state),
                      rows=as_tensor(rows, torch.int32, device),
                      cols=as_tensor(cols, torch.int32, device),
                      vals=as_tensor(vals, device=device),
                      canonical=canonical)


def coo_from_jax(n_rows: int, n_cols: int, rows, cols, vals,
                 sort: str = "None", device=None):
    """A COOMatrix from the JAX container's arrays (numpy) and its sort
    order's value ("CSR", "CSC" or "None")."""
    from .sparse_data import COOMatrix, NonzeroSort
    from .sparse_data.base import as_tensor
    return COOMatrix(as_tensor(rows, torch.int32, device),
                     as_tensor(cols, torch.int32, device),
                     as_tensor(vals, device=device), int(n_rows), int(n_cols),
                     _enum(NonzeroSort, sort))


def ell_from_jax(n_rows: int, n_cols: int, colidxs, vals, device=None):
    """An ELLMatrix from the JAX container's (n_rows, width) arrays."""
    from .sparse_data import ELLMatrix
    from .sparse_data.base import as_tensor
    return ELLMatrix(as_tensor(colidxs, torch.int32, device),
                     as_tensor(vals, device=device), int(n_rows), int(n_cols))


def blocked_ell_from_jax(local_cols, vals, n_rows: int, n_cols: int, kb: int,
                         bw: int, ovf_rows=None, ovf_cols=None,
                         ovf_vals=None, word_major: int = 0, device=None):
    """A BlockedELL from the JAX container's tables (numpy) and static
    fields."""
    from .ops.ell_spmm import BlockedELL
    from .sparse_data.base import as_tensor
    ovf = [None if x is None else as_tensor(x, dt, device)
           for x, dt in ((ovf_rows, torch.int32), (ovf_cols, torch.int32),
                         (ovf_vals, torch.float32))]
    return BlockedELL(as_tensor(local_cols, torch.int32, device),
                      as_tensor(vals, torch.float32, device), int(n_rows),
                      int(n_cols), int(kb), int(bw), *ovf,
                      word_major=int(word_major))
