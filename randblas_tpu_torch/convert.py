"""Carry operators across from the JAX package without importing it.

A dense sketch is fully determined by its distribution and its seed state,
so these take the plain values the JAX package exposes:
``RNGState.to_dict()``, the dimensions, and the family and major-axis
enum names (or values). Nothing here imports jax.
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
