"""Shared enums and small helpers (counterpart of randblas_tpu/base.py).

Tensors carry their own shape, so the reference's stride/ld plumbing
collapses to plain 2-D tensors. ``Layout`` is fill-order metadata for dense
distributions (it decides which entries receive which random values), and
``Op``/``Side`` are the flags of the sketching entry points.
"""

from __future__ import annotations

import enum
import sys


class MajorAxis(enum.Enum):
    """Fill-order / sparsity-structure selector."""
    Short = "S"
    Long = "L"
    Undefined = "U"


class Layout(enum.Enum):
    ColMajor = "C"
    RowMajor = "R"


class Op(enum.Enum):
    NoTrans = "N"
    Trans = "T"


class Side(enum.Enum):
    Left = "L"
    Right = "R"


def dims_before_op(m: int, n: int, op: Op):
    """Shape of the stored matrix X when op(X) is m-by-n."""
    return (m, n) if op == Op.NoTrans else (n, m)


def require(cond: bool, msg: str):
    """Host-side validation: raise ValueError when ``cond`` is false."""
    if not cond:
        raise ValueError(f"randblas_tpu_torch requirement failed: {msg}")


def on_card(t) -> bool:
    """Whether the "auto" dispatch gates treat tensor ``t`` as lying on the
    card. Every gate asks this one predicate, so a CPU test can stand a CPU
    tensor in for a CUDA one."""
    return t.is_cuda


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor. A DTensor exists
    only once its module is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_of(*xs):
    """The mesh of the first DTensor among ``xs``; None if none is one (no
    import either)."""
    return next((x.device_mesh for x in xs if is_dtensor(x)), None)
