"""sketch_general: the primary sketching entry point (counterpart of
randblas_tpu/skge.py, dense operators).

    left:  B_new = alpha * op_s(submat(S)) @ op_a(A) + beta * B
    right: B_new = alpha * op_a(A) @ op_s(submat(S)) + beta * B

A and B are 2-D tensors (row-major, shape == math shape); S is a
DenseSkOp. Routes, each counted in ``route_counts``:

- ``left_fused``: a left NoTrans sketch by a lazy RowMajor-natural operator
  goes through the fused kernel K1 (ops/fused_sketch.py), which never
  stores the operator. On CUDA tensors ``use_fused="auto"`` takes it
  whenever ``fused_sketch_supported`` holds; on CPU tensors "auto" takes the
  staged route, and ``use_fused=True`` takes K1's plain version.
- ``left_staged`` / ``right_staged``: the operator block is filled, then
  multiplied with ``torch.matmul`` (float64 runs native FP64). This also
  carries the ColMajor-natural left, left-Trans and right sketches, which
  the JAX package sends to its transposed kernel on a TPU; that kernel (K2)
  is not ported yet.

No dispatch gate here comes from a TPU measurement; profit gates for the
H100 are ROADMAP.md item 13.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .base import Op, Side, dims_before_op, require
from .dense import DenseSkOp

# Fused-kernel dispatch policy: "auto" takes K1 on CUDA tensors whenever
# the call qualifies; True forces it (its plain version on the CPU) and
# raises if the call does not qualify; False always takes the staged route.
use_fused = "auto"

# Staged-route fill policy: False (default) fills with the plain PyTorch
# fill; True fills float32 blocks with the fill kernel K3 on CUDA tensors
# (its plain version on the CPU). Uniform values are bitwise equal either
# way; Gaussian values differ by about one ulp (signed-view u01).
use_kernel_fill = False

# how many calls took each route (see the module docstring)
route_counts = collections.Counter()


def _as_op(op) -> Op:
    if isinstance(op, Op):
        return op
    if isinstance(op, str):
        s = op.strip().upper()
        if s in ("N", "NOTRANS"):
            return Op.NoTrans
        if s in ("T", "TRANS"):
            return Op.Trans
    raise ValueError(f"invalid op: {op!r}")


def _as_side(side) -> Side:
    if isinstance(side, Side):
        return side
    s = str(side).strip().lower()
    if s in ("l", "left"):
        return Side.Left
    if s in ("r", "right"):
        return Side.Right
    raise ValueError(f"invalid side: {side!r}")


def _dense_block(S: DenseSkOp, rows_s: int, cols_s: int, ro_s: int,
                 co_s: int, op_s: Op, dtype, device) -> torch.Tensor:
    """op_s(submat(S)) as a dense tensor on ``device``."""
    from .ops import fused_sketch as fs
    if (S.materialized is None and use_kernel_fill
            and fs.fill_block_supported(S.dist, dtype, S.seed_state.rng)):
        blk = fs.fill_block(S, rows_s, cols_s, ro_s, co_s, device=device)
    else:
        blk = S.submat(rows_s, cols_s, ro_s, co_s, dtype=dtype,
                       device=device)
    return blk.T if op_s == Op.Trans else blk


def _scaled(alpha, prod: torch.Tensor) -> torch.Tensor:
    if isinstance(alpha, (int, float)) and alpha == 1:
        return prod
    return torch.as_tensor(alpha, dtype=prod.dtype) * prod


def _fused_eligible(S: DenseSkOp, rows_s, cols_s, ro_s, co_s, op_s,
                    A: torch.Tensor) -> bool:
    from .ops.fused_sketch import SUPPORTED_RNGS, fused_sketch_supported
    if use_fused is False or S.materialized is not None:
        return False
    if S.seed_state.rng not in SUPPORTED_RNGS:
        return False
    if not fused_sketch_supported(S.dist, rows_s, cols_s, ro_s, co_s, op_s,
                                  A.dtype):
        return False
    return use_fused is True or A.is_cuda


def sketch_general(
    S: DenseSkOp,
    A: torch.Tensor,
    *,
    side="left",
    op_s="N",
    op_a="N",
    alpha=1.0,
    beta=0.0,
    out: Optional[torch.Tensor] = None,
    d: Optional[int] = None,
    ro_s: int = 0,
    co_s: int = 0,
) -> torch.Tensor:
    """Sketch a general dense matrix A from the left or right.

    Args:
      S: sketching operator (DenseSkOp).
      A: data matrix, shape = its stored (math) shape; op_a transposes.
      side: 'left'  -> B = alpha op_s(submat(S)) op_a(A) + beta B  (d x n)
            'right' -> B = alpha op_a(A) op_s(submat(S)) + beta B  (n x d)
      d: sketch dimension. Defaults to the full-operator size implied by
         op_s(S) (or to out's shape).
      ro_s, co_s: submatrix offsets into S (counter-addressed).
      out: B to accumulate into (a new tensor is returned). Required
         whenever beta != 0.

    Returns B_new on A's device.
    """
    if not isinstance(S, DenseSkOp):
        raise NotImplementedError(
            f"{type(S).__name__}: only DenseSkOp is ported to "
            "randblas_tpu_torch; sparse operators are ROADMAP.md Queue 1 "
            "item 6 and SRHT/trig operators item 10")
    side = _as_side(side)
    op_s = _as_op(op_s)
    op_a = _as_op(op_a)
    A = torch.as_tensor(A)
    require(A.dim() == 2, "A must be 2-D")
    if out is None:
        require(isinstance(beta, (int, float)) and beta == 0,
                "beta != 0 requires an `out` tensor to accumulate into")
    dtype = A.dtype
    a_mat = A if op_a == Op.NoTrans else A.T

    if side == Side.Left:
        m, n = a_mat.shape
        if d is None:
            d = out.shape[0] if out is not None else (
                S.n_rows if op_s == Op.NoTrans else S.n_cols)
        rows_s, cols_s = dims_before_op(d, m, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        if _fused_eligible(S, rows_s, cols_s, ro_s, co_s, op_s, A):
            from .ops.fused_sketch import fused_sketch
            route_counts["left_fused"] += 1
            prod = fused_sketch(S, a_mat, alpha=float(alpha), rows_s=rows_s,
                                cols_s=cols_s, ro_s=ro_s, co_s=co_s)
        else:
            require(use_fused is not True,
                    "fused sketch path forced but the call is unsupported "
                    "(the fused kernel takes lazy RowMajor-natural "
                    "Gaussian/Uniform operators, NoTrans, f32/bf16 data)")
            route_counts["left_staged"] += 1
            s_blk = _dense_block(S, rows_s, cols_s, ro_s, co_s, op_s, dtype,
                                 A.device)
            prod = _scaled(alpha, torch.matmul(s_blk, a_mat))
        expected_shape = (d, n)
    else:
        n, m = a_mat.shape
        if d is None:
            d = out.shape[1] if out is not None else (
                S.n_cols if op_s == Op.NoTrans else S.n_rows)
        rows_s, cols_s = dims_before_op(m, d, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        route_counts["right_staged"] += 1
        s_blk = _dense_block(S, rows_s, cols_s, ro_s, co_s, op_s, dtype,
                             A.device)
        prod = _scaled(alpha, torch.matmul(a_mat, s_blk))
        expected_shape = (n, d)

    if out is not None:
        require(tuple(out.shape) == expected_shape,
                f"out has shape {tuple(out.shape)}, expected {expected_shape}")
        from .ops.accumulate import accumulate
        return accumulate(prod, beta, out)
    return prod


def sketch(S: DenseSkOp, A: torch.Tensor, *, side="left") -> torch.Tensor:
    """Convenience wrapper: plain S @ A (left) or A @ S (right)."""
    return sketch_general(S, A, side=side)
