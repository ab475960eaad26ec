"""sketch_general: the primary sketching entry point (counterpart of
randblas_tpu/skge.py, dense and sparse-sign operators).

    left:  B_new = alpha * op_s(submat(S)) @ op_a(A) + beta * B
    right: B_new = alpha * op_a(A) @ op_s(submat(S)) + beta * B

A and B are 2-D tensors (row-major, shape == math shape); S is a
DenseSkOp or a SparseSkOp. Dense routes, tried in this order and each
counted in ``route_counts``:

- ``left_fused``: a left NoTrans sketch by a lazy RowMajor-natural operator
  goes through the fused kernel K1 (ops/fused_sketch.py), which never
  stores the operator.
- ``left_colmajor_fused``: the same for a ColMajor-natural operator
  (wide+Short, tall+Long), through K2.
- ``left_trans_fused``: a left sketch by op_s = Trans. The transposed block
  block(S, r, c, ro, co)^T is block(S_t, c, r, co, ro) of the transposed
  distribution S_t with the same seed, whose natural layout is the other
  one, so it goes through K1 or K2.
- ``right_fused``: B = op_a(A) @ op_s(block) = (op_s(block)^T @ op_a(A)^T)^T
  through K1: op_s = Trans with a RowMajor-natural S, or op_s = NoTrans with
  a ColMajor-natural S (its S_t is RowMajor-natural).
- ``left_staged`` / ``right_staged``: the operator block is filled, then
  multiplied with ``torch.matmul`` (float64 runs native FP64).

A fused route needs a lazy operator, a Philox4x32/Threefry4x32 seed and
float32 or bf16 data. On CUDA tensors ``use_fused="auto"`` takes a fused
route whenever one is eligible; on CPU tensors "auto" takes the staged
route, and ``use_fused=True`` takes the kernels' plain versions. A square
distribution transposes to itself, so the identity behind the left-Trans
and right routes fails for it and they leave it to the staged route. The
fused routes are differentiable in A (ops/fused_sketch.py).

Sparse-sign operators (SparseSkOp) take ``_sparse_left_apply``; a right
sketch is the left sketch of the transposes. Its routes, counted the same
way:

- ``sparse_saso_kernel``: the full wide SASO, and the transposed full tall
  SASO (whose transpose is wide), through K4 (ops/saso_sketch.py), which
  reads the data once. On CUDA tensors ``use_saso_kernel="auto"`` takes it
  whenever ``saso_sketch_supported`` holds and the data is float32;
  ``True`` also runs K4's plain version on the CPU; ``False`` never.
- ``sparse_fixed_nnz``: the same operators by one ``index_add_`` per slot.
- ``sparse_row_gather``: the full tall SASO, and the transposed full wide
  one: each output row gathers k data rows.
- ``sparse_coo``: any other block, or triplets not in the fill's order.

No dispatch gate here comes from a TPU measurement; profit gates for the
H100 are ROADMAP.md item 13.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .base import MajorAxis, Op, Side, dims_before_op, require
from .dense import DenseDist, DenseSkOp
from .sparse import SparseSkOp

# Fused-kernel dispatch policy: "auto" takes a fused route (K1 or K2) on
# CUDA tensors whenever the call qualifies; True forces the fused routes
# (the kernels' plain versions on the CPU), and a forced left sketch that
# no fused route takes raises; False always takes the staged route.
use_fused = "auto"

# Staged-route fill policy: False (default) fills with the plain PyTorch
# fill; True fills float32 blocks with the fill kernel K3 on CUDA tensors
# (its plain version on the CPU). Uniform values are bitwise equal either
# way; Gaussian values differ by about one ulp (signed-view u01).
use_kernel_fill = False

# SASO kernel (K4) dispatch policy: "auto" takes K4 on CUDA tensors whenever
# the call qualifies; True also runs its plain version on the CPU; False
# always takes the fixed-nnz route.
use_saso_kernel = "auto"

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


def _fused_gates_ok(S: DenseSkOp, A: torch.Tensor) -> bool:
    from .ops.fused_sketch import SUPPORTED_RNGS
    return (use_fused is not False and S.materialized is None
            and S.seed_state.rng in SUPPORTED_RNGS
            and A.dtype in (torch.float32, torch.bfloat16)
            and (use_fused is True or A.is_cuda))


def _transposed_op(S: DenseSkOp) -> DenseSkOp:
    """The operator of the transposed distribution with the same seed."""
    d = S.dist
    return DenseSkOp(DenseDist(d.n_cols, d.n_rows, d.family, d.major_axis),
                     S.seed_state, dtype=S.dtype)


def _fused(S: DenseSkOp, a_mat, alpha, blk):
    """(kernel name, alpha * block(S) @ a_mat) through K1 or K2 for the
    block ``blk`` = (rows_s, cols_s, ro_s, co_s), or None if neither
    takes it."""
    from .ops import fused_sketch as fs
    rows_s, cols_s, ro_s, co_s = blk
    for name, supported, kernel in (
            ("K1", fs.fused_sketch_supported, fs.fused_sketch),
            ("K2", fs.fused_sketch_colmajor_supported,
             fs.fused_sketch_colmajor)):
        if supported(S.dist, *blk, Op.NoTrans, a_mat.dtype):
            return name, kernel(S, a_mat, alpha=float(alpha), rows_s=rows_s,
                                cols_s=cols_s, ro_s=ro_s, co_s=co_s)
    return None


def _left_fused_or_none(S: DenseSkOp, a_mat, blk, op_s: Op, alpha):
    """(route, alpha * op_s(block(S)) @ a_mat) through K1 or K2, or None."""
    if not _fused_gates_ok(S, a_mat):
        return None
    if op_s == Op.NoTrans:
        fused = _fused(S, a_mat, alpha, blk)
        if fused is None:
            return None
        kernel, prod = fused
        return ("left_fused" if kernel == "K1" else "left_colmajor_fused",
                prod)
    if S.n_rows == S.n_cols:
        return None
    rows_s, cols_s, ro_s, co_s = blk
    fused = _fused(_transposed_op(S), a_mat, alpha,
                   (cols_s, rows_s, co_s, ro_s))
    return None if fused is None else ("left_trans_fused", fused[1])


def _right_fused_or_none(S: DenseSkOp, a_mat, blk, op_s: Op, alpha):
    """alpha * a_mat @ op_s(block(S)) through K1, or None. The left operand
    of the transposed product is the stored block for op_s = Trans, and
    the transposed distribution's block for op_s = NoTrans."""
    if not _fused_gates_ok(S, a_mat):
        return None
    if op_s == Op.Trans:
        S_l = S
    elif S.n_rows != S.n_cols:
        rows_s, cols_s, ro_s, co_s = blk
        S_l, blk = _transposed_op(S), (cols_s, rows_s, co_s, ro_s)
    else:
        return None
    from .ops.fused_sketch import fused_sketch, fused_sketch_supported
    if not fused_sketch_supported(S_l.dist, *blk, Op.NoTrans, a_mat.dtype):
        return None
    rows_s, cols_s, ro_s, co_s = blk
    return fused_sketch(S_l, a_mat.T, alpha=float(alpha), rows_s=rows_s,
                        cols_s=cols_s, ro_s=ro_s, co_s=co_s).T


def _saso_kernel_ok(d: int, m: int, k: int, b: torch.Tensor) -> bool:
    """Whether K4 takes a (d, m) wide-SASO product with k slots per column
    on b: its shape gate (the JAX package's: k <= 16, ceil(d / 128) * 128
    <= 4096) and float32 data, on a CUDA tensor under "auto" or anywhere
    under True."""
    from .ops.saso_sketch import saso_sketch_supported
    return (use_saso_kernel is not False
            and saso_sketch_supported(d, m, k, b.shape[1])
            and b.dtype == torch.float32
            and (use_saso_kernel is True or b.is_cuda))


def _fixed_nnz(idx, vals, b, d, alpha):
    """(route, alpha * S @ b) for a wide SASO given per data column:
    K4 when it takes the call, else one index_add_ per slot."""
    from .ops.coo_apply import fixed_nnz_left_apply
    from .ops.saso_sketch import saso_sketch
    if _saso_kernel_ok(d, idx.shape[0], idx.shape[1], b):
        return "sparse_saso_kernel", saso_sketch(idx, vals, b, d, alpha)
    return "sparse_fixed_nnz", fixed_nnz_left_apply(idx, vals, b, d, alpha)


def _sparse_left_apply(S: SparseSkOp, d: int, m: int, ro_s: int, co_s: int,
                       op_s: Op, b_mat: torch.Tensor, alpha):
    """(route, alpha * op_s(submat(S)) @ b_mat) for a sparse-sign operator,
    filled on b_mat's device. A transposed operator swaps the COO index
    roles and the offsets."""
    from .ops.coo_apply import coo_left_apply_auto, row_gather_apply

    s = S.filled(b_mat.device)
    k = S.dist.vec_nnz
    saso = s.canonical and S.dist.major_axis == MajorAxis.Short \
        and ro_s == 0 and co_s == 0
    wide, tall = S.n_rows < S.n_cols, S.n_rows > S.n_cols
    if saso and op_s == Op.NoTrans and (d, m) == S.shape:
        if wide:   # k entries in each data column
            return _fixed_nnz(s.rows.reshape(m, k), s.vals.reshape(m, k),
                              b_mat, d, alpha)
        if tall:   # k entries in each output row
            return "sparse_row_gather", row_gather_apply(
                s.cols.reshape(d, k), s.vals.reshape(d, k), b_mat, alpha)
    if saso and op_s == Op.Trans and (m, d) == S.shape:
        # the right sketch arrives here: S^T of a tall SASO is wide with k
        # entries per column, S^T of a wide one has k per output row
        if tall:
            return _fixed_nnz(s.cols.reshape(m, k), s.vals.reshape(m, k),
                              b_mat, d, alpha)
        if wide:
            return "sparse_row_gather", row_gather_apply(
                s.rows.reshape(d, k), s.vals.reshape(d, k), b_mat, alpha)
    rows, cols = s.rows, s.cols
    if op_s == Op.Trans:
        rows, cols = cols, rows
        ro_s, co_s = co_s, ro_s
    return "sparse_coo", coo_left_apply_auto(
        rows, cols, s.vals.to(b_mat.dtype), b_mat, d, m, ro_s, co_s, alpha)


def sketch_general(
    S,
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
      S: sketching operator (DenseSkOp or SparseSkOp).
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
    if not isinstance(S, (DenseSkOp, SparseSkOp)):
        raise NotImplementedError(
            f"{type(S).__name__}: randblas_tpu_torch sketches with DenseSkOp "
            "and SparseSkOp; the SRHT/trig operators are ROADMAP.md Queue 1 "
            "item 10")
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
        if isinstance(S, SparseSkOp):
            route, prod = _sparse_left_apply(S, d, m, ro_s, co_s, op_s, a_mat,
                                             alpha)
        elif (fused := _left_fused_or_none(
                S, a_mat, (rows_s, cols_s, ro_s, co_s), op_s,
                alpha)) is not None:
            route, prod = fused
        else:
            require(use_fused is not True,
                    "fused sketch path forced but the call is unsupported "
                    "(the fused kernels take lazy Gaussian/Uniform "
                    "operators with a 4x32 generator and f32/bf16 data)")
            route = "left_staged"
            s_blk = _dense_block(S, rows_s, cols_s, ro_s, co_s, op_s, dtype,
                                 A.device)
            prod = _scaled(alpha, torch.matmul(s_blk, a_mat))
        route_counts[route] += 1
        expected_shape = (d, n)
    else:
        n, m = a_mat.shape
        if d is None:
            d = out.shape[1] if out is not None else (
                S.n_cols if op_s == Op.NoTrans else S.n_rows)
        rows_s, cols_s = dims_before_op(m, d, op_s)
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        if isinstance(S, SparseSkOp):
            # A @ op_s(S) = (op_s(S)^T @ A^T)^T: the flipped op folds the
            # transpose into the index roles
            flipped = Op.NoTrans if op_s == Op.Trans else Op.Trans
            route, prod = _sparse_left_apply(S, d, m, ro_s, co_s, flipped,
                                             a_mat.T, alpha)
            route_counts[route] += 1
            prod = prod.T
        elif (prod := _right_fused_or_none(
                S, a_mat, (rows_s, cols_s, ro_s, co_s), op_s,
                alpha)) is not None:
            route_counts["right_fused"] += 1
        else:
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


def sketch(S, A: torch.Tensor, *, side="left") -> torch.Tensor:
    """Convenience wrapper: plain S @ A (left) or A @ S (right)."""
    return sketch_general(S, A, side=side)
