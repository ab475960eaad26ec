"""sketch_general: the primary sketching entry point (counterpart of
randblas_tpu/skge.py, dense, sparse-sign and SRHT operators).

    left:  B_new = alpha * op_s(submat(S)) @ op_a(A) + beta * B
    right: B_new = alpha * op_a(A) @ op_s(submat(S)) + beta * B

A and B are 2-D tensors (row-major, shape == math shape); S is a
DenseSkOp, a SparseSkOp or a TrigSkOp. Dense routes, tried in this order
and each counted in ``route_counts``:

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
float32 or bf16 data. An operator with an x64 seed (Philox/Threefry 2x64,
4x64) therefore always takes the staged route: its block is filled in
float64 on the data's device (``dense.fill_dense_submat``: by the kernel
K6 on the card, by a host engine on the CPU) and multiplied there. On CUDA tensors ``use_fused="auto"`` takes an eligible fused route
where ``fused_profitable`` holds for the kernel call it makes (operator
rows, contraction, data columns, dtype: the H100 boundaries of
gate_sweep.py, PERF.md "H100 gates"), else the staged route; on CPU
tensors "auto" takes the staged route, and ``use_fused=True`` takes the
kernels (their plain versions on the CPU) at any shape. A square
distribution transposes to itself, so the identity behind the left-Trans
and right routes fails for it and they leave it to the staged route. The
fused routes are differentiable in A (ops/fused_sketch.py).

Sparse-sign operators (SparseSkOp) take ``_sparse_plan``; a right
sketch is the left sketch of the transposes. Its routes, counted the same
way:

- ``sparse_saso_kernel``: the full wide SASO, and the transposed full tall
  SASO (whose transpose is wide), through K4 (ops/saso_sketch.py), which
  reads the data once. On CUDA tensors ``use_saso_kernel="auto"`` takes it
  where ``saso_sketch_supported`` and ``saso_profitable`` hold and the data
  is float32; ``True`` also runs K4's plain version on the CPU, at any
  supported shape; ``False`` never.
- ``sparse_fixed_nnz``: the same operators by one ``index_add_`` per slot.
- ``sparse_row_gather``: the full tall SASO, and the transposed full wide
  one: each output row gathers k data rows.
- ``sparse_coo``: any other block, or triplets not in the fill's order.

SRHT operators (TrigSkOp) take the route ``srht``: the full operator only,
no submatrix offsets, by ``lmult``/``lmult_t`` (Hadamard stages as
``torch.matmul``, capped on the card by ``ops.hadamard.srht_max_factor``;
no hand-written kernel, as in the JAX package).

Every "auto" gate here is an H100 measurement (``gate_sweep.py``), none a
TPU one; the distributed layer's dense shards keep the JAX package's rule,
which has no size gate.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from . import base, profiling
from .base import MajorAxis, Op, Side, dims_before_op, require
from .dense import DenseDist, DenseSkOp
from .sparse import SparseSkOp
from .trig import TrigSkOp

# Fused-kernel dispatch policy: "auto" takes a fused route (K1 or K2) on
# CUDA tensors where the call qualifies and ``fused_profitable`` holds;
# True forces the fused routes (the kernels' plain versions on the CPU), and
# a forced left sketch that no fused route takes raises; False always takes
# the staged route.
use_fused = "auto"

# K1/K2 against the staged route (K3 fill + torch.matmul) on an NVIDIA H100
# 80GB HBM3 at 700 W: gate_sweep.py G1, G2, G1N, G2N, G1B, G2B, G3, G3N, two
# runs each (PERF.md "H100 gates"). The rule agrees with 356 of the 360
# points; at the other 4 (0.12-0.20 ms calls, 2^29-2^31 operations) the
# kernel was faster by at most 0.08 ms in a run.
# - bf16 data: the staged route's bf16 matmul wins at every point (1.3-20x).
# - At most FUSED_MIN_WORK operations (2 rows m n) both routes are a few
#   launches; the staged route wins or ties.
# - At n <= FUSED_MAX_NARROW_N the staged route wins at every point (K1 up
#   to 16384 rows, K2 up to 65536).
# - Narrower than 8 column tiles the launch plan forms clusters of 1, 2 or
#   4 CTAs and never cuts the contraction (ops/fused_sketch.launch_plan):
#   the kernel wins only with more operator rows than
#   FUSED_NARROW_ROWS[cluster] (each the largest measured losing row count;
#   K1 at n = 256 loses at 8192 rows, 8.36 ms against 6.53, and wins at
#   16384, 8.27 against 12.83).
# - The size ratio of the right route needs no gate: the kernel wins at
#   every ratio from 1/16 to 8 at m = 32768, n = 2048 (1.15-4.3x).
FUSED_MIN_WORK = 1 << 31
FUSED_MAX_NARROW_N = 64
FUSED_NARROW_ROWS = {1: 8192, 2: 2048, 4: 1024}

# Staged-route fill transform. On CUDA tensors the staged route fills a
# lazy Gaussian or Uniform operator block through the fill kernel K3 (the
# plain fill for 2x32 generators). False (default): the staged fill's
# Box-Muller, bit for bit the plain fill (dense.fill_dense_submat); True:
# float32 blocks with the TPU fill kernel's transform (signed-view u01, the
# counterpart of the JAX package's use_pallas_fill). On the CPU each is the
# plain version. Uniform values are bitwise equal either way; Gaussian
# values differ by about one ulp.
use_kernel_fill = False

# SASO kernel (K4) dispatch policy: "auto" takes K4 on CUDA tensors where
# the call qualifies and ``saso_profitable`` holds; True also runs its plain
# version on the CPU; False always takes the fixed-nnz route.
use_saso_kernel = "auto"

# K4 against the fixed-nnz route on an NVIDIA H100 80GB HBM3 at 700 W:
# gate_sweep.py G4, G4N, two runs each (PERF.md "H100 gates"). K4 wins or
# ties at every point (up to 65x at k = 16) but d = 4096 with m = 131072
# and 262144 at n = 1, 4 and 16 (0.47-1.52 ms against 0.38-0.68): its
# one-hot panels cost d m whatever n, the fixed-nnz route k m n. At d m =
# 2^28 and below it wins at every n.
SASO_NARROW_N = 16
SASO_NARROW_MAX_DM = 1 << 28

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
    """op_s(submat(S)) as a dense tensor on ``device``: K3 with the TPU
    fill kernel's transform under ``use_kernel_fill``, else ``S.submat``
    (K3 with the staged fill's transform on the card)."""
    from .ops import fused_sketch as fs
    if (S.materialized is None and use_kernel_fill
            and fs.fill_block_supported(S.dist, dtype, S.seed_state.rng)):
        blk = fs.fill_block(S, rows_s, cols_s, ro_s, co_s, device=device,
                            transform="boxmul_i32")
    else:
        blk = S.submat(rows_s, cols_s, ro_s, co_s, dtype=dtype,
                       device=device)
    return blk.T if op_s == Op.Trans else blk


def _scaled(alpha, prod: torch.Tensor) -> torch.Tensor:
    if isinstance(alpha, (int, float)) and alpha == 1:
        return prod
    return torch.as_tensor(alpha, dtype=prod.dtype) * prod


def fused_profitable(rows: int, contraction: int, n: int, dtype) -> bool:
    """Whether "auto" takes K1 or K2 on the card for a kernel call of an
    operator block of ``rows`` x ``contraction`` on data of n columns
    (the boundaries above)."""
    from .ops.fused_sketch import launch_plan
    if dtype != torch.float32 or n <= FUSED_MAX_NARROW_N:
        return False
    if 2 * rows * contraction * n <= FUSED_MIN_WORK:
        return False
    cluster = launch_plan(rows, contraction, n).cluster
    return rows > FUSED_NARROW_ROWS.get(cluster, 0)


def _fused_gates_ok(S: DenseSkOp, A: torch.Tensor) -> bool:
    from .ops.fused_sketch import SUPPORTED_RNGS
    return (use_fused is not False and S.materialized is None
            and S.seed_state.rng in SUPPORTED_RNGS
            and A.dtype in (torch.float32, torch.bfloat16)
            and (use_fused is True or base.on_card(A)))


def _fused_call_ok(rows: int, contraction: int, data) -> bool:
    """The size gate of one K1/K2 call on ``data`` (contraction, n): forced
    calls pass, "auto" asks ``fused_profitable``."""
    return use_fused is True or fused_profitable(rows, contraction,
                                                 data.shape[1], data.dtype)


def _transposed_op(S: DenseSkOp) -> DenseSkOp:
    """The operator of the transposed distribution with the same seed."""
    d = S.dist
    return DenseSkOp(DenseDist(d.n_cols, d.n_rows, d.family, d.major_axis),
                     S.seed_state, dtype=S.dtype)


def _swapped(blk):
    """The block (rows_s, cols_s, ro_s, co_s) of the transposed operator."""
    rows_s, cols_s, ro_s, co_s = blk
    return cols_s, rows_s, co_s, ro_s


def _fused_kernel(S: DenseSkOp, a_mat, blk):
    """The wrapper of K1 or K2 that takes block(S) @ a_mat for the block
    ``blk`` = (rows_s, cols_s, ro_s, co_s), or None if neither does."""
    from .ops import fused_sketch as fs
    if not _fused_call_ok(blk[0], blk[1], a_mat):
        return None
    for supported, kernel in (
            (fs.fused_sketch_supported, fs.fused_sketch),
            (fs.fused_sketch_colmajor_supported, fs.fused_sketch_colmajor)):
        if supported(S.dist, *blk, Op.NoTrans, a_mat.dtype):
            return kernel
    return None


def _fused_run(kernel, S: DenseSkOp, a_mat, alpha, blk):
    """The call alpha * block(S) @ a_mat through ``kernel``."""
    rows_s, cols_s, ro_s, co_s = blk
    return lambda: kernel(S, a_mat, alpha=float(alpha), rows_s=rows_s,
                          cols_s=cols_s, ro_s=ro_s, co_s=co_s)


def _left_fused_plan(S: DenseSkOp, a_mat, blk, op_s: Op, alpha):
    """(route, run) of alpha * op_s(block(S)) @ a_mat through K1 or K2, or
    None where neither takes it."""
    from .ops.fused_sketch import fused_sketch
    if not _fused_gates_ok(S, a_mat):
        return None
    if op_s == Op.NoTrans:
        kernel = _fused_kernel(S, a_mat, blk)
        if kernel is None:
            return None
        route = ("left_fused" if kernel is fused_sketch
                 else "left_colmajor_fused")
    elif S.n_rows == S.n_cols:
        return None
    else:
        S, blk = _transposed_op(S), _swapped(blk)
        kernel = _fused_kernel(S, a_mat, blk)
        if kernel is None:
            return None
        route = "left_trans_fused"
    return route, _fused_run(kernel, S, a_mat, alpha, blk)


def _right_fused_plan(S: DenseSkOp, a_mat, blk, op_s: Op, alpha):
    """The run of alpha * a_mat @ op_s(block(S)) through K1, or None. The
    left operand of the transposed product is the stored block for op_s =
    Trans, and the transposed distribution's block for op_s = NoTrans."""
    if not _fused_gates_ok(S, a_mat):
        return None
    if op_s == Op.Trans:
        S_l = S
    elif S.n_rows != S.n_cols:
        S_l, blk = _transposed_op(S), _swapped(blk)
    else:
        return None
    from .ops.fused_sketch import fused_sketch, fused_sketch_supported
    if not (fused_sketch_supported(S_l.dist, *blk, Op.NoTrans, a_mat.dtype)
            and _fused_call_ok(blk[0], blk[1], a_mat.T)):
        return None
    run = _fused_run(fused_sketch, S_l, a_mat.T, alpha, blk)
    return lambda: run().T


def _require_full_trig(S: TrigSkOp, rows_s, cols_s, ro_s, co_s):
    require(ro_s == 0 and co_s == 0 and (rows_s, cols_s) == S.shape,
            "TrigSkOp has no submatrix addressing (H mixes all rows); "
            "apply the full operator")


def saso_profitable(d: int, m: int, n: int) -> bool:
    """Whether "auto" takes K4 on the card for a (d, m) wide SASO on n data
    columns (the boundary above)."""
    return n > SASO_NARROW_N or d * m <= SASO_NARROW_MAX_DM


def _saso_kernel_ok(d: int, m: int, k: int, b: torch.Tensor) -> bool:
    """Whether K4 takes a (d, m) wide-SASO product with k slots per column
    on b: its shape gate (the JAX package's: k <= 16, ceil(d / 128) * 128
    <= 4096) and float32 data, anywhere under True, on a CUDA tensor where
    ``saso_profitable`` holds under "auto". The distributed layer's SASO
    shards ask it too."""
    from .ops.saso_sketch import saso_sketch_supported
    if (use_saso_kernel is False or b.dtype != torch.float32
            or not saso_sketch_supported(d, m, k, b.shape[1])):
        return False
    return use_saso_kernel is True or (base.on_card(b) and saso_profitable(
        d, m, b.shape[1]))


def _sparse_plan(S: SparseSkOp, d: int, m: int, ro_s: int, co_s: int,
                 op_s: Op, b_mat: torch.Tensor, alpha):
    """(route, run) of alpha * op_s(submat(S)) @ b_mat for a sparse-sign
    operator; the run fills it on b_mat's device. The route is decided
    before the fill: a lazy operator's fill gives canonical triplets. A
    transposed operator swaps the COO index roles and the offsets."""
    from .ops.coo_apply import (coo_left_apply_auto, fixed_nnz_left_apply,
                                row_gather_apply)
    from .ops.saso_sketch import saso_sketch

    def filled():
        return S.filled(b_mat.device)

    k = S.dist.vec_nnz
    canonical = S.canonical or not S.known_filled
    full = canonical and S.dist.major_axis == MajorAxis.Short \
        and ro_s == 0 and co_s == 0
    wide, tall = S.n_rows < S.n_cols, S.n_rows > S.n_cols
    # the index vector of op_s(S)'s k entries in each data column
    # (``per_col``) or in each output row (``per_row``); the right sketch
    # arrives with op_s = Trans: S^T of a tall SASO is wide with k entries
    # per column, S^T of a wide one has k per output row
    per_col = per_row = None
    if full and op_s == Op.NoTrans and (d, m) == S.shape:
        per_col, per_row = ("rows" if wide else None), (
            "cols" if tall else None)
    elif full and op_s == Op.Trans and (m, d) == S.shape:
        per_col, per_row = ("cols" if tall else None), (
            "rows" if wide else None)
    if per_col:
        def tables():
            s = filled()
            return (getattr(s, per_col).reshape(m, k),
                    s.vals.reshape(m, k))
        if _saso_kernel_ok(d, m, k, b_mat):
            return "sparse_saso_kernel", lambda: saso_sketch(
                *tables(), b_mat, d, alpha)
        return "sparse_fixed_nnz", lambda: fixed_nnz_left_apply(
            *tables(), b_mat, d, alpha)
    if per_row:
        def gather():
            s = filled()
            return row_gather_apply(getattr(s, per_row).reshape(d, k),
                                    s.vals.reshape(d, k), b_mat, alpha)
        return "sparse_row_gather", gather

    def coo():
        s = filled()
        rows, cols, r0, c0 = s.rows, s.cols, ro_s, co_s
        if op_s == Op.Trans:
            rows, cols, r0, c0 = cols, rows, co_s, ro_s
        return coo_left_apply_auto(rows, cols, s.vals.to(b_mat.dtype),
                                   b_mat, d, m, r0, c0, alpha)
    return "sparse_coo", coo


def _left_plan(S, a_mat, d: int, blk, op_s: Op, alpha, dtype, device):
    """(route, run) of a left sketch alpha * op_s(block(S)) @ a_mat: the
    route is decided here, and nothing is launched until ``run()``."""
    rows_s, cols_s, ro_s, co_s = blk
    if isinstance(S, TrigSkOp):
        _require_full_trig(S, *blk)
        return "srht", lambda: _scaled(alpha, (
            S.lmult(a_mat) if op_s == Op.NoTrans
            else S.lmult_t(a_mat)).to(dtype))
    if isinstance(S, SparseSkOp):
        return _sparse_plan(S, d, a_mat.shape[0], ro_s, co_s, op_s, a_mat,
                            alpha)
    fused = _left_fused_plan(S, a_mat, blk, op_s, alpha)
    if fused is not None:
        return fused
    require(use_fused is not True,
            "fused sketch path forced but the call is unsupported "
            "(the fused kernels take lazy Gaussian/Uniform "
            "operators with a 4x32 generator and f32/bf16 data)")
    return "left_staged", lambda: _scaled(alpha, torch.matmul(
        _dense_block(S, *blk, op_s, dtype, device), a_mat))


def _right_plan(S, a_mat, d: int, blk, op_s: Op, alpha, dtype, device):
    """(route, run) of a right sketch alpha * a_mat @ op_s(block(S)), as
    ``_left_plan``."""
    rows_s, cols_s, ro_s, co_s = blk
    if isinstance(S, TrigSkOp):
        _require_full_trig(S, *blk)
        # A @ op_s(S) = (op_s(S)^T @ A^T)^T
        return "srht", lambda: _scaled(alpha, (
            S.lmult_t(a_mat.T) if op_s == Op.NoTrans
            else S.lmult(a_mat.T)).T.to(dtype))
    if isinstance(S, SparseSkOp):
        # A @ op_s(S) = (op_s(S)^T @ A^T)^T: the flipped op folds the
        # transpose into the index roles
        flipped = Op.NoTrans if op_s == Op.Trans else Op.Trans
        route, run = _sparse_plan(S, d, a_mat.shape[1], ro_s, co_s, flipped,
                                  a_mat.T, alpha)
        return route, lambda: run().T
    fused = _right_fused_plan(S, a_mat, blk, op_s, alpha)
    if fused is not None:
        return "right_fused", fused
    return "right_staged", lambda: _scaled(alpha, torch.matmul(
        a_mat, _dense_block(S, *blk, op_s, dtype, device)))


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
      S: sketching operator (DenseSkOp, SparseSkOp or TrigSkOp).
      A: data matrix, shape = its stored (math) shape; op_a transposes.
      side: 'left'  -> B = alpha op_s(submat(S)) op_a(A) + beta B  (d x n)
            'right' -> B = alpha op_a(A) op_s(submat(S)) + beta B  (n x d)
      d: sketch dimension. Defaults to the full-operator size implied by
         op_s(S) (or to out's shape).
      ro_s, co_s: submatrix offsets into S (counter-addressed).
      out: B to accumulate into (a new tensor is returned). Required
         whenever beta != 0.

    Returns B_new on A's device. Recorded as the span ``sketch`` (arg
    ``route``), and inside it ``route``, the route's decision, which ends
    before anything is launched (``profiling.span``).
    """
    with profiling.span("sketch") as call:
        if not isinstance(S, (DenseSkOp, SparseSkOp, TrigSkOp)):
            raise NotImplementedError(
                f"{type(S).__name__}: randblas_tpu_torch sketches with its "
                "own DenseSkOp, SparseSkOp and TrigSkOp (SRHT) operators")
        side = _as_side(side)
        op_s = _as_op(op_s)
        op_a = _as_op(op_a)
        A = torch.as_tensor(A)
        require(A.dim() == 2, "A must be 2-D")
        if out is None:
            require(isinstance(beta, (int, float)) and beta == 0,
                    "beta != 0 requires an `out` tensor to accumulate into")
        a_mat = A if op_a == Op.NoTrans else A.T
        if side == Side.Left:
            m, n = a_mat.shape
            if d is None:
                d = out.shape[0] if out is not None else (
                    S.n_rows if op_s == Op.NoTrans else S.n_cols)
            rows_s, cols_s = dims_before_op(d, m, op_s)
            expected_shape, plan = (d, n), _left_plan
        else:
            n, m = a_mat.shape
            if d is None:
                d = out.shape[1] if out is not None else (
                    S.n_cols if op_s == Op.NoTrans else S.n_rows)
            rows_s, cols_s = dims_before_op(m, d, op_s)
            expected_shape, plan = (n, d), _right_plan
        require(S.n_rows >= rows_s + ro_s, "S row range out of bounds")
        require(S.n_cols >= cols_s + co_s, "S column range out of bounds")
        with profiling.span("route"):
            route, run = plan(S, a_mat, d, (rows_s, cols_s, ro_s, co_s),
                              op_s, alpha, A.dtype, A.device)
        prod = run()
        route_counts[route] += 1
        call.set(route=route)
        if out is not None:
            require(tuple(out.shape) == expected_shape,
                    f"out has shape {tuple(out.shape)}, expected "
                    f"{expected_shape}")
            from .ops.accumulate import accumulate
            return accumulate(prod, beta, out)
        return prod


def sketch(S, A: torch.Tensor, *, side="left") -> torch.Tensor:
    """Convenience wrapper: plain S @ A (left) or A @ S (right)."""
    return sketch_general(S, A, side=side)
