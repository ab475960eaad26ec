"""Fused RNG-in-GEMM sketch (K1) and operator-block fill (K3): wrappers of
the CUDA kernels in ``csrc/fused_sketch.cu`` and their plain PyTorch
versions (counterpart of randblas_tpu/ops/fused_sketch.py).

K1, ``fused_sketch``: B = alpha * S[ro:ro+d, co:co+m] @ A for a lazy
RowMajor-natural Gaussian or Uniform operator, generated panel by panel
inside the kernel; S never exists in device memory. Replaces the Pallas
kernel ``_kernel`` (reached through ``_fused_call``).

K3, ``fill_block``: a (rows, cols) block of S at any offset, generation
only. Replaces the Pallas kernel ``_kernel_fill`` (reached through
``_fill_call`` / ``pallas_fill_block``).

On a CPU tensor each wrapper runs its plain version, because the tensor
lies on the CPU; on a CUDA tensor it launches its kernel or raises. Each
wrapper counts its kernel launches in ``.launches``.

Numerics, as in the JAX package: K1 rounds both operands to bf16 and
accumulates in float32, and its Gaussian values use the signed-view u01 and
the polynomial sincospi; K3 uses the signed-view u01 and sin/cos. Uniform
values are exact float arithmetic and equal the staged fill bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..base import Layout, Op
from ..rng.state import RNGState
from . import _build
from .dense_fill import rowmajor_values

_RNG_CODES = {"philox4x32": 0, "threefry4x32": 1}
SUPPORTED_RNGS = tuple(_RNG_CODES)
_CTR = 4  # counter words of the supported generators
_MAX_GRID_Y_ROWS = 65535 * 128  # K1's row tiles ride grid.y


# float32 0-dim constants stay on the CPU (passed to CUDA kernels as scalars)
_SQRT3 = torch.tensor(math.sqrt(3.0), dtype=torch.float32)


def _seed_words(state: RNGState):
    """Eight uint32 words for the launcher: counter, then key, zero-padded."""
    words = list(state.counter) + list(state.key)
    words += [0] * (8 - len(words))
    return (ctypes.c_uint32 * 8)(*words)


def _ctr_stride(parent_minor: int) -> int:
    """Counter blocks per natural row, from the TRUE parent width."""
    return (parent_minor + (-parent_minor) % _CTR) // _CTR


def _check_rng(state: RNGState) -> None:
    if state.rng not in _RNG_CODES:
        raise ValueError(f"the sketch kernels take {SUPPORTED_RNGS}, "
                         f"not {state.rng!r}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ------------------------------------------------------------------ K1 ---


def fused_sketch_supported(dist, n_rows: int, n_cols: int, ro_s: int,
                           co_s: int, op_s, dtype) -> bool:
    """Static eligibility for K1: a RowMajor-natural Gaussian/Uniform
    operator, NoTrans, float32 or bf16 data, any in-range submatrix."""
    from ..dense import DenseDistName, dist_to_layout
    return (dtype in (torch.float32, torch.bfloat16)
            and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
            and op_s == Op.NoTrans
            and n_rows + ro_s <= dist.n_rows and n_cols + co_s <= dist.n_cols
            and dist_to_layout(dist) == Layout.RowMajor)


def _fused_plan(S, A, rows_s, cols_s, ro_s, co_s):
    """(base state, data, d, ctr_stride, gaussian) of a K1 call.

    The submatrix's first counter folds into the base state. An unaligned
    co_s starts at the previous counter boundary, with co_s % 4 zero rows
    padded on top of A: the extra operator columns multiply zero data."""
    from ..dense import DenseDistName, dist_to_layout, major_axis_length
    _check_rng(S.seed_state)
    rows_s = S.dist.n_rows if rows_s is None else int(rows_s)
    cols_s = S.dist.n_cols if cols_s is None else int(cols_s)
    if dist_to_layout(S.dist) != Layout.RowMajor:
        raise ValueError("the fused kernel takes RowMajor-natural operators")
    if S.dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        raise ValueError("the fused kernel takes Gaussian or Uniform operators")
    if not (0 <= ro_s and rows_s + ro_s <= S.dist.n_rows
            and 0 <= co_s and cols_s + co_s <= S.dist.n_cols):
        raise ValueError("submatrix out of bounds")
    if A.dim() != 2 or A.shape[0] != cols_s:
        raise ValueError(f"A must be ({cols_s}, n), got {tuple(A.shape)}")
    if A.dtype != torch.bfloat16:
        A = A.to(torch.float32)
    ctr_stride = _ctr_stride(major_axis_length(S.dist))
    fbs = co_s % _CTR
    if fbs:
        A = torch.cat([A.new_zeros((fbs, A.shape[1])), A])
    base = S.seed_state.incr(ro_s * ctr_stride + (co_s - fbs) // _CTR)
    gaussian = S.dist.family == DenseDistName.Gaussian
    return base, A.contiguous(), rows_s, ctr_stride, gaussian


def _fused_plain(base: RNGState, A, d, ctr_stride, gaussian, alpha):
    m = A.shape[0]
    nblk = -(-m // _CTR)
    vals = rowmajor_values(base, d, nblk, ctr_stride,
                           "boxmul_fast" if gaussian else "uneg11",
                           A.device)[:, :m]
    if not gaussian:
        vals = vals * _SQRT3
    s_bf = vals.to(torch.bfloat16).to(torch.float32)
    a_bf = A.to(torch.bfloat16).to(torch.float32)
    out = torch.matmul(s_bf, a_bf)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=torch.float32)
    return out.to(torch.bfloat16) if A.dtype == torch.bfloat16 else out


def _fused_launch(base: RNGState, A, d, ctr_stride, gaussian, alpha):
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K1 takes float32 or bf16 data, not {A.dtype}")
    if A.dim() != 2 or not A.is_contiguous():
        raise ValueError("K1 takes a contiguous 2-D row-major A")
    if d > _MAX_GRID_Y_ROWS:
        raise ValueError(f"K1 takes at most {_MAX_GRID_Y_ROWS} operator rows")
    m, n = A.shape
    lib = _build.load()
    with torch.cuda.device(A.device):
        out = torch.empty((d, n), dtype=torch.float32, device=A.device)
        code = lib.rbt_fused_sketch(
            A.data_ptr(), int(A.dtype == torch.bfloat16), out.data_ptr(),
            d, m, n, ctr_stride, _seed_words(base),
            _RNG_CODES[base.rng], int(gaussian), float(alpha), _stream(A))
        fused_sketch.launches += 1
    _build.check(code, "fused_sketch_kernel launch")
    return out.to(torch.bfloat16) if A.dtype == torch.bfloat16 else out


def fused_sketch(S, A: torch.Tensor, alpha: float = 1.0, rows_s=None,
                 cols_s=None, ro_s: int = 0, co_s: int = 0) -> torch.Tensor:
    """B = alpha * submat(S) @ A with the operator block generated inside
    the kernel (K1) on a CUDA tensor, or by the plain version on a CPU one.

    S: a lazy RowMajor-natural DenseSkOp; A: (cols_s, n) float32 or bf16
    (other dtypes are cast to float32). The output is float32, or bf16 for
    bf16 data; rows walk with the parent's counter stride, so the block is
    bit-identical to slicing the full operator."""
    base, A, d, ctr_stride, gaussian = _fused_plan(S, A, rows_s, cols_s,
                                                   ro_s, co_s)
    if A.is_cuda:
        return _fused_launch(base, A, d, ctr_stride, gaussian, alpha)
    if A.device.type != "cpu":
        raise ValueError(f"no fused sketch kernel for {A.device}")
    return _fused_plain(base, A, d, ctr_stride, gaussian, alpha)


fused_sketch.launches = 0


def fused_sketch_reference(S, A: torch.Tensor, alpha: float = 1.0,
                           rows_s=None, cols_s=None, ro_s: int = 0,
                           co_s: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K1 on A's device: the fill with the
    kernel's transform, both operands rounded to bf16, then a float32
    ``torch.matmul`` (which follows ``torch.backends.cuda.matmul.allow_tf32``
    on the card: a reference sets it to False)."""
    base, A, d, ctr_stride, gaussian = _fused_plan(S, A, rows_s, cols_s,
                                                   ro_s, co_s)
    return _fused_plain(base, A, d, ctr_stride, gaussian, alpha)


# ------------------------------------------------------------------ K3 ---


def fill_block_supported(dist, dtype, rng: str) -> bool:
    from ..dense import DenseDistName
    return (dtype == torch.float32
            and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
            and rng in _RNG_CODES)


def _fill_plan(S, rows_s, cols_s, ro_s, co_s):
    """(base, g_rows, g_cols, shift, ctr_stride, gaussian, colmajor): the
    block in the natural orientation, its first counter folded into base;
    an unaligned minor offset starts at the previous counter boundary and
    skips ``shift`` leading values."""
    from ..dense import DenseDistName, dist_to_layout
    _check_rng(S.seed_state)
    if S.dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        raise ValueError("the fill kernel takes Gaussian or Uniform operators")
    if not (0 <= ro_s and rows_s + ro_s <= S.dist.n_rows
            and 0 <= co_s and cols_s + co_s <= S.dist.n_cols):
        raise ValueError("submatrix out of bounds")
    colmajor = dist_to_layout(S.dist) == Layout.ColMajor
    if colmajor:  # the natural matrix is the transposed parent
        g_rows, g_cols, g_ro, g_co = cols_s, rows_s, co_s, ro_s
        parent_minor = S.dist.n_rows
    else:
        g_rows, g_cols, g_ro, g_co = rows_s, cols_s, ro_s, co_s
        parent_minor = S.dist.n_cols
    ctr_stride = _ctr_stride(parent_minor)
    shift = g_co % _CTR
    base = S.seed_state.incr(g_ro * ctr_stride + (g_co - shift) // _CTR)
    gaussian = S.dist.family == DenseDistName.Gaussian
    return base, g_rows, g_cols, shift, ctr_stride, gaussian, colmajor


def _fill_plain(base, rows, cols, shift, ctr_stride, gaussian, device):
    nblk = (shift + cols + _CTR - 1) // _CTR
    vals = rowmajor_values(base, rows, nblk, ctr_stride,
                           "boxmul_i32" if gaussian else "uneg11", device)
    vals = vals[:, shift:shift + cols]
    return vals if gaussian else vals * _SQRT3


def _fill_launch(base, rows, cols, shift, ctr_stride, gaussian, device):
    lib = _build.load()
    with torch.cuda.device(device):
        out = torch.empty((rows, cols), dtype=torch.float32, device=device)
        code = lib.rbt_fill_block(
            out.data_ptr(), rows, cols, shift, ctr_stride, _seed_words(base),
            _RNG_CODES[base.rng], int(gaussian), _stream(out))
        fill_block.launches += 1
    _build.check(code, "fill_block_kernel launch")
    return out


def _orient(blk, colmajor):
    return blk.T if colmajor else blk


def fill_block(S, rows_s: int, cols_s: int, ro_s: int = 0, co_s: int = 0,
               device=None) -> torch.Tensor:
    """The (rows_s, cols_s) float32 block of S at (ro_s, co_s), in math
    orientation, generated by K3 on a CUDA device or by the plain fill on
    the CPU. A ColMajor-natural block comes back as a transposed view."""
    device = torch.device("cpu" if device is None else device)
    base, g_rows, g_cols, shift, ctr_stride, gaussian, colmajor = \
        _fill_plan(S, rows_s, cols_s, ro_s, co_s)
    if device.type == "cuda":
        blk = _fill_launch(base, g_rows, g_cols, shift, ctr_stride, gaussian,
                           device)
    elif device.type == "cpu":
        blk = _fill_plain(base, g_rows, g_cols, shift, ctr_stride, gaussian,
                          device)
    else:
        raise ValueError(f"no fill kernel for {device}")
    return _orient(blk, colmajor)


fill_block.launches = 0


def fill_block_reference(S, rows_s: int, cols_s: int, ro_s: int = 0,
                         co_s: int = 0, device=None) -> torch.Tensor:
    """The plain PyTorch version of K3 on ``device``: the counter-addressed
    fill with K3's transform (signed-view u01, sin/cos)."""
    base, g_rows, g_cols, shift, ctr_stride, gaussian, colmajor = \
        _fill_plan(S, rows_s, cols_s, ro_s, co_s)
    return _orient(_fill_plain(base, g_rows, g_cols, shift, ctr_stride,
                               gaussian, device), colmajor)
