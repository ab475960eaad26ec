"""Dense sketching operators: distributions, operator objects, fill engine
(counterpart of randblas_tpu/dense.py).

The invariants carried over from the reference:

1. Counter addressing: any submatrix of an implicit operator is generated
   directly from (seed, offsets), bit-identical to slicing the full matrix.
2. ``next_state`` is a function of the distribution only, computed by
   counter arithmetic.
3. Fill order (MajorAxis -> natural layout) decides which entries receive
   which stream values.

Operators are lazy: ``materialize``/``submat`` fill on request, on the
device asked for (the card unless ``device="cpu"`` is given; there through
the fill kernel K3 where it takes the block), and the fused sketch kernels
never store the operator. An operator seeded with a 64-bit-counter
generator (an x64 seed) has native float64 values, made on a CUDA device by
the kernel K6 (ops/x64_fill.py) and on the CPU by the native C++ host
engine or its numpy copy.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from .base import Layout, MajorAxis, require
from .ops.dense_fill import fill_colmajor, fill_next_state, fill_rowmajor
from .ops import fused_sketch, x64_fill
from .rng.state import RNGState


class DenseDistName(enum.Enum):
    """Scalar distribution families."""
    Gaussian = "G"   # mean 0, variance 1
    Uniform = "U"    # uniform on [-sqrt(3), sqrt(3)] (variance 1)
    BlackBox = "B"   # user-provided tensor


TRANSFORM = {DenseDistName.Gaussian: "boxmul",
             DenseDistName.Uniform: "uneg11"}

# Host engine of the x64 (float64-stream) fill of a block on the CPU (on a
# CUDA device K6 makes it, whatever this says): "auto" takes the native
# OpenMP C++ engine (native.py) when it is built, bitwise the numpy engine
# for Uniform values and within 2 ulp for Gaussian ones (libm's sin, cos
# and log against numpy's); False always takes the numpy engine
# (rng/x64.py).
use_native_x64 = "auto"

# how many x64 blocks each engine filled: keys "card" (K6), "native" and
# "numpy"
x64_engine_counts = collections.Counter()


@dataclasses.dataclass(frozen=True)
class DenseDist:
    """A distribution over dense sketching operators."""
    n_rows: int
    n_cols: int
    family: DenseDistName = DenseDistName.Gaussian
    major_axis: MajorAxis = None  # type: ignore[assignment]

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "DenseDist dimensions must be positive")
        if self.major_axis is None:
            ma = (MajorAxis.Undefined
                  if self.family == DenseDistName.BlackBox
                  else MajorAxis.Long)
            object.__setattr__(self, "major_axis", ma)
        if self.family == DenseDistName.BlackBox:
            require(self.major_axis == MajorAxis.Undefined,
                    "BlackBox requires MajorAxis.Undefined")
        else:
            require(self.major_axis != MajorAxis.Undefined,
                    "random families require a defined MajorAxis")


def dist_to_layout(d: DenseDist) -> Layout:
    """Natural fill order of the distribution."""
    require(d.major_axis != MajorAxis.Undefined,
            "dist_to_layout needs a defined major axis")
    is_wide = d.n_rows < d.n_cols
    fa_long = d.major_axis == MajorAxis.Long
    if is_wide:
        return Layout.RowMajor if fa_long else Layout.ColMajor
    return Layout.ColMajor if fa_long else Layout.RowMajor


def major_axis_length(d: DenseDist) -> int:
    require(d.major_axis != MajorAxis.Undefined,
            "major_axis_length needs a defined major axis")
    return (max(d.n_rows, d.n_cols) if d.major_axis == MajorAxis.Long
            else min(d.n_rows, d.n_cols))


def isometry_scale_factor(d) -> float:
    """The scale c with E[(c S)^T (c S)] = I for a sample S of ``d``: a
    DenseDist, a SparseDist or a TrigDist."""
    from .sparse import SparseDist   # sparse and trig import this module
    from .trig import TrigDist, trig_isometry_scale
    if isinstance(d, TrigDist):
        return trig_isometry_scale(d)
    if isinstance(d, SparseDist):
        if d.major_axis == MajorAxis.Short:
            return d.vec_nnz ** -0.5
        minor = min(d.n_rows, d.n_cols)
        major = max(d.n_rows, d.n_cols)
        return math.sqrt(major / (d.vec_nnz * minor))
    require(d.family != DenseDistName.BlackBox,
            "no isometry scale for BlackBox")
    return min(d.n_rows, d.n_cols) ** -0.5


def default_device(device=None) -> torch.device:
    """``device``, or the card when none is given: the fills run on the card
    unless the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "randblas_tpu_torch fills on the CUDA device unless asked "
            "otherwise, and none is available: pass device='cpu'")
    return torch.device("cuda")


def compute_next_state(dist: DenseDist, state: RNGState) -> RNGState:
    """Advance past a full sample of ``dist`` by counter arithmetic alone."""
    if dist.major_axis == MajorAxis.Undefined:
        return state
    ctr_size = state.block_width
    major_len = major_axis_length(dist)
    minor_len = dist.n_rows + (dist.n_cols - major_len)
    pad = (-major_len) % ctr_size
    return state.incr((major_len + pad) // ctr_size * minor_len)


def _kernel_fill_route(dist: DenseDist, rng: str, device) -> bool:
    """Whether ``fill_dense_submat`` makes the block by the fill kernel K3:
    on a CUDA device, for a Gaussian or Uniform distribution seeded with a
    4x32 generator (Philox4x32-10, Threefry4x32-20). K3 makes the block's
    float32 values, whatever dtype they are cast to, with the staged fill's
    Box-Muller, so they are the plain fill's bit for bit. K3 implements no
    2x32 generator: those keep the plain fill, as does every block on the
    CPU."""
    return (torch.device(device).type == "cuda"
            and fused_sketch.fill_block_supported(dist, torch.float32,
                                                  rng))


def _checked_device(dist: DenseDist, n_rows: int, n_cols: int, ro_s: int,
                    co_s: int, device) -> torch.device:
    require(dist.family != DenseDistName.BlackBox,
            "fill_dense cannot be called with the BlackBox family")
    require(0 <= ro_s and dist.n_rows >= n_rows + ro_s,
            "row range out of bounds")
    require(0 <= co_s and dist.n_cols >= n_cols + co_s,
            "column range out of bounds")
    return default_device(device)


def _plain_values(dist: DenseDist, state: RNGState, n_rows: int,
                  n_cols: int, ro_s: int, co_s: int, device):
    """The block's float32 values by the plain fill, unscaled."""
    ma_len = major_axis_length(dist)
    transform = TRANSFORM[dist.family]
    if dist_to_layout(dist) == Layout.ColMajor:
        # generate the transpose in row-major order and flip it
        return fill_colmajor(ma_len, n_cols, n_rows, ro_s + co_s * ma_len,
                             state, transform, device)
    return fill_rowmajor(ma_len, n_rows, n_cols, ro_s * ma_len + co_s, state,
                         transform, device)


def _rowmajor64(state: RNGState, transform: str, n_cols_parent: int,
                n_rows: int, n_cols: int, ptr: int) -> np.ndarray:
    """A row-major float64 block of an x64 stream by the host engine that
    ``use_native_x64`` picks, counted in ``x64_engine_counts``."""
    from . import native
    from .rng import x64
    if use_native_x64 is not False and native.available():
        x64_engine_counts["native"] += 1
        return native.fill_rowmajor64(
            n_cols_parent, n_rows, n_cols, ptr,
            x64.limbs_to_words(np.asarray(state.counter)),
            x64.limbs_to_words(np.asarray(state.key)),
            transform == "boxmul", state.rng)
    x64_engine_counts["numpy"] += 1
    return x64.fill_rowmajor64(n_cols_parent, n_rows, n_cols, ptr, state,
                               transform)


def _x64_values(dist: DenseDist, state: RNGState, n_rows: int, n_cols: int,
                ro_s: int, co_s: int, dtype, device) -> torch.Tensor:
    """The block of an x64 seed: native float64 values, Uniform scaled by
    sqrt(3) in float64, then cast to ``dtype`` on ``device``. On a CUDA
    device K6 makes them there (``x64_fill``; a failed build or launch
    raises, the block is never made on the host instead); elsewhere the
    host engine that ``use_native_x64`` picks does (a ColMajor-natural
    block as the block of the transposed parent, flipped, the reference's
    omatcopy fallback, dense_skops.hh:523-530), and the block is moved to
    ``device``."""
    if device.type == "cuda":
        vals = x64_fill._fill64(dist, state, n_rows, n_cols, ro_s, co_s,
                                device)
        x64_engine_counts["card"] += 1
        return vals.to(dtype)
    ma_len = major_axis_length(dist)
    transform = TRANSFORM[dist.family]
    if dist_to_layout(dist) == Layout.ColMajor:
        vals = _rowmajor64(state, transform, ma_len, n_cols, n_rows,
                           ro_s + co_s * ma_len).T
    else:
        vals = _rowmajor64(state, transform, ma_len, n_rows, n_cols,
                           ro_s * ma_len + co_s)
    if dist.family == DenseDistName.Uniform:
        vals = vals * np.float64(math.sqrt(3.0))
    return torch.from_numpy(np.ascontiguousarray(vals)).to(
        device=device, dtype=dtype)


def _cast_and_scale(vals: torch.Tensor, dist: DenseDist, dtype):
    vals = vals.to(dtype).contiguous()
    if dist.family == DenseDistName.Uniform:
        vals = vals * torch.tensor(math.sqrt(3.0), dtype=dtype)
    return vals


def fill_dense_submat(dist: DenseDist, state: RNGState, n_rows: int,
                      n_cols: int, ro_s: int = 0, co_s: int = 0,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """The (ro_s:ro_s+n_rows, co_s:co_s+n_cols) block of the implicit sample
    of ``dist`` seeded at ``state``, as a contiguous (n_rows, n_cols)
    tensor on ``device`` (the card by default). Values are made in float32,
    cast to ``dtype``; Uniform then scales by sqrt(3) in ``dtype``.

    On a CUDA device a Gaussian or Uniform block of a 4x32 generator is
    made in one pass by the fill kernel K3, in math orientation
    (``_kernel_fill_route``), bit for bit the plain fill; any other block
    takes the plain fill, ``fill_dense_submat_reference``. A block of an
    x64 seed is made in float64 (``_x64_values``): by the kernel K6 on a
    CUDA device, by a host engine on the CPU."""
    device = _checked_device(dist, n_rows, n_cols, ro_s, co_s, device)
    if state.is_x64:
        return _x64_values(dist, state, n_rows, n_cols, ro_s, co_s, dtype,
                           device)
    if _kernel_fill_route(dist, state.rng, device):
        vals = fused_sketch._fill(dist, state, n_rows, n_cols, ro_s, co_s,
                                  device, "boxmul", scale=False)
    else:
        vals = _plain_values(dist, state, n_rows, n_cols, ro_s, co_s, device)
    return _cast_and_scale(vals, dist, dtype)


def fill_dense_submat_reference(dist: DenseDist, state: RNGState,
                                n_rows: int, n_cols: int, ro_s: int = 0,
                                co_s: int = 0, dtype=torch.float32,
                                device=None) -> torch.Tensor:
    """``fill_dense_submat`` by the plain fill (batched generator calls on
    word tensors, ops/dense_fill.py) on any device: the route's plain
    version. An x64 seed's block is K6's plain version
    (``x64_fill.fill_block64_reference``) on ``device``, cast to
    ``dtype``."""
    device = _checked_device(dist, n_rows, n_cols, ro_s, co_s, device)
    if state.is_x64:
        return x64_fill._plain64(
            x64_fill._plan64(dist, state, n_rows, n_cols, ro_s, co_s),
            device).to(dtype)
    return _cast_and_scale(
        _plain_values(dist, state, n_rows, n_cols, ro_s, co_s, device), dist,
        dtype)


def fill_dense(dist: DenseDist, state: RNGState, dtype=torch.float32,
               device=None):
    """Full sample of ``dist`` on ``device`` (the card by default): returns
    (tensor, next_state), where next_state reflects the counters actually
    consumed."""
    arr = fill_dense_submat(dist, state, dist.n_rows, dist.n_cols, 0, 0,
                            dtype, device)
    ma_len = major_axis_length(dist)
    if dist_to_layout(dist) == Layout.ColMajor:
        n_rows_, n_cols_ = dist.n_cols, dist.n_rows
    else:
        n_rows_, n_cols_ = dist.n_rows, dist.n_cols
    return arr, fill_next_state(ma_len, n_rows_, n_cols_, 0, state)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseSkOp:
    """A sample from a DenseDist, lazy unless ``materialized`` is given.

    ``seed_state`` may be an int key. ``next_state`` defaults to the state
    after a full sample. ``dtype`` defaults to float64 for an x64 seed
    (the reference deduces the float width from the counter word size,
    random_gen.hh:121-173) and to float32 otherwise. ``materialize()`` returns a fresh fill each call;
    build ``DenseSkOp(dist, state, materialized=S.materialize())`` to hold
    one (such an operator no longer takes the fused route).
    """
    dist: DenseDist
    seed_state: RNGState
    _: dataclasses.KW_ONLY
    next_state: Optional[RNGState] = None
    materialized: Optional[torch.Tensor] = None
    dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if isinstance(self.seed_state, int):
            object.__setattr__(self, "seed_state",
                               RNGState.from_key(self.seed_state))
        if self.dtype is None:
            object.__setattr__(self, "dtype", torch.float64
                               if self.seed_state.is_x64 else torch.float32)
        if self.next_state is None:
            object.__setattr__(self, "next_state",
                               compute_next_state(self.dist, self.seed_state))
        if self.dist.family == DenseDistName.BlackBox:
            require(self.materialized is not None,
                    "BlackBox operators need an explicit tensor")
        if self.materialized is not None:
            mat = torch.as_tensor(self.materialized).to(self.dtype)
            require(tuple(mat.shape) == (self.dist.n_rows, self.dist.n_cols),
                    "materialized tensor must match the distribution shape")
            object.__setattr__(self, "materialized", mat)

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    def materialize(self, device=None) -> torch.Tensor:
        """Dense (n_rows, n_cols) tensor of this operator, on ``device``: by
        default the card for a lazy operator, the held tensor's device for
        a materialized one."""
        return self.submat(self.n_rows, self.n_cols, 0, 0, device=device)

    def submat(self, n_rows: int, n_cols: int, ro_s: int, co_s: int,
               dtype=None, device=None) -> torch.Tensor:
        """Just a block, with the same values as slicing materialize(), on
        ``device`` as for ``materialize``.

        ``dtype`` overrides the operator's dtype. The result always equals
        the block filled at the operator's dtype and cast: Uniform scales by
        sqrt(3) in the fill dtype, so a narrower request fills at the
        operator's dtype first."""
        dtype = self.dtype if dtype is None else dtype
        require(0 <= ro_s and self.n_rows >= n_rows + ro_s,
                "row range out of bounds")
        require(0 <= co_s and self.n_cols >= n_cols + co_s,
                "column range out of bounds")
        if self.materialized is not None:
            blk = self.materialized[ro_s:ro_s + n_rows, co_s:co_s + n_cols]
            return blk.to(dtype=dtype, device=device)
        fill_dtype = dtype
        if dtype != self.dtype and self.dist.family == DenseDistName.Uniform:
            fill_dtype = self.dtype
        vals = fill_dense_submat(self.dist, self.seed_state, n_rows, n_cols,
                                 ro_s, co_s, fill_dtype, device)
        return vals.to(dtype)

    def __repr__(self):
        return (f"DenseSkOp({self.dist.n_rows}x{self.dist.n_cols}, "
                f"{self.dist.family.name}, major={self.dist.major_axis.name},"
                f" dtype={self.dtype}, "
                f"{'materialized' if self.materialized is not None else 'lazy'})")
