"""Fused RNG-in-GEMM sketches (K1, K2) and operator-block fill (K3):
wrappers of the CUDA kernels in ``csrc/fused_sketch.cu`` and their plain
PyTorch versions (counterpart of randblas_tpu/ops/fused_sketch.py).

K1, ``fused_sketch``: B = alpha * S[ro:ro+d, co:co+m] @ A for a lazy
RowMajor-natural Gaussian or Uniform operator, generated panel by panel
inside the kernel; S never exists in device memory. Replaces the Pallas
kernel ``_kernel`` (reached through ``_fused_call``).

K2, ``fused_sketch_colmajor``: the same product for a ColMajor-natural
operator (wide+Short, tall+Long, square+Long), whose counters walk down the
columns. Replaces the Pallas kernel ``_kernel_T`` (reached through
``_fused_call_T``).

K3, ``fill_block``: a (rows, cols) block of S at any offset, generation
only, contiguous in math orientation. Replaces the Pallas kernel
``_kernel_fill`` (reached through ``_fill_call`` / ``pallas_fill_block``).
Besides the TPU kernel's Gaussian transform it has the staged fill's, so
``dense.fill_dense_submat`` makes every lazy Gaussian or Uniform block of a
4x32 generator on the card through K3, bit for bit the plain fill.

On a CPU tensor each wrapper runs its plain version, because the tensor
lies on the CPU; on a CUDA tensor it launches its kernel or raises. Each
wrapper counts its kernel launches in ``.launches``. K1 and K2 launch with
the plan of ``launch_plan`` (tiles, thread-block cluster, grid, contraction
splits), which asks the card through ``max_active_clusters`` how many
clusters it runs at once; they read A through its strides. A launch is
recorded as the span ``K1.launch`` or ``K2.launch`` (plan, allocations,
the launcher's call) with the plan's ``cluster``, ``splits`` and
``panel_steps``.

K1 and K2 are differentiable in A (one ``torch.autograd.Function``, as the
JAX package's ``jax.custom_vjp``): the sketch is linear in A, so
dA = alpha * block^T @ g, and block(S, r, c, ro, co)^T equals
block(S_t, c, r, co, ro) for the transposed distribution S_t with the same
seed, whose natural layout is the other one. So the backward pass of K1 is
K2 and that of K2 is K1; it regenerates the operator from the seed and
saves nothing else. A square distribution transposes to itself, so its
backward pass fills the block and multiplies by its transpose. First-order
reverse mode only, as in the JAX package.

Numerics, as in the JAX package: K1 and K2 round both operands to bf16 and
accumulate in float32, and their Gaussian values use the signed-view u01
and the polynomial sincospi; K3 uses sin/cos of pi * u with the
signed-view u01 ("boxmul_i32") or the unsigned one ("boxmul", the staged
fill's). Uniform values are exact float arithmetic and equal the staged
fill bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from .. import profiling
from ..base import Layout, Op
from ..rng.state import RNGState
from . import _build, _plan
from .dense_fill import rowmajor_values

# the generators K1, K2 and K3 take (their launchers' codes are
# _build.GEN_CODES)
SUPPORTED_RNGS = ("philox4x32", "threefry4x32")
_CTR = 4  # counter words of the supported generators

# K1's and K2's tiles (the constants TI, TN, TK, PK of csrc/fused_sketch.cu):
# operator rows, output columns and contraction depth per CTA and step of
# A, and the contraction depth of a step of the operator panel, which the
# cluster hands off once per step
TI, TN, TK = 128, 256, 64
PK = 2 * TK
_PORTABLE_CLUSTER = 8   # the largest cluster every sm_90 device launches
_MAX_CLUSTER = 16       # with the non-portable cluster attribute
_MAX_GRID_Y_ROWS = 65535 * TI  # K1's and K2's row tiles ride grid.y
# a CTA's time in clusters of c is about 1 + _GEN_SHARE * 8 / c that of
# one in clusters of 8 with no generation: fitted to K1 at the main shape in
# clusters of 8 and 16 on an H100 80GB HBM3 at 700 W (PERF.md)
_GEN_SHARE = 0.5


class LaunchPlan(NamedTuple):
    """How K1 and K2 cover a (rows, n) output: TI x TN tiles on a grid of
    (grid_x, grid_y, splits) CTAs, in clusters of ``cluster`` CTAs along n
    that share each operator panel of ``pk`` columns, the contraction cut
    into ``splits`` ranges of ``split_steps`` steps of TK (their partial
    sums added in split order after the kernel), each range a whole number
    of panel steps where there are several. ``regen`` is how many times
    every operator element is generated: once per cluster along n."""
    ti: int
    tn: int
    tk: int
    pk: int
    cluster: int
    grid: tuple
    regen: int
    splits: int
    split_steps: int

    @property
    def panel_steps(self) -> int:
        """The panel-ring handoffs a CTA of the first split makes: its
        steps of TK two by two, the last perhaps half used."""
        return -(-self.split_steps * self.tk // self.pk)

    def words(self):
        """The plan as the launcher takes it."""
        return (ctypes.c_int32 * 9)(self.ti, self.tn, self.tk, self.pk,
                                    self.cluster, *self.grid, self.splits,
                                    self.split_steps)


def launch_plan(d: int, m: int, n: int, shift: int = 0,
                max_active=None) -> LaunchPlan:
    """The launch plan of a K1 (shift 0) or K2 call with d output rows, a
    contraction of m and n output columns; the one place where the tiles,
    the cluster, the grid and the splits are chosen.

    The cluster spans the column tiles, up to a power of two: all of them
    where they fit (so S is generated once per row tile), else the portable
    8, or 16 where ``max_active`` (cluster size -> the device's
    ``cudaOccupancyMaxActiveClusters``) says that clusters of 16 run and
    their rounds, each CTA generating half as much, take less time than
    those of 8 (_GEN_SHARE). grid.x is a multiple of the cluster: CTAs past
    n compute zeros and join the cluster's barriers. The contraction splits
    as ``_plan.splits`` says, on panel-step boundaries. Cached, as K4's
    plan: ``max_active`` keys the cache as a sorted tuple."""
    return _launch_plan(d, m, n, shift,
                        tuple(sorted((max_active or {}).items())))


@functools.lru_cache(maxsize=256)
def _launch_plan(d, m, n, shift, max_active) -> LaunchPlan:
    tiles = -(-n // TN)
    row_tiles = -(-(d + shift) // TI)
    steps = max(1, -(-m // TK))
    active = dict(max_active)
    cluster = 1
    while cluster < tiles and cluster < _PORTABLE_CLUSTER:
        cluster *= 2
    options = [cluster]
    if tiles > _PORTABLE_CLUSTER and active.get(_MAX_CLUSTER):
        options.append(_MAX_CLUSTER)

    def layout(c):  # (relative time, cluster, grid.x, splits)
        grid_x = -(-tiles // c) * c
        units = grid_x // c * row_tiles
        splits = _plan.splits(units, active.get(c, 0), steps, d, n)
        rounds = (_plan.waves(units, active[c], splits) if active.get(c)
                  else math.inf)  # unknown, or clusters of c do not run
        work = 1 + _GEN_SHARE * _PORTABLE_CLUSTER / c
        return rounds * work, c, grid_x, splits

    _, cluster, grid_x, splits = min(layout(c) for c in options)
    split_steps = -(-steps // splits)
    if splits > 1:  # every range starts on a panel step
        split_steps = -(-split_steps // (PK // TK)) * (PK // TK)
    splits = -(-steps // split_steps)
    return LaunchPlan(TI, TN, TK, PK, cluster, (grid_x, row_tiles),
                      grid_x // cluster, splits, split_steps)


def max_active_clusters(device) -> dict:
    """Cluster size -> ``cudaOccupancyMaxActiveClusters`` of K1's launch
    shape on a CUDA device (8 and 16), queried once per device."""
    return {c: _plan.occupancy(device, "rbt_fused_max_clusters", c)
            for c in (_PORTABLE_CLUSTER, _MAX_CLUSTER)}


# float32 0-dim constants stay on the CPU (passed to CUDA kernels as scalars)
_SQRT3 = torch.tensor(math.sqrt(3.0), dtype=torch.float32)


def _ctr_stride(parent_minor: int) -> int:
    """Counter blocks per natural row, from the TRUE parent width."""
    return (parent_minor + (-parent_minor) % _CTR) // _CTR


def _check_rng(state: RNGState) -> None:
    if state.rng not in SUPPORTED_RNGS:
        raise ValueError(f"the sketch kernels take {SUPPORTED_RNGS}, "
                         f"not {state.rng!r}")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ------------------------------------------------------------- K1, K2 ---


def _supported(dist, n_rows, n_cols, ro_s, co_s, op_s, dtype, layout):
    from ..dense import DenseDistName, dist_to_layout
    return (dtype in (torch.float32, torch.bfloat16)
            and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
            and op_s == Op.NoTrans
            and n_rows + ro_s <= dist.n_rows and n_cols + co_s <= dist.n_cols
            and dist_to_layout(dist) == layout)


def fused_sketch_supported(dist, n_rows: int, n_cols: int, ro_s: int,
                           co_s: int, op_s, dtype) -> bool:
    """Static eligibility for K1: a RowMajor-natural Gaussian/Uniform
    operator, NoTrans, float32 or bf16 data, any in-range submatrix."""
    return _supported(dist, n_rows, n_cols, ro_s, co_s, op_s, dtype,
                      Layout.RowMajor)


def fused_sketch_colmajor_supported(dist, n_rows: int, n_cols: int,
                                    ro_s: int, co_s: int, op_s,
                                    dtype) -> bool:
    """Static eligibility for K2: the same for a ColMajor-natural
    operator."""
    return _supported(dist, n_rows, n_cols, ro_s, co_s, op_s, dtype,
                      Layout.ColMajor)


def _check_call(S, A, rows_s, cols_s, ro_s, co_s, layout):
    """Check a K1/K2 call; True for a Gaussian operator."""
    from ..dense import DenseDistName, dist_to_layout
    _check_rng(S.seed_state)
    if dist_to_layout(S.dist) != layout:
        raise ValueError(f"this fused kernel takes {layout.name}-natural "
                         "operators")
    if S.dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        raise ValueError("the fused kernel takes Gaussian or Uniform operators")
    if not (0 <= ro_s and rows_s + ro_s <= S.dist.n_rows
            and 0 <= co_s and cols_s + co_s <= S.dist.n_cols):
        raise ValueError("submatrix out of bounds")
    if A.dim() != 2 or A.shape[0] != cols_s:
        raise ValueError(f"A must be ({cols_s}, n), got {tuple(A.shape)}")
    return S.dist.family == DenseDistName.Gaussian


def _fused_plan(S, A, rows_s, cols_s, ro_s, co_s):
    """(base state, data, d, ctr_stride, gaussian) of a K1 call.

    The submatrix's first counter folds into the base state. An unaligned
    co_s starts at the previous counter boundary, with co_s % 4 zero rows
    padded on top of A: the extra operator columns multiply zero data.
    Otherwise A keeps its strides: K1 reads a transposed view in place."""
    gaussian = _check_call(S, A, rows_s, cols_s, ro_s, co_s, Layout.RowMajor)
    ctr_stride = _ctr_stride(S.dist.n_cols)
    fbs = co_s % _CTR
    if fbs:
        A = torch.cat([A.new_zeros((fbs, A.shape[1])), A])
    base = S.seed_state.incr(ro_s * ctr_stride + (co_s - fbs) // _CTR)
    return base, A, rows_s, ctr_stride, gaussian


def _colmajor_plan(S, A, rows_s, cols_s, ro_s, co_s):
    """(base state, data, d, shift, ctr_stride, gaussian) of a K2 call.

    Element (i, c) of the block lives at counter
    base + c * ctr_stride + (shift + i) / 4, lane (shift + i) % 4: the
    column offset and the aligned part of the row offset fold into the
    base state, and shift = ro_s % 4 (the counter stride comes from the
    TRUE parent height)."""
    gaussian = _check_call(S, A, rows_s, cols_s, ro_s, co_s, Layout.ColMajor)
    ctr_stride = _ctr_stride(S.dist.n_rows)
    shift = ro_s % _CTR
    base = S.seed_state.incr(co_s * ctr_stride + (ro_s - shift) // _CTR)
    return base, A, rows_s, shift, ctr_stride, gaussian


def _bf16_product(vals, A, gaussian, alpha):
    """alpha * vals @ A with both operands rounded to bf16 and a float32
    product; bf16 out for bf16 data."""
    if not gaussian:
        vals = vals * _SQRT3
    s_bf = vals.to(torch.bfloat16).to(torch.float32)
    a_bf = A.to(torch.bfloat16).to(torch.float32)
    out = torch.matmul(s_bf, a_bf)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=torch.float32)
    return out.to(torch.bfloat16) if A.dtype == torch.bfloat16 else out


def _transform(gaussian):
    return "boxmul_fast" if gaussian else "uneg11"


def _fused_plain(base: RNGState, A, d, ctr_stride, gaussian, alpha):
    m = A.shape[0]
    vals = rowmajor_values(base, d, -(-m // _CTR), ctr_stride,
                           _transform(gaussian), A.device)[:, :m]
    return _bf16_product(vals, A, gaussian, alpha)


def _colmajor_plain(base: RNGState, A, d, shift, ctr_stride, gaussian,
                    alpha):
    # the natural (transposed) block: row c holds operator column c
    vals = rowmajor_values(base, A.shape[0], -(-(shift + d) // _CTR),
                           ctr_stride, _transform(gaussian), A.device)
    return _bf16_product(vals[:, shift:shift + d].T, A, gaussian, alpha)


def _launch(colmajor, base: RNGState, A, d, shift, ctr_stride, gaussian,
            alpha):
    name = "K2" if colmajor else "K1"
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes float32 or bf16 data, not {A.dtype}")
    if A.dim() != 2:
        raise ValueError(f"{name} takes a 2-D A")
    if d + shift > _MAX_GRID_Y_ROWS:
        raise ValueError(f"{name} takes at most {_MAX_GRID_Y_ROWS} operator "
                         "rows")
    m, n = A.shape
    with profiling.span("K2.launch" if colmajor else "K1.launch") as span:
        lib = _build.load()
        plan = launch_plan(d, m, n, shift, max_active_clusters(A.device))
        span.set(cluster=plan.cluster, splits=plan.splits,
                 panel_steps=plan.panel_steps)
        with torch.cuda.device(A.device):
            out = torch.empty((d, n), dtype=torch.float32, device=A.device)
            ws = (torch.empty((plan.splits, d, n), dtype=torch.float32,
                              device=A.device) if plan.splits > 1 else None)
            head = (A.data_ptr(), int(A.dtype == torch.bfloat16),
                    A.stride(0), A.stride(1),
                    None if ws is None else ws.data_ptr(), out.data_ptr(),
                    d, m, n)
            tail = (ctr_stride, _build.seed_words(base),
                    _build.GEN_CODES[base.rng], int(gaussian), float(alpha),
                    plan.words(), _stream(A))
            if colmajor:
                code = lib.rbt_fused_sketch_T(*head, shift, *tail)
                fused_sketch_colmajor.launches += 1
            else:
                code = lib.rbt_fused_sketch(*head, *tail)
                fused_sketch.launches += 1
        _build.check(code, ("fused_sketch_T_kernel" if colmajor
                            else "fused_sketch_kernel") + " launch")
    return out.to(torch.bfloat16) if A.dtype == torch.bfloat16 else out


def _require_cpu(A):
    if A.device.type != "cpu":
        raise ValueError(f"no fused sketch kernel for {A.device}")


def _k1(S, A, alpha, rows_s, cols_s, ro_s, co_s):
    base, A, d, ctr_stride, gaussian = _fused_plan(S, A, rows_s, cols_s,
                                                   ro_s, co_s)
    if A.is_cuda:
        return _launch(False, base, A, d, 0, ctr_stride, gaussian, alpha)
    _require_cpu(A)
    return _fused_plain(base, A, d, ctr_stride, gaussian, alpha)


def _k2(S, A, alpha, rows_s, cols_s, ro_s, co_s):
    base, A, d, shift, ctr_stride, gaussian = _colmajor_plan(
        S, A, rows_s, cols_s, ro_s, co_s)
    if A.is_cuda:
        return _launch(True, base, A, d, shift, ctr_stride, gaussian, alpha)
    _require_cpu(A)
    return _colmajor_plain(base, A, d, shift, ctr_stride, gaussian, alpha)


def _transposed_cotangent(dist, state, alpha, rows_s, cols_s, ro_s, co_s,
                          g):
    """dA = alpha * block(dist, state)^T @ g through the other kernel on
    the transposed distribution, or, for a square distribution (which
    transposes to itself, so the identity fails), the filled block."""
    from ..dense import DenseDist, DenseSkOp, dist_to_layout, fill_dense_submat
    if dist.n_rows != dist.n_cols:
        dist_t = DenseDist(dist.n_cols, dist.n_rows, dist.family,
                           dist.major_axis)
        run = _k1 if dist_to_layout(dist_t) == Layout.RowMajor else _k2
        return run(DenseSkOp(dist_t, state), g, alpha, cols_s, rows_s, co_s,
                   ro_s)
    blk = fill_dense_submat(dist, state, rows_s, cols_s, ro_s, co_s,
                            device=g.device)
    out = torch.matmul(blk.T, g.to(torch.float32))
    return (out * torch.tensor(alpha, dtype=torch.float32)).to(g.dtype)


class _Sketch(torch.autograd.Function):
    """alpha * block(S) @ A through K1 or K2 (``run``), differentiable in A.
    Saves the distribution, the seed state, alpha and the block's offsets:
    neither A nor the operator."""

    @staticmethod
    def forward(ctx, A, S, run, alpha, rows_s, cols_s, ro_s, co_s):
        ctx.call = (S.dist, S.seed_state, alpha, rows_s, cols_s, ro_s, co_s)
        ctx.a_dtype = A.dtype
        return run(S, A, alpha, rows_s, cols_s, ro_s, co_s)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dA = _transposed_cotangent(*ctx.call, g.to(ctx.a_dtype))
        return (dA,) + (None,) * 7


def _args(S, A, rows_s, cols_s):
    """A as the kernels take it, and the block's dimensions."""
    rows_s = S.dist.n_rows if rows_s is None else int(rows_s)
    cols_s = S.dist.n_cols if cols_s is None else int(cols_s)
    if A.dtype != torch.bfloat16:  # bf16 streams through uncast
        A = A.to(torch.float32)
    return A, rows_s, cols_s


def _apply(run, S, A, alpha, rows_s, cols_s, ro_s, co_s):
    A, rows_s, cols_s = _args(S, A, rows_s, cols_s)
    return _Sketch.apply(A, S, run, float(alpha), rows_s, cols_s, int(ro_s),
                         int(co_s))


def fused_sketch(S, A: torch.Tensor, alpha: float = 1.0, rows_s=None,
                 cols_s=None, ro_s: int = 0, co_s: int = 0) -> torch.Tensor:
    """B = alpha * submat(S) @ A with the operator block generated inside
    the kernel (K1) on a CUDA tensor, or by the plain version on a CPU one.

    S: a lazy RowMajor-natural DenseSkOp; A: (cols_s, n) float32 or bf16
    (other dtypes are cast to float32). The output is float32, or bf16 for
    bf16 data; rows walk with the parent's counter stride, so the block is
    bit-identical to slicing the full operator. Differentiable in A: the
    backward pass runs K2 (see the module docstring)."""
    return _apply(_k1, S, A, alpha, rows_s, cols_s, ro_s, co_s)


fused_sketch.launches = 0


def fused_sketch_colmajor(S, A: torch.Tensor, alpha: float = 1.0,
                          rows_s=None, cols_s=None, ro_s: int = 0,
                          co_s: int = 0) -> torch.Tensor:
    """B = alpha * submat(S) @ A for a lazy ColMajor-natural DenseSkOp,
    the block generated inside the kernel (K2) on a CUDA tensor, or by the
    plain version on a CPU one. Element (i, c) of S lives at counter
    c * ceil(n_rows / 4) + i / 4, lane i % 4. Data, output and gradient as
    for ``fused_sketch``; the backward pass runs K1."""
    return _apply(_k2, S, A, alpha, rows_s, cols_s, ro_s, co_s)


fused_sketch_colmajor.launches = 0


def _reference(plan, plain, S, A, alpha, rows_s, cols_s, ro_s, co_s):
    A, rows_s, cols_s = _args(S, A, rows_s, cols_s)
    return plain(*plan(S, A, rows_s, cols_s, ro_s, co_s), float(alpha))


def fused_sketch_reference(S, A: torch.Tensor, alpha: float = 1.0,
                           rows_s=None, cols_s=None, ro_s: int = 0,
                           co_s: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K1 on A's device: the fill with the
    kernel's transform, both operands rounded to bf16, then a float32
    ``torch.matmul`` (which follows ``torch.backends.cuda.matmul.allow_tf32``
    on the card: a reference sets it to False). Not differentiable."""
    return _reference(_fused_plan, _fused_plain, S, A, alpha, rows_s, cols_s,
                      ro_s, co_s)


def fused_sketch_colmajor_reference(S, A: torch.Tensor, alpha: float = 1.0,
                                    rows_s=None, cols_s=None, ro_s: int = 0,
                                    co_s: int = 0) -> torch.Tensor:
    """The plain PyTorch version of K2 on A's device: the natural
    (transposed) block from ``rowmajor_values`` with the kernel's
    transform, sliced and transposed, then the product as for
    ``fused_sketch_reference``."""
    return _reference(_colmajor_plan, _colmajor_plain, S, A, alpha, rows_s,
                      cols_s, ro_s, co_s)


# ------------------------------------------------------------------ K3 ---

# K3's Gaussian transforms (the launcher's codes 0 and 1): the TPU fill
# kernel's signed-view u01 and the staged fill's unsigned u01, both with
# sin/cos (rng/transforms.py)
FILL_TRANSFORMS = ("boxmul_i32", "boxmul")


def fill_block_supported(dist, dtype, rng: str) -> bool:
    """Whether K3 makes a ``dtype`` block of ``dist`` seeded with ``rng``:
    float32 values of a Gaussian or Uniform operator of a 4x32 generator."""
    from ..dense import DenseDistName
    return (dtype == torch.float32
            and dist.family in (DenseDistName.Gaussian, DenseDistName.Uniform)
            and rng in SUPPORTED_RNGS)


class _FillPlan(NamedTuple):
    """A block in the natural orientation: ``rows`` x ``cols`` values whose
    row r, counter block b lives at ``state`` + ``offset`` + r *
    ``ctr_stride`` + b, its first ``shift`` values skipped (an unaligned
    minor offset starts at the previous counter boundary). ``colmajor``:
    the natural block is the transposed math block."""
    state: RNGState
    offset: int
    rows: int
    cols: int
    shift: int
    ctr_stride: int
    gaussian: bool
    colmajor: bool


def _fill_plan(dist, state, rows_s, cols_s, ro_s, co_s,
               transform) -> _FillPlan:
    from ..dense import DenseDistName, dist_to_layout
    _check_rng(state)
    if transform not in FILL_TRANSFORMS:
        raise ValueError(f"K3's transforms are {FILL_TRANSFORMS}, not "
                         f"{transform!r}")
    if dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        raise ValueError("the fill kernel takes Gaussian or Uniform operators")
    if not (0 <= ro_s and rows_s + ro_s <= dist.n_rows
            and 0 <= co_s and cols_s + co_s <= dist.n_cols):
        raise ValueError("submatrix out of bounds")
    colmajor = dist_to_layout(dist) == Layout.ColMajor
    if colmajor:  # the natural matrix is the transposed parent
        g_rows, g_cols, g_ro, g_co = cols_s, rows_s, co_s, ro_s
        parent_minor = dist.n_rows
    else:
        g_rows, g_cols, g_ro, g_co = rows_s, cols_s, ro_s, co_s
        parent_minor = dist.n_cols
    ctr_stride = _ctr_stride(parent_minor)
    shift = g_co % _CTR
    offset = g_ro * ctr_stride + (g_co - shift) // _CTR
    if offset >= 2 ** 64:  # RNGState.incr's limit
        raise ValueError("counter increments must lie in [0, 2**64)")
    return _FillPlan(state, offset, g_rows, g_cols, shift, ctr_stride,
                     dist.family == DenseDistName.Gaussian, colmajor)


def _fill_plain(p: _FillPlan, transform, scale, device):
    nblk = (p.shift + p.cols + _CTR - 1) // _CTR
    vals = rowmajor_values(p.state.incr(p.offset), p.rows, nblk,
                           p.ctr_stride, transform if p.gaussian else "uneg11",
                           device)
    vals = vals[:, p.shift:p.shift + p.cols]
    if scale and not p.gaussian:
        vals = vals * _SQRT3
    return (vals.T if p.colmajor else vals).contiguous()


def _fill_launch(p: _FillPlan, transform, scale, device):
    lib = _build.load()
    shape = (p.cols, p.rows) if p.colmajor else (p.rows, p.cols)
    with torch.cuda.device(device):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        code = lib.rbt_fill_block(
            out.data_ptr(), p.rows, p.cols, p.shift, p.ctr_stride, p.offset,
            _build.seed_words(p.state), _build.GEN_CODES[p.state.rng],
            int(p.gaussian), FILL_TRANSFORMS.index(transform),
            int(p.colmajor), int(scale), _stream(out))
        fill_block.launches += 1
    _build.check(code, "fill_block_kernel launch")
    return out


def _fill(dist, state, rows_s, cols_s, ro_s, co_s, device, transform, scale):
    """``fill_block`` for the operator of ``dist`` seeded at ``state``: the
    entry of ``dense.fill_dense_submat``'s route. ``scale``: multiply
    Uniform values by sqrt(3) in float32; without it the caller scales in
    its own dtype."""
    from ..dense import default_device
    device = default_device(device)
    p = _fill_plan(dist, state, rows_s, cols_s, ro_s, co_s, transform)
    if device.type == "cuda":
        return _fill_launch(p, transform, scale, device)
    if device.type == "cpu":
        return _fill_plain(p, transform, scale, device)
    raise ValueError(f"no fill kernel for {device}")


def fill_block(S, rows_s: int, cols_s: int, ro_s: int = 0, co_s: int = 0,
               device=None, *, transform: str = "boxmul_i32") -> torch.Tensor:
    """The (rows_s, cols_s) float32 block of the lazy operator S at (ro_s,
    co_s), contiguous in math orientation, generated by K3 on a CUDA device
    (the default) or by its plain version on the CPU (``device="cpu"``).
    K3 writes a RowMajor-natural block as it is generated and a
    ColMajor-natural one through a transposing tile.

    ``transform`` is the Gaussian transform: "boxmul_i32", the TPU fill
    kernel's (signed-view u01), or "boxmul", the staged fill's, whose values
    are ``fill_dense_submat``'s bit for bit. Uniform values are scaled by
    sqrt(3) in float32."""
    return _fill(S.dist, S.seed_state, rows_s, cols_s, ro_s, co_s, device,
                 transform, scale=True)


fill_block.launches = 0


def fill_block_reference(S, rows_s: int, cols_s: int, ro_s: int = 0,
                         co_s: int = 0, device=None, *,
                         transform: str = "boxmul_i32") -> torch.Tensor:
    """The plain PyTorch version of K3 on ``device`` (the card by default):
    ``rowmajor_values`` with the same transform, sliced, scaled and
    transposed as ``fill_block`` does."""
    from ..dense import default_device
    p = _fill_plan(S.dist, S.seed_state, rows_s, cols_s, ro_s, co_s,
                   transform)
    return _fill_plain(p, transform, True, default_device(device))
