"""SASO sketch, K4: B = alpha * S @ A for a wide sparse-sign operator with
exactly k signed entries per data column (counterpart of
randblas_tpu/ops/saso_sketch.py).

The wrapper builds the (k, m) index and sign tables from the filled
operator's (m, k) structure, as the JAX package does, and on a CUDA tensor
launches ``saso_sketch_kernel`` (``csrc/saso_sketch.cu``); on a CPU tensor it
runs the plain version. Both round A to bf16 (the JAX package pre-casts A)
and sum in float32, so they differ only in the order of the sums. Launches
are counted in ``saso_sketch.launches`` and recorded as the span
``K4.launch`` (plan, allocations, the launcher's call) with the plan's
``splits``.

The kernel contracts bf16 one-hot panels of S with A on the tensor cores,
one TI x TN output tile per CTA, with the contraction split on grid.z by
``launch_plan``; no output has to fit one block's shared memory, so
``saso_sketch_supported`` is the JAX package's gate: 1 <= k <= 16 and
d_pad = ceil(d / 128) * 128 <= 4096. A is read through its strides: a
layout TMA cannot take is loaded element by element inside the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import profiling
from ..base import require
from . import _build

MAX_K = 16
_LO = 128          # the JAX gate's row block: d_pad = ceil(d / 128) * 128
MAX_D_PAD = 4096
# the kernel's tiles (the constants TI, TN, TK of csrc/saso_sketch.cu):
# output rows, output columns and contraction depth per CTA and step
TI, TN, TK = 256, 128, 64
_SPLIT_BELOW_WAVES = 8  # cut the contraction of grids of fewer rounds
_MIN_SPLIT_STEPS = 16   # steps of a split, to amortise filling the ring
_MAX_WORKSPACE = 1 << 28  # bytes of partial sums


def saso_sketch_supported(d: int, m: int, k: int, n: int) -> bool:
    """Shape gate of K4, the JAX package's: 1 <= k <= 16, d_pad =
    ceil(d / 128) * 128 <= 4096, m, n >= 1 (d = 0 gives an empty
    output)."""
    d_pad = -(-d // _LO) * _LO
    return 1 <= k <= MAX_K and d_pad <= MAX_D_PAD and m >= 1 and n >= 1


class LaunchPlan(NamedTuple):
    """How K4 covers a (d, n) output: TI x TN tiles, ``row_tiles`` x
    ``col_tiles`` of them on grid.x (the row tiles of one column tile
    adjacent, so that they read each tile of A together), the contraction
    cut into ``splits`` ranges of ``split_steps`` steps of TK on grid.z
    (their partial sums added in split order after the kernel)."""
    ti: int
    tn: int
    tk: int
    row_tiles: int
    col_tiles: int
    grid: tuple
    splits: int
    split_steps: int

    def words(self):
        """The plan as the launcher takes it."""
        return (ctypes.c_int32 * 7)(self.ti, self.tn, self.tk,
                                    self.row_tiles, self.col_tiles,
                                    self.splits, self.split_steps)


def _splits(tiles: int, active: int, steps: int, d: int, n: int) -> int:
    """How many ranges to cut the contraction into: a grid of a few rounds
    of CTAs leaves part of the card idle in the last one (64 tiles on 132
    SMs fill half of it), so it takes the count that fills the rounds best,
    each range of at least _MIN_SPLIT_STEPS steps, with at most
    _MAX_WORKSPACE bytes of partial sums."""
    if not active or tiles >= _SPLIT_BELOW_WAVES * active:
        return 1
    most = min(steps // _MIN_SPLIT_STEPS, _MAX_WORKSPACE // max(1, 4 * d * n))
    return min(range(1, max(1, most) + 1),
               key=lambda s: (-(-tiles * s // active) / s, s))


@functools.lru_cache(maxsize=256)
def launch_plan(d: int, m: int, n: int, max_active=None) -> LaunchPlan:
    """The launch plan of a K4 call with d output rows, a contraction of m
    and n output columns: the one place where the tiles, the grid and the
    splits are chosen. ``max_active`` is how many CTAs the card runs at
    once (``max_active_ctas``; None: unknown, no splits). Cached: a
    wrapper call plans once per shape."""
    row_tiles, col_tiles = -(-d // TI), -(-n // TN)
    steps = max(1, -(-m // TK))
    tiles = row_tiles * col_tiles
    splits = _splits(tiles, max_active or 0, steps, d, n)
    split_steps = -(-steps // splits)
    splits = -(-steps // split_steps)
    return LaunchPlan(TI, TN, TK, row_tiles, col_tiles, (tiles, 1, splits),
                      splits, split_steps)


_max_active_cache = {}


def max_active_ctas(device) -> int:
    """``cudaOccupancyMaxActiveClusters`` of K4's launch shape (clusters of
    one CTA) on a CUDA device, queried once per device: how many CTAs run
    at once."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _max_active_cache:
        lib = _build.load()
        with torch.cuda.device(index):
            out = ctypes.c_int(0)
            code = lib.rbt_saso_max_ctas(ctypes.byref(out))
        _max_active_cache[index] = out.value if code == 0 else 0
    return _max_active_cache[index]


def saso_sketch_reference(idxs_major, vals, a: torch.Tensor, d: int,
                          alpha=1.0) -> torch.Tensor:
    """The plain PyTorch version of K4 on a's device: A rounded to bf16,
    every (data row, slot) term sign * A[c] added into output row
    idx[c, slot] (padding index -1 adds nothing), float32 sums, one slot
    after another."""
    a_bf = a.to(torch.bfloat16).to(torch.float32)
    idx = idxs_major.to(torch.int32).T   # (k, m): one slot per row
    sgn = vals.to(torch.float32).T
    out = torch.zeros((d, a.shape[1]), dtype=torch.float32, device=a.device)
    for idx_s, sgn_s in zip(idx, sgn):   # one slot at a time
        keep = idx_s >= 0
        out.index_add_(0, idx_s[keep].long(), sgn_s[keep, None] * a_bf[keep])
    if alpha != 1.0:
        out = out * torch.tensor(float(alpha), dtype=torch.float32)
    return out


def _launch(idxs_major, vals, a: torch.Tensor, d: int, alpha) -> torch.Tensor:
    m, k = idxs_major.shape
    n = a.shape[1]
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.to(torch.float32)
    if not (idxs_major.is_cuda and vals.is_cuda
            and idxs_major.device == a.device == vals.device):
        raise ValueError("K4 takes its tables and A on one CUDA device")
    # the kernel reads the (m, k) structure as it is
    idx = idxs_major.to(torch.int32).contiguous()
    sgn = vals.to(torch.float32).contiguous()
    with profiling.span("K4.launch") as span:
        lib = _build.load()
        plan = launch_plan(d, m, n, max_active_ctas(a.device))
        span.set(splits=plan.splits)
        with torch.cuda.device(a.device):
            out = torch.empty((d, n), dtype=torch.float32, device=a.device)
            ws = (torch.empty((plan.splits, d, n), dtype=torch.float32,
                              device=a.device) if plan.splits > 1 else None)
            stream = torch.cuda.current_stream(a.device).cuda_stream
            code = lib.rbt_saso_sketch(
                a.data_ptr(), int(a.dtype == torch.bfloat16), a.stride(0),
                a.stride(1), idx.data_ptr(), sgn.data_ptr(), k,
                None if ws is None else ws.data_ptr(), out.data_ptr(), d,
                m, n, float(alpha), plan.words(), ctypes.c_void_p(stream))
            saso_sketch.launches += 1
        _build.check(code, "saso_sketch_kernel launch")
    return out


def saso_sketch(idxs_major, vals, a: torch.Tensor, d: int,
                alpha=1.0) -> torch.Tensor:
    """alpha * S @ a for a wide SASO given by its per-column structure:
    idxs_major (m, k) output row of each slot of each data row (-1 for
    none), vals (m, k) signs, a (m, n) float32 or bf16 (other types are
    cast to float32), any strides. Returns (d, n) float32, from K4 on a
    CUDA tensor or from the plain version on a CPU one."""
    a = torch.as_tensor(a)
    require(idxs_major.dim() == 2 and vals.shape == idxs_major.shape,
            "idxs_major and vals must be (m, k)")
    m, k = idxs_major.shape
    require(a.dim() == 2 and a.shape[0] == m,
            "operand height must equal S.n_cols")
    require(saso_sketch_supported(d, m, k, a.shape[1]),
            "shape outside the kernel's gate (1 <= k <= 16, "
            "ceil(d / 128) * 128 <= 4096)")
    if a.is_cuda:
        return _launch(idxs_major, vals, a, d, alpha)
    if a.device.type != "cpu":
        raise ValueError(f"no SASO sketch kernel for {a.device}")
    return saso_sketch_reference(idxs_major, vals, a, d, alpha)


saso_sketch.launches = 0
