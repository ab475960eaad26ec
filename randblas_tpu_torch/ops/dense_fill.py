"""Counter-addressed dense fill (counterpart of
randblas_tpu/ops/dense_fill.py).

Every (row, counter block) pair's counter is computed from its position, so
a whole submatrix is one batched generator call on word tensors, on the CPU
or on a CUDA device alike. A value depends only on (seed, position).

Position -> counter mapping (identical to the reference, so streams match):
  - The implicit parent matrix is row-major with ``n_cols_parent`` columns;
    each row is padded to a multiple of the counter width W
    (pad = -n_cols_parent mod W).
  - ptr_padded = ptr + (ptr // n_cols_parent) * pad.
  - Element (r, c) of the submatrix lives at counter
    seed.counter + ptr_padded // W + r * ((n_cols_parent + pad) // W)
    + (first_block_start + c) // W, lane (first_block_start + c) mod W,
    where first_block_start = ptr_padded mod W.

Counter offsets are computed in int64, so an operator may span up to 2**63
counter blocks; the carry into the seed's counter words covers all of them.
"""

from __future__ import annotations

import torch

from ..base import require
from ..rng.bits import ctr_add_words, to_signed
from ..rng.philox import philox2x32_words, philox4x32_words
from ..rng.state import RNGState
from ..rng.threefry import threefry2x32_words, threefry4x32_words
from ..rng.transforms import boxmul_pair, boxmul_pair_i32, uneg11

# float transforms of the raw words: the staged fill's Box-Muller
# ("boxmul"), the fill kernel's signed-view variant ("boxmul_i32"), the
# fused kernel's polynomial variant ("boxmul_fast"), and uniform (-1, 1)
TRANSFORMS = ("boxmul", "boxmul_i32", "boxmul_fast", "uneg11")


def fill_geometry(n_cols_parent: int, n_scols: int, ptr: int, ctr_size: int):
    """Counter-addressing geometry (all Python ints).

    Returns (ctr_mat_start, first_block_start, ctr_stride, nblk, pad).
    """
    pad = (-n_cols_parent) % ctr_size
    ptr_padded = ptr + (ptr // n_cols_parent) * pad
    ctr_mat_start = ptr_padded // ctr_size
    first_block_start = ptr_padded % ctr_size
    ctr_stride = (n_cols_parent + pad) // ctr_size
    nblk = (first_block_start + n_scols - 1) // ctr_size + 1
    return ctr_mat_start, first_block_start, ctr_stride, nblk, pad


def _generator_words(state: RNGState):
    """The state's generator in word form, with the key bound:
    f(counter word planes) -> output word planes."""
    k = state.key
    if state.rng == "philox4x32":
        return lambda c: philox4x32_words(*c, k[0], k[1])
    if state.rng == "philox2x32":
        return lambda c: philox2x32_words(*c, k[0])
    if state.rng == "threefry4x32":
        return lambda c: threefry4x32_words(*c, *k)
    if state.rng == "threefry2x32":
        return lambda c: threefry2x32_words(*c, *k)
    raise ValueError(f"no word-form generator for {state.rng!r}")


def rowmajor_words(state: RNGState, n_rows: int, nblk: int,
                   ctr_stride: int, device=None):
    """Output word planes, each (n_rows, nblk), of the counter blocks at
    ``state.counter + r * ctr_stride + b``."""
    require(n_rows * ctr_stride + nblk < 2 ** 63,
            "counter offsets must stay below 2**63")
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    blk = torch.arange(nblk, dtype=torch.int64, device=device)
    off = rows[:, None] * ctr_stride + blk[None, :]
    return _generator_words(state)(ctr_add_words(state.counter, off))


def transform_words(words, transform: str):
    """Float32 value planes of the word planes under ``transform``."""
    if transform == "uneg11":
        return [uneg11(w) for w in words]
    if transform not in TRANSFORMS:
        raise ValueError(f"unknown transform {transform!r}")
    out = []
    for i in range(0, len(words), 2):
        if transform == "boxmul":
            out.extend(boxmul_pair(words[i], words[i + 1]))
        else:
            out.extend(boxmul_pair_i32(to_signed(words[i]),
                                       to_signed(words[i + 1]),
                                       fast_cos=transform == "boxmul_fast"))
    return out


def rowmajor_values(state: RNGState, n_rows: int, nblk: int,
                    ctr_stride: int, transform: str, device=None):
    """float32 (n_rows, nblk * W): element (r, c) is lane c % W of the
    counter block at ``state.counter + r * ctr_stride + c // W``."""
    planes = transform_words(
        rowmajor_words(state, n_rows, nblk, ctr_stride, device), transform)
    return torch.stack(planes, dim=-1).reshape(n_rows, nblk * len(planes))


def fill_rowmajor(n_cols_parent: int, n_srows: int, n_scols: int, ptr: int,
                  state: RNGState, transform: str, device=None):
    """float32 (n_srows, n_scols) submatrix of the implicit row-major
    parent whose first element is at flat position ``ptr``."""
    ctr_mat_start, fbs, ctr_stride, nblk, _ = fill_geometry(
        n_cols_parent, n_scols, ptr, state.block_width)
    vals = rowmajor_values(state.incr(ctr_mat_start), n_srows, nblk,
                           ctr_stride, transform, device)
    return vals[:, fbs:fbs + n_scols]


def fill_colmajor(n_cols_parent: int, n_srows: int, n_scols: int, ptr: int,
                  state: RNGState, transform: str, device=None):
    """``fill_rowmajor(...).T`` (a transposed view)."""
    return fill_rowmajor(n_cols_parent, n_srows, n_scols, ptr, state,
                         transform, device).T


def fill_next_state(n_cols_parent: int, n_srows: int, n_scols: int,
                    ptr: int, state: RNGState) -> RNGState:
    """State returned by a submatrix fill: the seed advanced past the last
    row's first counter. Pure counter arithmetic."""
    ctr_mat_start, _, ctr_stride, _, _ = fill_geometry(
        n_cols_parent, n_scols, ptr, state.block_width)
    return state.incr(ctr_mat_start).incr(n_srows * ctr_stride)
