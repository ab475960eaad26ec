"""Operator-block fill of x64 seeds (K6): the wrapper of the CUDA kernels in
``csrc/x64_fill.cu`` and their plain PyTorch version.

An operator seeded with a 64-bit-counter generator (Philox2x64-10,
Philox4x64-10, Threefry2x64-20, Threefry4x64-20: an x64 seed) has float64
values. The JAX package makes them on the host (randblas_tpu/rng/x64.py
``fill_rowmajor64`` and its C++ engine), since a TPU has no 64-bit integer
lanes, so K6 replaces no Pallas kernel. ``fill_block64`` makes the (rows,
cols) block of such an operator at any offset, contiguous in math
orientation, with ``fill_rowmajor64``'s counter map: on a CUDA device by K6
(``fill_block64_kernel`` for a RowMajor-natural block, ``fill_block64_T_
kernel`` for a ColMajor-natural one, which it writes transposed), counted
in ``fill_block64.launches``; on a CPU device by the plain version.

``fill_block64_reference`` is the plain version on any device: the block
functions and transforms of ``rng/x64.py``'s tensor section on int64
tensors of 32-bit limbs. Gaussian values are Box-Muller pairs in float64,
Uniform values uneg11 times sqrt(3) in float64. On the card K6 and the
plain version call the same sin, cos, log and sqrt and agree bit for bit;
against the host engines (``rng/x64.py``'s numpy fill, ``native``) Uniform
values are bitwise and Gaussian ones a few ulp apart.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..base import Layout
from ..rng import x64
from ..rng.bits import ctr_add_words
from ..rng.state import RNGState
from . import _build

GEN_CODES = {"philox2x64": 0, "philox4x64": 1, "threefry2x64": 2,
             "threefry4x64": 3}
_SQRT3 = math.sqrt(3.0)


class _Plan64(NamedTuple):
    """A block in the natural orientation: ``rows`` x ``cols`` values whose
    row r, counter block b lives at ``first`` + r * ``ctr_stride`` + b (w
    values a block), its first ``shift`` values skipped. ``colmajor``: the
    natural block is the transposed math block."""
    first: RNGState
    rows: int
    cols: int
    shift: int
    ctr_stride: int
    w: int
    gaussian: bool
    colmajor: bool


def _plan64(dist, state: RNGState, rows_s, cols_s, ro_s, co_s) -> _Plan64:
    from ..dense import DenseDistName, dist_to_layout
    if state.rng not in GEN_CODES:
        raise ValueError(f"K6 takes the x64 generators {tuple(GEN_CODES)}, "
                         f"not {state.rng!r}")
    if dist.family not in (DenseDistName.Gaussian, DenseDistName.Uniform):
        raise ValueError("the x64 fill takes Gaussian or Uniform operators")
    if not (0 <= ro_s and rows_s + ro_s <= dist.n_rows
            and 0 <= co_s and cols_s + co_s <= dist.n_cols):
        raise ValueError("submatrix out of bounds")
    w = state.block_width
    colmajor = dist_to_layout(dist) == Layout.ColMajor
    if colmajor:  # the natural matrix is the transposed parent
        rows, cols, ro, co, minor = cols_s, rows_s, co_s, ro_s, dist.n_rows
    else:
        rows, cols, ro, co, minor = rows_s, cols_s, ro_s, co_s, dist.n_cols
    ctr_stride = -(-minor // w)
    return _Plan64(state.incr(ro * ctr_stride + co // w), rows, cols, co % w,
                   ctr_stride, w, dist.family == DenseDistName.Gaussian,
                   colmajor)


def _words(limbs) -> list:
    return [int(v) for v in x64.limbs_to_words(np.asarray(limbs, np.uint32))]


def _plain64(p: _Plan64, device) -> torch.Tensor:
    nblk = (p.shift + p.cols + p.w - 1) // p.w
    offs = (torch.arange(p.rows, dtype=torch.int64, device=device)[:, None]
            * p.ctr_stride
            + torch.arange(nblk, dtype=torch.int64, device=device)[None, :])
    limbs = ctr_add_words(p.first.counter, offs)
    ctr = [(limbs[2 * i], limbs[2 * i + 1]) for i in range(p.w)]
    rounds = x64.GENERATORS_X64[p.first.rng][3]
    blocks = x64.GENERATORS_X64_T[p.first.rng](ctr, _words(p.first.key),
                                               rounds)
    vals = x64.block_values_f64_t(blocks, "boxmul" if p.gaussian
                                  else "uneg11")
    vals = torch.stack(vals, dim=-1).reshape(p.rows, nblk * p.w)
    vals = vals[:, p.shift:p.shift + p.cols]
    if not p.gaussian:
        vals = vals * _SQRT3
    return (vals.T if p.colmajor else vals).contiguous()


def _launch64(p: _Plan64, device) -> torch.Tensor:
    lib = _build.load()
    shape = (p.cols, p.rows) if p.colmajor else (p.rows, p.cols)
    ctr, key = _words(p.first.counter), _words(p.first.key)
    words = (ctypes.c_uint64 * 8)(*ctr, *[0] * (4 - len(ctr)), *key,
                                  *[0] * (4 - len(key)))
    with torch.cuda.device(device):
        out = torch.empty(shape, dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.rbt_fill_block64(
            out.data_ptr(), p.rows, p.cols, p.shift, p.ctr_stride, words,
            GEN_CODES[p.first.rng], int(p.gaussian), int(p.colmajor),
            ctypes.c_void_p(stream))
        fill_block64.launches += 1
    _build.check(code, "fill_block64 launch")
    return out


def _fill64(dist, state, rows_s, cols_s, ro_s, co_s, device) -> torch.Tensor:
    """``fill_block64`` for the operator of ``dist`` seeded at ``state``:
    the entry of ``dense.fill_dense_submat``'s route on the card."""
    from ..dense import default_device
    device = default_device(device)
    p = _plan64(dist, state, rows_s, cols_s, ro_s, co_s)
    if device.type == "cuda":
        return _launch64(p, device)
    if device.type == "cpu":
        return _plain64(p, device)
    raise ValueError(f"no x64 fill kernel for {device}")


def fill_block64(S, rows_s: int, cols_s: int, ro_s: int = 0, co_s: int = 0,
                 device=None) -> torch.Tensor:
    """The (rows_s, cols_s) float64 block of the lazy x64-seeded operator S
    at (ro_s, co_s), contiguous in math orientation, made by K6 on a CUDA
    device (the default) or by its plain version on the CPU
    (``device="cpu"``). Uniform values are scaled by sqrt(3) in float64."""
    return _fill64(S.dist, S.seed_state, rows_s, cols_s, ro_s, co_s, device)


fill_block64.launches = 0


def fill_block64_reference(S, rows_s: int, cols_s: int, ro_s: int = 0,
                           co_s: int = 0, device=None) -> torch.Tensor:
    """The plain PyTorch version of K6 on ``device`` (the card by
    default)."""
    from ..dense import default_device
    return _plain64(_plan64(S.dist, S.seed_state, rows_s, cols_s, ro_s, co_s),
                    default_device(device))
