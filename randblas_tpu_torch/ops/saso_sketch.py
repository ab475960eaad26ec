"""SASO sketch, K4: B = alpha * S @ A for a wide sparse-sign operator with
exactly k signed entries per data column (counterpart of
randblas_tpu/ops/saso_sketch.py).

The wrapper builds the (k, m) index and sign tables from the filled
operator's (m, k) structure, as the JAX package does, and on a CUDA tensor
launches ``saso_sketch_kernel`` (``csrc/saso_sketch.cu``); on a CPU tensor it
runs the plain version. Both round A to bf16 (the JAX package pre-casts A)
and sum in float32, so they differ only in the order of the sums. Launches
are counted in ``saso_sketch.launches``.

The kernel holds all d output rows of a 32-column strip in shared memory,
so d is limited by the card's 227 KB per block: ``saso_sketch_supported``
says which calls it takes (d up to 1620 at k = 8 and 1556 at k = 16; the
JAX package's VMEM gate is d_pad <= 4096). The JAX gate's k <= 16 stays.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import require
from . import _build

MAX_K = 16
MAX_SMEM = 232448   # bytes of shared memory one H100 block can use
_SM_SMEM = 233472   # bytes of shared memory on one SM (blocks share it)
_TN, _ROWS, _TILE_LD = 32, 128, 33   # the kernel's strip, tile and tile row


def _smem_bytes(d: int, k: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the source)."""
    return d * _TN * 4 + _ROWS * _TILE_LD * 4 + _ROWS * k * 8


def saso_sketch_supported(d: int, m: int, k: int, n: int) -> bool:
    """Shape gate of K4: 1 <= k <= 16, and the d x 32 float32 sums, the
    staged tile of A and its tables fit one block's shared memory."""
    return 1 <= k <= MAX_K and d >= 1 and m >= 1 and n >= 1 \
        and _smem_bytes(d, k) <= MAX_SMEM


def _tables(idxs_major, vals):
    """(k, m) int32 index and float32 sign tables from (m, k)."""
    idx = idxs_major.to(torch.int32).T.contiguous()
    sgn = vals.to(torch.float32).T.contiguous()
    return idx, sgn


def saso_sketch_reference(idxs_major, vals, a: torch.Tensor, d: int,
                          alpha=1.0) -> torch.Tensor:
    """The plain PyTorch version of K4 on a's device: A rounded to bf16,
    every (data row, slot) term sign * A[c] added into output row
    idx[c, slot] (padding index -1 adds nothing), float32 sums, one slot
    after another."""
    a_bf = a.to(torch.bfloat16).to(torch.float32)
    idx, sgn = _tables(idxs_major, vals)
    out = torch.zeros((d, a.shape[1]), dtype=torch.float32, device=a.device)
    for idx_s, sgn_s in zip(idx, sgn):   # one slot at a time
        keep = idx_s >= 0
        out.index_add_(0, idx_s[keep].long(), sgn_s[keep, None] * a_bf[keep])
    if alpha != 1.0:
        out = out * torch.tensor(float(alpha), dtype=torch.float32)
    return out


def _split(strips: int, n_tiles: int, smem: int, device) -> int:
    """Row ranges per strip so that the grid fills the SMs once."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, min(8, _SM_SMEM // (smem + 1024)))   # 1 KB per block
    return max(1, min(n_tiles, (sms * per_sm) // strips, 65535))


def _launch(idxs_major, vals, a: torch.Tensor, d: int, alpha) -> torch.Tensor:
    m, k = idxs_major.shape
    n = a.shape[1]
    if a.dtype not in (torch.float32, torch.bfloat16):
        a = a.to(torch.float32)
    if a.stride(1) != 1 and a.stride(0) != 1:
        a = a.contiguous()
    if not (idxs_major.is_cuda and vals.is_cuda
            and idxs_major.device == a.device == vals.device):
        raise ValueError("K4 takes its tables and A on one CUDA device")
    idx, sgn = _tables(idxs_major, vals)
    smem = _smem_bytes(d, k)
    strips = -(-n // _TN)
    n_tiles = -(-m // _ROWS)
    lib = _build.load()
    with torch.cuda.device(a.device):
        split = _split(strips, n_tiles, smem, a.device)
        rows_per_split = -(-n_tiles // split) * _ROWS
        split = -(-m // rows_per_split)
        out = torch.empty((d, n), dtype=torch.float32, device=a.device)
        partial = (torch.empty((split, d, n), dtype=torch.float32,
                               device=a.device) if split > 1 else None)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rbt_saso_sketch(
            a.data_ptr(), int(a.dtype == torch.bfloat16), a.stride(0),
            a.stride(1), idx.data_ptr(), sgn.data_ptr(), m, out.data_ptr(),
            None if partial is None else partial.data_ptr(), d, m, n, k,
            split, rows_per_split, float(alpha), ctypes.c_void_p(stream))
        saso_sketch.launches += 1
    _build.check(code, "saso_sketch_kernel launch")
    return out


def saso_sketch(idxs_major, vals, a: torch.Tensor, d: int,
                alpha=1.0) -> torch.Tensor:
    """alpha * S @ a for a wide SASO given by its per-column structure:
    idxs_major (m, k) output row of each slot of each data row (-1 for
    none), vals (m, k) signs, a (m, n) float32 or bf16 (other types are
    cast to float32), row- or column-major. Returns (d, n) float32, from
    K4 on a CUDA tensor or from the plain version on a CPU one."""
    a = torch.as_tensor(a)
    require(idxs_major.dim() == 2 and vals.shape == idxs_major.shape,
            "idxs_major and vals must be (m, k)")
    m, k = idxs_major.shape
    require(a.dim() == 2 and a.shape[0] == m,
            "operand height must equal S.n_cols")
    require(saso_sketch_supported(d, m, k, a.shape[1]),
            "shape outside the kernel's gate (k <= 16, d x 32 float32 sums "
            "in one block's shared memory)")
    if a.is_cuda:
        return _launch(idxs_major, vals, a, d, alpha)
    if a.device.type != "cpu":
        raise ValueError(f"no SASO sketch kernel for {a.device}")
    return saso_sketch_reference(idxs_major, vals, a, d, alpha)


saso_sketch.launches = 0
