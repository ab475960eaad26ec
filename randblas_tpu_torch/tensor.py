"""TensorSketch and the Kronecker FJLT: sketches of Khatri–Rao (column-wise
Kronecker) products that never form them (counterpart of
randblas_tpu/tensor.py).

A CountSketch of x1 (x) x2 is the circular convolution of the factors'
CountSketches (Pham–Pagh 2013), so

    TS(A1 ⊙ ... ⊙ Ap) = IRFFT( prod_i RFFT(C_i A_i) )        (per column)

with the d-point transforms along dim 0 (``torch.fft``). Each C_i is the
library's sparse-sign operator with vec_nnz = 1, and each factor's sketch
goes through ``sketch_general``, so on the card a Short CountSketch with
d <= 4096 runs the SASO kernel K4. States chain across factors in order.

Column-sharded factors (DTensors laid out [Replicate(), Shard(1)] over a
mesh's 'data' axis; the JAX package takes them through XLA's sharding
propagation): n is the Khatri–Rao batch axis and every stage of both
sketches acts per column, so each rank runs the unsharded body on its own
columns with no collective, and the sketch comes back as a DTensor laid out
the same way.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from .base import MajorAxis, mesh_of, require
from .ops.hadamard import hadamard_transform, next_pow2, srht_max_factor
from .rng.state import RNGState
from .skge import sketch_general
from .sparse import SparseDist, SparseSkOp
from .trig import _signed_padded
from .util import _uniform_stream_bits, sample_indices_iid_uniform


def _countsketch(d: int, m: int, state: RNGState) -> SparseSkOp:
    """A (d, m) operator with exactly one +-1 per input column. Short
    places vec_nnz per short-axis vector, which is per column only while
    d <= m; for d > m the Long draw (one per column at vec_nnz = 1) keeps
    the per-column structure."""
    major = MajorAxis.Short if d <= m else MajorAxis.Long
    return SparseSkOp(SparseDist(d, m, vec_nnz=1, major_axis=major), state)


def _check_factors(factors, d: int, what: str):
    require(len(factors) >= 1, f"{what} needs at least one factor")
    n = factors[0].shape[1]
    for f in factors:
        require(f.dim() == 2 and f.shape[1] == n,
                "factors must be 2-D with a shared column count")
    require(d >= 1, "sketch size d must be >= 1")


def _check_modes(x, mode_dims, d: int, what: str):
    mode_dims = tuple(int(m) for m in mode_dims)
    require(len(mode_dims) >= 1, f"{what} needs >= 1 mode")
    require(all(m >= 1 for m in mode_dims), "mode dims must be positive")
    require(d >= 1, "sketch size d must be >= 1")
    require(x.dim() == 2 and x.shape[0] == math.prod(mode_dims),
            "x must be 2-D with prod(mode_dims) rows")
    return mode_dims


def _by_columns(sketch, factors, d: int, state: RNGState, dtype, mesh):
    """``sketch(factors, d, state, dtype=dtype)``, for factors of which one
    or more is a DTensor on ``mesh``: the body on this rank's columns of
    each factor (``data_chunk``: no collective for factors laid out
    [Replicate(), Shard(1)]; a plain factor is taken as replicated), the
    output a DTensor laid out [Replicate(), Shard(1)] on the mesh."""
    from .parallel.distributed import data_chunk, data_sharded
    local = [data_chunk(f, mesh, 1)[0] for f in factors]
    out, nxt = sketch(local, d, state, dtype=dtype)
    return data_sharded(out, mesh, 1, (d, factors[0].shape[1])), nxt


def tensor_sketch(factors: Sequence[torch.Tensor], d: int, state: RNGState,
                  *, dtype=torch.float32) -> Tuple[torch.Tensor, RNGState]:
    """Sketch the Khatri–Rao product of ``factors`` ((m_i, n) tensors with a
    shared n) down to ``d`` rows, on the factors' device. Returns
    ``(out (d, n), next_state)``: a CountSketch of the product (unbiased,
    <TS(x), TS(y)> ~= <x, y>). One factor is a plain CountSketch. The
    factors may be column-sharded DTensors (module notes)."""
    _check_factors(factors, d, "tensor_sketch")
    mesh = mesh_of(*factors)
    if mesh is not None:
        return _by_columns(tensor_sketch, factors, d, state, dtype, mesh)
    st = state
    spec = None
    for f in factors:
        C = _countsketch(d, f.shape[0], st)
        cf = sketch_general(C, f.to(dtype))                 # (d, n)
        st = C.next_state
        if len(factors) == 1:
            return cf, st
        fhat = torch.fft.rfft(cf, dim=0)
        spec = fhat if spec is None else spec * fhat
    return torch.fft.irfft(spec, n=d, dim=0).to(dtype), st


def tensor_sketch_explicit(x: torch.Tensor, mode_dims: Sequence[int], d: int,
                           state: RNGState, *, dtype=torch.float32
                           ) -> Tuple[torch.Tensor, RNGState]:
    """S @ x for an explicit x of shape (prod(mode_dims), n), S the same
    operator ``tensor_sketch(factors, d, state)`` applies to Khatri–Rao
    input (rows in row-major mode order, first mode major, as
    ``torch.kron``). The combined hash of row (i_1..i_p) is
    sum_k h_k(i_k) mod d and its sign the product: one ``index_add_`` over
    x's rows. Returns ``(out (d, n), next_state)``, the state
    ``tensor_sketch`` returns."""
    mode_dims = _check_modes(x, mode_dims, d, "tensor_sketch_explicit")
    st = state
    h = sgn = None
    for m in mode_dims:
        C = _countsketch(d, m, st).filled(x.device)
        hk, sk = C.rows.long(), C.vals.to(dtype)
        st = C.next_state
        if h is None:
            h, sgn = hk, sk
        else:
            h = (h[:, None] + hk[None, :]).reshape(-1)
            sgn = (sgn[:, None] * sk[None, :]).reshape(-1)
    out = torch.zeros((d, x.shape[1]), dtype=dtype, device=x.device)
    return out.index_add_(0, h % d, sgn[:, None] * x.to(dtype)), st


def tensor_sketch_vectors(vectors: Sequence[torch.Tensor], d: int,
                          state: RNGState, *, dtype=torch.float32
                          ) -> Tuple[torch.Tensor, RNGState]:
    """tensor_sketch of 1-D factors: the sketch of the single Kronecker
    product (x)_i vectors[i]. Returns ``(out (d,), next_state)``."""
    out, nxt = tensor_sketch([v[:, None] for v in vectors], d, state,
                             dtype=dtype)
    return out[:, 0], nxt


def _kfjlt_sample(mode_dims, d: int, state: RNGState, dtype, device):
    """Per mode (signs, padded dim, sampled row indices), chained signs then
    samples per mode, as the SRHT (so next_state is a function of the
    dims)."""
    st = state
    parts = []
    for m in mode_dims:
        bits, st = _uniform_stream_bits(st, m, device)
        sgn = (1 - 2 * (bits & 1)).to(dtype)
        m_pad = next_pow2(m)
        idx, st = sample_indices_iid_uniform(m_pad, d, st, device)
        parts.append((sgn, m_pad, idx.long()))
    return parts, st


def kfjlt_scale(mode_dims, d: int) -> float:
    """c with E[(c S)^T (c S)] = I for the unnormalized per-mode Hadamards:
    the uniform row sampling absorbs the Hadamard normalization, as in the
    SRHT, so only the 1/d row average remains."""
    return 1.0 / math.sqrt(d)


def kfjlt_sketch(factors: Sequence[torch.Tensor], d: int, state: RNGState,
                 *, dtype=torch.float32) -> Tuple[torch.Tensor, RNGState]:
    """Kronecker FJLT (Jin–Kolda–Ward 2020) of the Khatri–Rao product of
    ``factors``: S = c R (H D_1 (x) ... (x) H D_p), per-mode Rademacher D_i
    and Walsh–Hadamard H, R sampling d Kronecker rows iid (each coordinate
    per mode). A sampled row of the product is the elementwise product of
    the per-mode transformed rows, so the product domain is never formed.
    Returns ``(out (d, n), next_state)``, the isometry scale included. The
    factors may be column-sharded DTensors (module notes)."""
    _check_factors(factors, d, "kfjlt_sketch")
    mesh = mesh_of(*factors)
    if mesh is not None:
        return _by_columns(kfjlt_sketch, factors, d, state, dtype, mesh)
    dims = tuple(f.shape[0] for f in factors)
    parts, nxt = _kfjlt_sample(dims, d, state, dtype, factors[0].device)
    out = None
    for f, (sgn, m_pad, idx) in zip(factors, parts):
        x = _signed_padded(sgn, m_pad, f.to(dtype))
        y = hadamard_transform(x, srht_max_factor(x))[idx]
        out = y if out is None else out * y
    return kfjlt_scale(dims, d) * out, nxt


def kfjlt_sketch_explicit(x: torch.Tensor, mode_dims: Sequence[int], d: int,
                          state: RNGState, *, dtype=torch.float32
                          ) -> Tuple[torch.Tensor, RNGState]:
    """The same KFJLT operator applied to an explicit x of shape
    (prod(mode_dims), n) (rows in row-major mode order): each mode's signed
    Hadamard along its own axis of the mode lattice, then the d sampled
    multi-indices."""
    mode_dims = _check_modes(x, mode_dims, d, "kfjlt_sketch_explicit")
    parts, nxt = _kfjlt_sample(mode_dims, d, state, dtype, x.device)
    n = x.shape[1]
    z = x.to(dtype).reshape(*mode_dims, n)
    for ax, (sgn, m_pad, _idx) in enumerate(parts):
        z = torch.movedim(z, ax, 0)
        rest = z.shape[1:]
        flat = _signed_padded(sgn, m_pad, z.reshape(z.shape[0], -1))
        h = hadamard_transform(flat, srht_max_factor(flat))
        z = torch.movedim(h.reshape(m_pad, *rest), 0, ax)
    out = z[tuple(idx for (_s, _m, idx) in parts)]            # (d, n)
    return kfjlt_scale(mode_dims, d) * out, nxt


def polynomial_kernel_features(x: torch.Tensor, degree: int, d: int,
                               state: RNGState, *, dtype=torch.float32
                               ) -> Tuple[torch.Tensor, RNGState]:
    """Random features for the homogeneous polynomial kernel
    k(u, v) = <u, v>^degree: TensorSketch of ``degree`` copies of x (m, n),
    the n data points as columns. Returns ``(z (d, n), next_state)`` with
    E[<z(u), z(v)>] = k(u, v)."""
    require(degree >= 1, "degree must be >= 1")
    return tensor_sketch([x] * degree, d, state, dtype=dtype)
