"""Utilities: CDF sampling, symmetry helpers (counterpart of
randblas_tpu/util.py).

The samplers consume counters exactly as the reference's
``sample_indices_iid`` loop (util.hh:285-306) does, and map the words to
indices in float64, as the reference does with T = double, so the indices
are the JAX package's bit for bit. Samplers that take no tensor run on the
card unless ``device="cpu"`` is given; the others follow their input's
device.
"""

from __future__ import annotations

import torch

from .base import require
from .dense import default_device
from .ops.dense_fill import _generator_words
from .rng.bits import ctr_add_words, to_signed
from .rng.state import RNGState
from .rng.transforms import uneg11


def weights_to_cdf(w, error_if_below: float = None):
    """Nonnegative weights -> normalized cumulative distribution
    (util.hh:258-270). Weights below ``error_if_below`` (default: minus the
    dtype's epsilon) raise."""
    w = torch.as_tensor(w)
    floor = (-torch.finfo(w.dtype).eps if error_if_below is None
             else error_if_below)
    require(bool((w >= floor).all()), "weights must be >= the error threshold")
    cdf = torch.cumsum(w.clamp(min=0.0), dim=0)
    return cdf / cdf[-1]


def _uniform_stream_bits(state: RNGState, k: int, device=None):
    """k raw words (int64 tensor holding uint32 values) consuming counters
    exactly like the reference's sample_indices_iid loop, and the state
    after them.

    The reference's quirk is kept: it generates a block at the initial
    counter before its loop, but its refresh condition ``(i+1) % len_c ==
    1`` fires already at i = 0, so that first block is discarded. Sample i
    reads block 1 + i // len_c, lane i % len_c, and the state advances by
    ceil(k / len_c)."""
    len_c = state.block_width
    n_blocks = -(-k // len_c)
    offsets = torch.arange(1, n_blocks + 1, dtype=torch.int64,
                           device=default_device(device))
    words = _generator_words(state)(ctr_add_words(state.counter, offsets))
    bits = torch.stack(words, dim=-1).reshape(-1)[:k]
    return bits, state.incr(n_blocks)


def _uniform_stream(state: RNGState, k: int, device=None):
    """k uneg11 float32 values from ``_uniform_stream_bits``."""
    bits, next_state = _uniform_stream_bits(state, k, device)
    return uneg11(bits), next_state


def _u01_f64(bits: torch.Tensor) -> torch.Tensor:
    """(uneg11 + 1) / 2 in float64, the reference's T = double path
    (r123::uneg11<double, uint32_t>): the int32 view of the word, then
    s * 2^-31 + 2^-32, all exact in float64."""
    u = to_signed(bits).to(torch.float64) * 2.0 ** -31 + 2.0 ** -32
    return (u + 1.0) / 2.0


def sample_indices_iid(cdf, k: int, state: RNGState):
    """k iid samples from the distribution over {0..n-1} given by ``cdf``
    (inverse CDF by searchsorted, util.hh:285-306), in float64, on cdf's
    device. Returns (samples int32[k], next_state)."""
    cdf = torch.as_tensor(cdf)
    bits, next_state = _uniform_stream_bits(state, k, cdf.device)
    samples = torch.searchsorted(cdf.to(torch.float64), _u01_f64(bits),
                                 side="left")
    return samples.to(torch.int32), next_state


def sample_indices_iid_uniform(n: int, k: int, state: RNGState, device=None):
    """k iid samples uniform over {0..n-1} (util.hh:312-334): floor(n * u01)
    in float64, as the reference computes it for any n < 2^31, on
    ``device`` (the card by default). Returns (samples int32[k],
    next_state)."""
    bits, next_state = _uniform_stream_bits(state, k, device)
    samples = torch.floor(n * _u01_f64(bits)).to(torch.int32)
    return samples.clamp(0, n - 1), next_state


def symmetrize(a, uplo: str = "upper"):
    """Copy one triangle onto the other (util.hh:119-140), functional."""
    a = torch.as_tensor(a)
    require(a.dim() == 2 and a.shape[0] == a.shape[1], "a must be square")
    if uplo.lower().startswith("u"):
        return torch.triu(a) + torch.triu(a, 1).T
    return torch.tril(a) + torch.tril(a, -1).T


def overwrite_triangle(a, uplo: str, strict_offset: int = 1, val=0.0):
    """Set a triangle to ``val`` (util.hh:142-163), functional."""
    a = torch.as_tensor(a)
    i = torch.arange(a.shape[0], device=a.device)[:, None]
    j = torch.arange(a.shape[1], device=a.device)[None, :]
    if uplo.lower().startswith("u"):
        mask = j >= i + strict_offset
    else:
        mask = i >= j + strict_offset
    return torch.where(mask, torch.as_tensor(val, dtype=a.dtype,
                                             device=a.device), a)


def transpose_square(a):
    """Transpose of a square matrix (util.hh transpose_square); the
    reference transposes in place, this returns the view ``a.T``."""
    a = torch.as_tensor(a)
    require(a.dim() == 2 and a.shape[0] == a.shape[1], "a must be square")
    return a.T


def safe_scal(alpha, x):
    """alpha * x that OVERWRITES with zeros when alpha == 0 and never
    multiplies then (util.hh safe_scal): 0 * inf/NaN gives 0, as the
    library's beta == 0 contract (ops/accumulate.py) requires."""
    x = torch.as_tensor(x)
    if isinstance(alpha, (int, float)):
        if alpha == 0:
            return torch.zeros_like(x)
        return torch.as_tensor(alpha, dtype=x.dtype) * x
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    zeros = torch.zeros_like(x)
    return torch.where(alpha == 0, zeros,
                       alpha * torch.where(alpha == 0, zeros, x))


def print_colmaj(a, label: str = ""):
    """Debug printer, row by row (util.hh print_colmaj)."""
    a = torch.as_tensor(a).detach().cpu()
    if label:
        print(label)
    for r in range(a.shape[0]):
        print("  " + "  ".join(f"{float(a[r, c]): .6f}"
                               for c in range(a.shape[1])))
