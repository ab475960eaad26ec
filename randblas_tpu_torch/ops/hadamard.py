"""Walsh–Hadamard transform as Kronecker stages of small matrix products
(counterpart of randblas_tpu/ops/hadamard.py).

The workhorse of the SRHT operator (trig.py). H_m for m = 2^L is the
Kronecker product H_{f1} (x) ... (x) H_{fk} (Sylvester's construction), so
the transform of an (m, n) block is k contractions with small constant
+-1 matrices, one ``torch.tensordot`` (a matmul over the moved axis) a
stage. Each stage reads and writes the block once and does 2 m n f
operations for a factor f, so larger factors mean fewer passes. The JAX
package runs this outside any Pallas kernel, and so does the port: no
hand-written kernel. Float64 stages are native float64 matmuls.

The stages follow torch's matmul precision: with TF32 allowed
(``torch.backends.cuda.matmul.allow_tf32``) a float32 transform rounds its
input to TF32.
"""

from __future__ import annotations

import torch

from .. import base
from ..base import require
from ..dense import default_device

# Stage cap of the SRHT's transforms on CUDA tensors (``srht_max_factor``),
# from gate_sweep.py's G7 on an NVIDIA H100 80GB HBM3 at 700 W (caps 64 to
# 2048, d = 1024, two runs; PERF.md "H100 gates"): float32 stages are
# compute-bound past a factor of about 64, so more stages of smaller factors
# win. At m = 2^16, n = 4096, 3 stages of <= 64 take 6.77-6.79 ms against
# 8.62-8.70 for 2 of 256 (every cap from 256 up); at m = 2^20, n = 64, 4 of
# 32 take 2.26-2.48 against 2.42-2.57 (3 of <= 128) and 6.5-6.7 (2 of
# 1024). At m = 2^12 every cap gives the same 2 stages of 64.
SRHT_CUDA_MAX_FACTOR = 64


def is_pow2(m: int) -> bool:
    return m >= 1 and (m & (m - 1)) == 0


def next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p <<= 1
    return p


def _balanced_factors(m: int, max_factor: int = 128) -> list:
    """Split m = 2^L into balanced power-of-two factors, each <=
    max_factor: the smallest factor stays as large as possible (2^16 at
    cap 128 -> [64, 32, 32], not [128, 128, 4])."""
    lg = m.bit_length() - 1
    if lg == 0:
        return [1]
    cap_lg = max(max_factor.bit_length() - 1, 1)
    stages = -(-lg // cap_lg)
    base, extra = divmod(lg, stages)
    return [1 << (base + (1 if s < extra else 0)) for s in range(stages)]


def hadamard_matrix(k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The k x k +-1 Walsh–Hadamard matrix in natural (Sylvester) order,
    H[i, j] = (-1)^popcount(i & j), on ``device`` (the card by default)."""
    require(is_pow2(k), "Hadamard order must be a power of two")
    i = torch.arange(k, dtype=torch.int64, device=default_device(device))
    x = i[:, None] & i[None, :]
    parity = torch.zeros_like(x)
    for b in range(max(k.bit_length() - 1, 1)):
        parity ^= (x >> b) & 1
    return (1 - 2 * parity).to(dtype)


def srht_max_factor(x: torch.Tensor) -> int:
    """The stage cap the SRHT's transforms (trig.py, tensor.py) pass for
    the block ``x``: ``SRHT_CUDA_MAX_FACTOR`` on the card, else 512, the
    default of ``hadamard_transform``."""
    return SRHT_CUDA_MAX_FACTOR if base.on_card(x) else 512


def hadamard_transform(x: torch.Tensor, max_factor: int = 512
                       ) -> torch.Tensor:
    """H_m @ x for x of shape (m, n), m a power of two, on x's device.
    Unnormalized (H H^T = m I); divide by sqrt(m) for the orthonormal
    transform.

    ``max_factor`` caps each stage's Kronecker factor (a power of two in
    [2, 4096]): a stage costs one pass over the block and 2 m n f
    operations. Differentiable; H is symmetric, so the transform is its
    own adjoint.
    """
    require(x.dim() == 2, "hadamard_transform expects an (m, n) block")
    require(is_pow2(max_factor) and 2 <= max_factor <= 4096,
            "max_factor must be a power of two in [2, 4096]")
    m = x.shape[0]
    require(is_pow2(m), "leading dimension must be a power of two "
                        "(pad rows with zeros; see trig.py)")
    if m == 1:
        return x
    factors = _balanced_factors(m, max_factor)
    y = x.reshape(*factors, x.shape[1])
    for ax, f in enumerate(factors):
        h = hadamard_matrix(f, x.dtype, x.device)
        y = torch.movedim(torch.tensordot(h, y, dims=([1], [ax])), 0, ax)
    return y.reshape(m, x.shape[1])
