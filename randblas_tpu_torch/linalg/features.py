"""Random Fourier features (Rahimi-Recht 2007) on the sketching core
(counterpart of randblas_tpu/linalg/features.py).

The feature map z(x) = sqrt(2/D) * cos(W x + b) with W ~ N(0, 1/sigma^2)
satisfies E[z(x)^T z(y)] = exp(-||x - y||^2 / (2 sigma^2)), the RBF kernel,
so kernel methods become linear methods on D features. The product W x^T
is a sketch: it goes through ``sketch_general`` (on the card the fused
kernels, which never store W), and the phases b come from the Uniform
stream of the state after W's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..base import require
from ..dense import DenseDist, DenseDistName, DenseSkOp
from ..rng.state import RNGState
from ..skge import sketch_general


def random_fourier_features(x: torch.Tensor, n_features: int,
                            bandwidth: float, state: RNGState, *,
                            dtype=torch.float32
                            ) -> Tuple[torch.Tensor, RNGState]:
    """RBF-kernel feature map: ``z`` (n, D) with
    ``z(x_i)^T z(x_j) ~= exp(-||x_i - x_j||^2 / (2 bandwidth^2))``.

    ``x`` is (n, d) data; ``n_features`` = D trades approximation error
    (~1/sqrt(D), Rahimi-Recht thm 1) for compute. Returns
    ``(z, next_state)`` on x's device."""
    require(x.dim() == 2, "x must be (n_samples, n_dims)")
    require(n_features >= 1, "n_features must be >= 1")
    require(bandwidth > 0, "bandwidth must be > 0")
    n, d = x.shape
    W = DenseSkOp(DenseDist(n_features, d), state, dtype=dtype)
    # W x^T scaled by 1/bandwidth in the sketch's epilogue
    proj = sketch_general(W, x.to(dtype).T, alpha=1.0 / bandwidth).T
    B = DenseSkOp(DenseDist(1, n_features, family=DenseDistName.Uniform),
                  W.next_state, dtype=dtype)
    # phases uniform on [0, 2 pi): Uniform values are uneg11 * sqrt(3)
    root3 = torch.sqrt(torch.tensor(3.0, dtype=dtype))
    b = (B.materialize(device=x.device)[0] / root3.to(x.device) * 0.5
         + 0.5) * (2.0 * math.pi)
    scale = torch.sqrt(torch.tensor(2.0 / n_features, dtype=dtype))
    return scale.to(x.device) * torch.cos(proj + b), B.next_state
