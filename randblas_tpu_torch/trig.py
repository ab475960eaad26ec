"""SRHT: subsampled randomized Hadamard transform operators (counterpart of
randblas_tpu/trig.py).

The operator is S = R H D, S in R^{d x m}: D = diag(+-1) counter-addressed
Rademacher signs, H the unnormalized +-1 Walsh–Hadamard transform of order
m_pad = next_pow2(m) (ops/hadamard.py), R a uniform iid row sampler with
replacement (util.sample_indices_iid_uniform). Applying S to (m, n) data
costs O(m n log m), whatever d is.

Contracts, as in the JAX package:

- the entries are a function of (dist, seed state): the signs consume
  ceil(m / len_c) counter blocks from the seed, then the row sampler
  ceil(d / len_c) more (the reference's sampler stream, its discarded
  first block included), so signs and indices are the JAX package's bit
  for bit;
- next_state is a function of the distribution only;
- the isometry scale is 1/sqrt(d).

There is no submatrix addressing: H mixes every input row into every
output row, so ``sketch_general`` takes only the full operator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .base import require
from .dense import default_device
from .ops.hadamard import hadamard_transform, next_pow2, srht_max_factor
from .rng.state import RNGState
from .util import _uniform_stream_bits, sample_indices_iid_uniform


@dataclasses.dataclass(frozen=True)
class TrigDist:
    """Distribution over d x m SRHT operators."""
    n_rows: int   # d: sketch dimension
    n_cols: int   # m: data dimension (rows of the data being sketched)

    def __post_init__(self):
        require(self.n_rows > 0 and self.n_cols > 0,
                "TrigDist dimensions must be positive")

    @property
    def padded_cols(self) -> int:
        return next_pow2(self.n_cols)


def trig_isometry_scale(dist: TrigDist) -> float:
    """c with E[(c S)^T (c S)] = I: a sampled row h of H D has
    E[h h^T] = I, and S^T S sums d of them, so c = d^-1/2."""
    return 1.0 / math.sqrt(dist.n_rows)


def compute_next_state(dist: TrigDist, state: RNGState) -> RNGState:
    """Counter arithmetic only: the signs' blocks, then the samples'."""
    len_c = state.block_width
    return state.incr(-(-dist.n_cols // len_c) + -(-dist.n_rows // len_c))


def _signed_padded(signs, m_pad: int, x: torch.Tensor) -> torch.Tensor:
    """diag(signs) x with zero rows appended up to m_pad rows."""
    x = signs[:, None] * x
    if m_pad != x.shape[0]:
        x = torch.nn.functional.pad(x, (0, 0, 0, m_pad - x.shape[0]))
    return x


def _signs_and_indices(dist: TrigDist, state: RNGState, dtype, device):
    """(signs (m,) in ``dtype``, indices (d,) int32) on ``device``: the
    operator's whole randomness."""
    bits, after_signs = _uniform_stream_bits(state, dist.n_cols, device)
    signs = (1 - 2 * (bits & 1)).to(dtype)
    indices, _ = sample_indices_iid_uniform(dist.padded_cols, dist.n_rows,
                                            after_signs, device)
    return signs, indices


class TrigSkOp:
    """A sample from a TrigDist. Lazy: its signs and indices are made on
    the device of the data it is applied to, and kept per device.
    ``signs`` and ``indices`` (tensors) give them for their device."""

    def __init__(self, dist: TrigDist, seed_state, *,
                 next_state: Optional[RNGState] = None,
                 signs: Optional[torch.Tensor] = None,
                 indices: Optional[torch.Tensor] = None,
                 dtype=torch.float32):
        if isinstance(seed_state, int):
            seed_state = RNGState.from_key(seed_state)
        self.dist = dist
        self.seed_state = seed_state
        self.next_state = (next_state if next_state is not None
                           else compute_next_state(dist, seed_state))
        self.dtype = dtype
        self._cache = {}
        require((signs is None) == (indices is None),
                "signs and indices must be given together")
        if signs is not None:
            signs, indices = torch.as_tensor(signs), torch.as_tensor(indices)
            require(tuple(signs.shape) == (dist.n_cols,)
                    and tuple(indices.shape) == (dist.n_rows,),
                    "signs must have n_cols entries and indices n_rows")
            self._cache[signs.device] = (signs.to(dtype),
                                         indices.to(torch.int32))

    @property
    def n_rows(self) -> int:
        return self.dist.n_rows

    @property
    def n_cols(self) -> int:
        return self.dist.n_cols

    @property
    def shape(self):
        return (self.dist.n_rows, self.dist.n_cols)

    def _sample(self, device=None):
        """(signs (m,), indices (d,)) on ``device`` (the card by default),
        made once per device."""
        device = default_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._cache:
            self._cache[device] = _signs_and_indices(
                self.dist, self.seed_state, self.dtype, device)
        return self._cache[device]

    def lmult(self, a: torch.Tensor) -> torch.Tensor:
        """S @ a for a of shape (m, n): sign flip, pad to m_pad, Hadamard,
        keep the sampled rows."""
        require(a.dim() == 2 and a.shape[0] == self.n_cols,
                "lmult needs a with shape (n_cols, n)")
        signs, indices = self._sample(a.device)
        x = _signed_padded(signs.to(a.dtype), self.dist.padded_cols, a)
        return hadamard_transform(x, srht_max_factor(x))[indices.long()]

    def lmult_t(self, b: torch.Tensor) -> torch.Tensor:
        """S^T @ b for b of shape (d, n), the exact adjoint of lmult (H is
        symmetric): add the rows into their sampled positions (indices
        repeat), Hadamard, truncate, sign flip."""
        require(b.dim() == 2 and b.shape[0] == self.n_rows,
                "lmult_t needs b with shape (n_rows, n)")
        signs, indices = self._sample(b.device)
        y = b.new_zeros((self.dist.padded_cols, b.shape[1]))
        y = y.index_add(0, indices.long(), b)
        z = hadamard_transform(y, srht_max_factor(y))[:self.n_cols]
        return signs[:, None].to(b.dtype) * z

    def materialize(self, device=None) -> torch.Tensor:
        """Dense (d, m) tensor of this operator on ``device`` (the card by
        default), for checks."""
        return self.lmult(torch.eye(self.n_cols, dtype=self.dtype,
                                    device=default_device(device)))

    def __repr__(self):
        return (f"TrigSkOp({self.dist.n_rows}x{self.dist.n_cols}, "
                f"m_pad={self.dist.padded_cols}, dtype={self.dtype})")


def srht_operator(d: int, m: int, key: int = 0, dtype=torch.float32,
                  device=None) -> TrigSkOp:
    """An SRHT operator from an integer key, its signs and indices made on
    ``device`` (the card by default)."""
    S = TrigSkOp(TrigDist(d, m), RNGState.from_key(key), dtype=dtype)
    S._sample(device)
    return S
