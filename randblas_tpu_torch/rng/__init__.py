"""Counter-based RNG core: Philox/Threefry generators, RNGState, transforms
(counterpart of randblas_tpu/rng)."""

from .state import RNGState, DEFAULT_RNG, default_state, generator_info
from .philox import philox4x32, philox2x32
from .threefry import threefry4x32, threefry2x32
from .transforms import u01, uneg11, boxmul_pair, boxmul_block, uneg11_block
from .bits import ctr_add64, mul32_wide, mul32_hi, mulhilo32, rotl32

__all__ = [
    "RNGState", "DEFAULT_RNG", "default_state", "generator_info",
    "philox4x32", "philox2x32", "threefry4x32", "threefry2x32",
    "u01", "uneg11", "boxmul_pair", "boxmul_block", "uneg11_block",
    "ctr_add64", "mul32_wide", "mul32_hi", "mulhilo32", "rotl32",
]
