"""randblas_tpu_torch: the PyTorch/CUDA port of randblas_tpu.

Counter-based dense sketching operators whose values are a function of
(seed, position) alone, bit-identical to Random123, and the sketching entry
point ``sketch_general``. On an H100 the main path (a left sketch by a wide
Gaussian operator) runs the hand-written fused RNG-in-GEMM kernel in
``csrc/fused_sketch.cu``, which never stores the operator; on the CPU the
same calls run the kernels' plain PyTorch versions. The package imports
torch, never jax.
"""

from .base import Layout, MajorAxis, Op, Side
from .convert import dist_from_jax, skop_from_jax, state_from_jax
from .dense import (DenseDist, DenseDistName, DenseSkOp, compute_next_state,
                    dist_to_layout, fill_dense, fill_dense_submat,
                    major_axis_length)
from .flags import flags, get_flag, set_flag
from .rng import RNGState
from .skge import sketch, sketch_general

__all__ = [
    "Layout", "MajorAxis", "Op", "Side",
    "RNGState",
    "DenseDist", "DenseDistName", "DenseSkOp", "compute_next_state",
    "dist_to_layout", "fill_dense", "fill_dense_submat", "major_axis_length",
    "sketch", "sketch_general",
    "flags", "get_flag", "set_flag",
    "dist_from_jax", "skop_from_jax", "state_from_jax",
]
