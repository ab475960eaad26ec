"""randblas_tpu_torch: the PyTorch/CUDA port of randblas_tpu.

Counter-based dense sketching operators whose values are a function of
(seed, position) alone, bit-identical to Random123, and the sketching entry
points ``sketch_general``, ``sketch_vector`` and ``sketch_symmetric``. On
an H100 a sketch by a lazy Gaussian or Uniform operator runs the
hand-written fused RNG-in-GEMM kernels in ``csrc/fused_sketch.cu`` (K1 for
RowMajor-natural operators, K2 for ColMajor-natural ones), which never
store the operator and are differentiable in the data; on the CPU the same
calls run the kernels' plain PyTorch versions. Fills run on the card unless
``device="cpu"`` is given. The package imports torch, never jax.
"""

from .base import Layout, MajorAxis, Op, Side
from .convert import dist_from_jax, skop_from_jax, state_from_jax
from .dense import (DenseDist, DenseDistName, DenseSkOp, compute_next_state,
                    dist_to_layout, fill_dense, fill_dense_submat,
                    major_axis_length)
from .flags import flags, get_flag, set_flag
from .rng import RNGState
from .skge import sketch, sketch_general
from .sksy import require_symmetric, sketch_symmetric
from .skve import sketch_vector

__all__ = [
    "Layout", "MajorAxis", "Op", "Side",
    "RNGState",
    "DenseDist", "DenseDistName", "DenseSkOp", "compute_next_state",
    "dist_to_layout", "fill_dense", "fill_dense_submat", "major_axis_length",
    "sketch", "sketch_general", "sketch_vector", "sketch_symmetric",
    "require_symmetric",
    "flags", "get_flag", "set_flag",
    "dist_from_jax", "skop_from_jax", "state_from_jax",
]
