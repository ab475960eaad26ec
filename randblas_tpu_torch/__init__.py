"""randblas_tpu_torch: the PyTorch/CUDA port of randblas_tpu.

Counter-based dense and sparse-sign sketching operators whose values are a
function of (seed, position) alone, bit-identical to Random123; the
sketching entry points ``sketch_general``, ``sketch_vector``,
``sketch_symmetric`` and ``sketch_sparse``; sparse data containers and
``left_spmm`` / ``right_spmm`` / ``spmm``. On an H100 a sketch by a lazy
Gaussian or Uniform operator runs the hand-written fused RNG-in-GEMM
kernels in ``csrc/fused_sketch.cu`` (K1 for RowMajor-natural operators, K2
for ColMajor-natural ones), which never store the operator and are
differentiable in the data; a full sparse-sign (SASO) sketch runs K4
(``csrc/saso_sketch.cu``) and a product with sparse data in BlockedELL form
runs K5 (``csrc/ell_spmm.cu``). On the CPU the same calls run the kernels'
plain PyTorch versions. Fills and containers built from host arrays go to
the card unless ``device="cpu"`` is given. The package imports torch,
never jax.
"""

from .base import Layout, MajorAxis, Op, Side
from .convert import (blocked_ell_from_jax, coo_from_jax, dist_from_jax,
                      ell_from_jax, skop_from_jax, sparse_skop_from_jax,
                      state_from_jax)
from .dense import (DenseDist, DenseDistName, DenseSkOp, compute_next_state,
                    dist_to_layout, fill_dense, fill_dense_submat,
                    major_axis_length)
from .flags import flags, get_flag, set_flag
from .rng import RNGState
from .skge import sketch, sketch_general
from .sksp import sketch_sparse
from .sparse import (SparseDist, SparseSkOp, fill_sparse, print_sparse,
                     repeated_fisher_yates)
from .sparse_data import (COOMatrix, CSCMatrix, CSRMatrix, IndexBase,
                          NonzeroSort, left_spmm, right_spmm, spmm)
from .sksy import require_symmetric, sketch_symmetric
from .skve import sketch_vector

__all__ = [
    "Layout", "MajorAxis", "Op", "Side",
    "RNGState",
    "DenseDist", "DenseDistName", "DenseSkOp", "compute_next_state",
    "dist_to_layout", "fill_dense", "fill_dense_submat", "major_axis_length",
    "SparseDist", "SparseSkOp", "fill_sparse", "print_sparse",
    "repeated_fisher_yates",
    "sketch", "sketch_general", "sketch_vector", "sketch_symmetric",
    "require_symmetric", "sketch_sparse",
    "COOMatrix", "CSRMatrix", "CSCMatrix", "IndexBase", "NonzeroSort",
    "left_spmm", "right_spmm", "spmm",
    "flags", "get_flag", "set_flag",
    "dist_from_jax", "skop_from_jax", "state_from_jax",
    "sparse_skop_from_jax", "coo_from_jax", "ell_from_jax",
    "blocked_ell_from_jax",
]
