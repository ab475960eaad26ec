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
the card unless ``device="cpu"`` is given. Also: SRHT operators
(``TrigSkOp``, Hadamard stages as matrix products), TensorSketch and the
Kronecker FJLT (``tensor``), the samplers and helpers of ``util``, groups
1-3 of the linalg tier in ``randblas_tpu_torch.linalg``, and operators
seeded with the 64-bit-counter generators, whose float64 values are filled
on the card by K6 (``csrc/x64_fill.cu``) and on the CPU by the host
engines (``rng.x64``, and the native engine of ``native``). The package
imports torch, never jax.
"""

from .base import Layout, MajorAxis, Op, Side
from .convert import (blocked_ell_from_jax, coo_from_jax, dist_from_jax,
                      ell_from_jax, skop_from_jax, sparse_skop_from_jax,
                      state_from_jax, trig_skop_from_jax, tt_from_jax,
                      ttmatrix_from_jax)
from .dense import (DenseDist, DenseDistName, DenseSkOp, compute_next_state,
                    dist_to_layout, fill_dense, fill_dense_submat,
                    isometry_scale_factor, major_axis_length)
from .flags import flags, get_flag, set_flag
from .ops.hadamard import hadamard_matrix, hadamard_transform
from .rng import RNGState, default_state
from .skge import sketch, sketch_general
from .sksp import sketch_sparse
from .sparse import (SparseDist, SparseSkOp, fill_sparse, print_sparse,
                     repeated_fisher_yates)
from .sparse_data import (COOMatrix, CSCMatrix, CSRMatrix, IndexBase,
                          NonzeroSort, left_spmm, right_spmm, spmm)
from .sksy import require_symmetric, sketch_symmetric
from .skve import sketch_vector
from .tensor import (kfjlt_sketch, kfjlt_sketch_explicit,
                     polynomial_kernel_features, tensor_sketch,
                     tensor_sketch_explicit, tensor_sketch_vectors)
from .trig import TrigDist, TrigSkOp, srht_operator
from .util import (overwrite_triangle, print_colmaj, safe_scal,
                   sample_indices_iid, sample_indices_iid_uniform,
                   symmetrize, transpose_square, weights_to_cdf)

__all__ = [
    "Layout", "MajorAxis", "Op", "Side",
    "RNGState", "default_state",
    "DenseDist", "DenseDistName", "DenseSkOp", "compute_next_state",
    "dist_to_layout", "fill_dense", "fill_dense_submat",
    "isometry_scale_factor", "major_axis_length",
    "SparseDist", "SparseSkOp", "fill_sparse", "print_sparse",
    "repeated_fisher_yates",
    "TrigDist", "TrigSkOp", "srht_operator",
    "hadamard_matrix", "hadamard_transform",
    "kfjlt_sketch", "kfjlt_sketch_explicit", "polynomial_kernel_features",
    "tensor_sketch", "tensor_sketch_explicit", "tensor_sketch_vectors",
    "sketch", "sketch_general", "sketch_vector", "sketch_symmetric",
    "require_symmetric", "sketch_sparse",
    "COOMatrix", "CSRMatrix", "CSCMatrix", "IndexBase", "NonzeroSort",
    "left_spmm", "right_spmm", "spmm",
    "weights_to_cdf", "sample_indices_iid", "sample_indices_iid_uniform",
    "symmetrize", "overwrite_triangle", "transpose_square", "safe_scal",
    "print_colmaj",
    "flags", "get_flag", "set_flag",
    "dist_from_jax", "skop_from_jax", "state_from_jax",
    "sparse_skop_from_jax", "trig_skop_from_jax", "coo_from_jax",
    "ell_from_jax", "blocked_ell_from_jax", "tt_from_jax",
    "ttmatrix_from_jax",
]
