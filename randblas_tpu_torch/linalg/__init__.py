"""Sketching-based linear algebra (counterpart of randblas_tpu/linalg):
groups 1-3 of the JAX package's linalg tier. The rangefinder and QB
decomposition, randomized SVD, sketched least squares and total least
squares, and the tall-skinny ``cholqr`` they orthonormalize with; Nystrom
and its PCG, the trace and diagonal estimators, leverage scores, the
spectral tools, the randomized eigensolvers; the block-Krylov SVD, sketched
GMRES, randomized Gram-Schmidt QR, RPCholesky, QRCP/ID/CUR, approximate
matrix multiplication and random Fourier features; the one-pass and
streaming SVD and Frequent Directions, Lanczos quadrature, spectral
densities, block Kaczmarz and Gauss-Seidel, and the tensor-train and Tucker
decompositions; and the distributed rangefinder, QB, randomized SVD, block
Krylov rangefinder and Frequent Directions on row-sharded data
(``randblas_tpu_torch.parallel``'s meshes)."""

from .amm import amm, sample_lsq
from .density import eig_count, kpm_density, spectral_density
from .distributed import (cholqr, distributed_fd,
                          distributed_krylov_rangefinder, distributed_qb,
                          distributed_rangefinder, distributed_rsvd)
from .eigh import rand_eigh, rand_geigh
from .embed import make_embedding
from .features import random_fourier_features
from .kaczmarz import block_gauss_seidel, block_kaczmarz
from .krylov import krylov_rangefinder, rsvd_krylov
from .leverage import exact_leverage_scores, leverage_scores
from .lstsq import (cgls, ihs_lsq, min_norm_lsq, ridge_lsq,
                    sketch_and_precondition, sketch_and_solve_lsq)
from .nystrom import nystrom, nystrom_apply, nystrom_pcg
from .qb import (adaptive_rangefinder, qb_decompose, qb_to_svd,
                 range_error_estimate, rangefinder)
from .qrcp import column_id, cur, sketch_qrcp
from .quadrature import lanczos_fn_apply, logdet, slq
from .rgs import rgs_qr
from .rpcholesky import rpcholesky, rpcholesky_pcg
from .rsvd import rsvd, rsvd_adaptive
from .sgmres import sgmres
from .spectral import (extremal_eigs, power_method, required_power_iters,
                       sketched_eigs, spectral_norm)
from .streaming import (FrequentDirections, StreamingSketch, fd_pass,
                        single_pass_svd)
from .tls import sketched_tls, tls_via_svd
from .trace import (diag_hutchinson, exact_trace, hutchinson, hutchpp,
                    rademacher_probes, xdiag, xtrace)
from .tt import (TTMatrix, TTStream, TTTensor, tt_add, tt_dot, tt_from_dense,
                 tt_gaussian, tt_matrix_gaussian, tt_matvec, tt_norm,
                 tt_round, tt_round_deterministic, tt_scale, tt_single_pass)
from .tucker import tucker_from_dense, tucker_full

__all__ = [
    # group 1
    "adaptive_rangefinder", "cgls", "cholqr", "ihs_lsq", "make_embedding",
    "min_norm_lsq", "qb_decompose", "qb_to_svd", "range_error_estimate",
    "rangefinder", "ridge_lsq", "rsvd", "rsvd_adaptive",
    "sketch_and_precondition", "sketch_and_solve_lsq", "sketched_tls",
    "tls_via_svd",
    # group 2
    "nystrom", "nystrom_apply", "nystrom_pcg",
    "diag_hutchinson", "exact_trace", "hutchinson", "hutchpp",
    "rademacher_probes", "xdiag", "xtrace",
    "exact_leverage_scores", "leverage_scores",
    "extremal_eigs", "power_method", "required_power_iters",
    "sketched_eigs", "spectral_norm",
    "rand_eigh", "rand_geigh",
    # group 3
    "krylov_rangefinder", "rsvd_krylov", "sgmres", "rgs_qr",
    "rpcholesky", "rpcholesky_pcg", "column_id", "cur", "sketch_qrcp",
    "amm", "sample_lsq", "random_fourier_features",
    # group 4
    "StreamingSketch", "FrequentDirections", "fd_pass", "single_pass_svd",
    "slq", "logdet", "lanczos_fn_apply",
    "kpm_density", "spectral_density", "eig_count",
    "block_kaczmarz", "block_gauss_seidel",
    # group 5
    "TTTensor", "TTMatrix", "TTStream", "tt_from_dense", "tt_gaussian",
    "tt_matrix_gaussian", "tt_add", "tt_dot", "tt_norm", "tt_scale",
    "tt_round", "tt_round_deterministic", "tt_matvec", "tt_single_pass",
    "tucker_from_dense", "tucker_full",
    # the distributed layer's
    "distributed_fd", "distributed_krylov_rangefinder", "distributed_qb",
    "distributed_rangefinder", "distributed_rsvd",
]
