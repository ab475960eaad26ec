"""Sketching-based linear algebra (counterpart of randblas_tpu/linalg):
the first group of the JAX package's linalg tier, the rangefinder and QB
decomposition, randomized SVD, sketched least squares and total least
squares, and the tall-skinny ``cholqr`` they orthonormalize with."""

from .distributed import cholqr
from .embed import make_embedding
from .lstsq import (cgls, ihs_lsq, min_norm_lsq, ridge_lsq,
                    sketch_and_precondition, sketch_and_solve_lsq)
from .qb import (adaptive_rangefinder, qb_decompose, qb_to_svd,
                 range_error_estimate, rangefinder)
from .rsvd import rsvd, rsvd_adaptive
from .tls import sketched_tls, tls_via_svd

__all__ = [
    "adaptive_rangefinder", "cgls", "cholqr", "ihs_lsq", "make_embedding",
    "min_norm_lsq", "qb_decompose", "qb_to_svd", "range_error_estimate",
    "rangefinder", "ridge_lsq", "rsvd", "rsvd_adaptive",
    "sketch_and_precondition", "sketch_and_solve_lsq", "sketched_tls",
    "tls_via_svd",
]
