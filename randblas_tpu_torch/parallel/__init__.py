"""Multi-GPU sketching over torch.distributed (counterpart of
randblas_tpu/parallel).

Counter addressing makes the distributed sketch a local computation: every
rank generates its tile of one global operator from (seed, tile
coordinates), with no communication and bit for bit the single-device
operator; only the contraction reduces (one all-reduce over 'data')."""

from .distributed import (
    distributed_sketch, distributed_sketch_cols, distributed_sketch_jit,
    distributed_sketch_right, distributed_sketch_sparse_data,
    distributed_sparse_sketch, make_sketch_mesh,
)
from .multihost import (
    arrange_multihost_devices, initialize_multihost,
    make_multihost_sketch_mesh,
)

__all__ = ["distributed_sketch", "distributed_sketch_right",
           "distributed_sketch_cols", "distributed_sparse_sketch",
           "distributed_sketch_sparse_data", "make_sketch_mesh",
           "distributed_sketch_jit", "arrange_multihost_devices",
           "initialize_multihost", "make_multihost_sketch_mesh"]
