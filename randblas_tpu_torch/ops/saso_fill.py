"""Sparse-sign operator fill, K7: the wrapper of ``saso_fill_kernel``
(``csrc/saso_fill.cu``), which runs a whole repeated Fisher-Yates fill in
one launch.

K7 replaces no Pallas kernel: the JAX package fills a SparseSkOp with jnp
ops under ``vmap`` (randblas_tpu/sparse.py ``repeated_fisher_yates``). Its
plain version is ``sparse.repeated_fisher_yates_reference``, which runs on
any device and is the only path for CPU tensors; on a CUDA device
``SparseSkOp.filled`` and ``sparse.repeated_fisher_yates`` call
``saso_fill``, and every index and sign equals the plain version's. A call
is counted in ``saso_fill.launches`` and recorded as the span
``K7.launch`` (allocations and the launcher's call).

The kernel keeps each vector's swap log in registers for vec_nnz up to
``REGISTER_LOG`` (``log_in_registers``; vec_nnz = 1 by a one-step
instantiation of its own) and in a scratch tensor of vec_nnz entries a
vector past that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import profiling
from ..rng.state import RNGState
from . import _build

# the generators K7 runs (r123::kPhilox4x32 .. kThreefry2x32 of
# csrc/random123.cuh): the four that rng.state names with 32-bit words
GEN_CODES = {"philox4x32": 0, "philox2x32": 1, "threefry4x32": 2,
             "threefry2x32": 3}
REGISTER_LOG = 16   # the kernel's kRegisterLog: steps its register log holds
INDEX_DTYPES = (torch.int32, torch.int64)
_VALUE_BYTES = (1, 2, 4, 8)


def log_in_registers(vec_nnz: int) -> bool:
    """Whether K7 keeps the log of ``vec_nnz`` steps a vector in registers;
    past ``REGISTER_LOG`` it is a scratch tensor in device memory."""
    return vec_nnz <= REGISTER_LOG


def _check_args(state: RNGState, vec_nnz: int, dim_major: int,
               dim_minor: int, dtype, index_dtype) -> None:
    """Raise ValueError on what K7 does not take."""
    if state.rng not in GEN_CODES:
        raise ValueError(f"K7 takes the generators {tuple(GEN_CODES)}, not "
                         f"{state.rng!r}")
    if not 1 <= vec_nnz <= dim_major:
        raise ValueError("vec_nnz must lie in [1, dim_major]")
    if dim_major >= 2 ** 31:
        raise ValueError("dim_major must fit in int32")
    if dim_minor < 0:
        raise ValueError("dim_minor must be nonnegative")
    if index_dtype not in INDEX_DTYPES:
        raise ValueError(f"K7 writes int32 or int64 indices, not "
                         f"{index_dtype}")
    if index_dtype == torch.int32 and dim_minor > 2 ** 31:
        raise ValueError("int32 indices need dim_minor <= 2**31")
    if not dtype.is_floating_point or dtype.itemsize not in _VALUE_BYTES:
        raise ValueError(f"K7 writes +-1 in a floating type of 1, 2, 4 or "
                         f"8 bytes, not {dtype}")


def seed_words(state: RNGState) -> tuple:
    """The seed as the launcher takes it: counter words 0-3, then key
    words 0-3, the words a generator lacks 0."""
    return (*state.counter, *[0] * (4 - len(state.counter)), *state.key,
            *[0] * (4 - len(state.key)))


@functools.lru_cache(maxsize=None)
def _sign_bits(dtype) -> tuple:
    """The bit patterns of +1 and -1 in ``dtype``, as the plain version
    casts them from int64."""
    signs = torch.tensor([1, -1], dtype=torch.int64).to(dtype)
    raw = signs.view(torch.uint8).reshape(2, -1).tolist()
    return tuple(int.from_bytes(bytes(b), "little") for b in raw)


def saso_fill(state: RNGState, vec_nnz: int, dim_major: int, dim_minor: int,
              dtype=torch.float32, index_dtype=torch.int32, device=None):
    """(major, minor, vals): the ``dim_minor * vec_nnz`` entries of a
    repeated Fisher-Yates fill in minor-vector-major order (vec_nnz
    consecutive entries a minor-axis vector), made by one K7 launch on the
    CUDA ``device``: the sampled major-axis indices, the minor-axis index of
    each entry and the +-1 values. Launched on the current stream, not
    synchronised."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        raise ValueError(f"K7 runs on a CUDA device, not {device}")
    _check_args(state, vec_nnz, dim_major, dim_minor, dtype, index_dtype)
    plus, minus = _sign_bits(dtype)
    n = dim_minor * vec_nnz
    words = (ctypes.c_uint32 * 8)(*seed_words(state))
    with profiling.span("K7.launch"):
        lib = _build.load()
        with torch.cuda.device(device):
            major = torch.empty(n, dtype=index_dtype, device=device)
            minor = torch.empty(n, dtype=index_dtype, device=device)
            vals = torch.empty(n, dtype=dtype, device=device)
            scratch = (None if log_in_registers(vec_nnz) else
                       torch.empty(n, dtype=torch.int64, device=device))
            stream = torch.cuda.current_stream(device).cuda_stream
            code = lib.rbt_saso_fill(
                major.data_ptr(), minor.data_ptr(), vals.data_ptr(),
                None if scratch is None else scratch.data_ptr(), dim_minor,
                vec_nnz, dim_major, words, GEN_CODES[state.rng],
                int(index_dtype == torch.int64), vals.element_size(), plus,
                minus, ctypes.c_void_p(stream))
            saso_fill.launches += 1
        _build.check(code, "saso_fill_kernel launch")
    return major, minor, vals


saso_fill.launches = 0
