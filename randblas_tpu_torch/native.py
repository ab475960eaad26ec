"""ctypes bindings for the native host engine (native/randblas_host.cpp):
the port's own build and loader of the library the JAX package's native.py
loads.

The library is optional: ``available()`` gates every entry point, and the
numpy and PyTorch paths are always present. The first call of
``available()`` (or of any entry point) compiles ``native/randblas_host.cpp``
with ``native/Makefile``'s flags into ``randblas_tpu_torch/_build/``
(``build``), where missing, and loads it. The compile tries, in order, the
Makefile's compiler (``$CXX``, else g++), the g++ on PATH, and the
Makefile's flags without -fopenmp (``_variants``). The library's name holds
a hash of the source and the flags, so an edited source builds anew. If the
build or the load fails, ``available()`` is False from then on: there is one
attempt per process.

Processes share the build: it runs under an exclusive ``fcntl.flock`` on a
lock file in the build directory, compiles to a temporary file and moves it
into place with ``os.replace``, so a process sees either no library or a
whole one, and only the first compiles. The port never writes
``native/librandblas_host.so``, which the JAX package's loader builds in
place with ``make``.

The x64 fill (``fill_rowmajor64``) is what ``dense.fill_dense_submat``
runs for an x64 seed on the CPU when ``dense.use_native_x64`` allows (on
the card the kernel K6 fills).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "randblas_host.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile's CXXFLAGS
_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra",
          "-std=c++17")

# wall seconds of this process's compile; None when it compiled nothing
build_seconds = None


def _variants():
    """(compiler, flags) tried in order until one builds: the Makefile's
    compiler; the g++ on PATH, for an environment whose $CXX has no OpenMP
    runtime (no libgomp.spec); and the Makefile's flags without -fopenmp,
    which leaves the engine's pragmas unused and runs it on one thread with
    the same values (its loops are independent per row or vector)."""
    cxx = os.environ.get("CXX") or "g++"
    serial = tuple(f for f in _FLAGS if f != "-fopenmp")
    return ((cxx, _FLAGS), ("g++", _FLAGS), (cxx, serial))


def _library_path() -> str:
    with open(_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"librandblas_host-{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """The library's path in ``_BUILD_DIR`` (the package's ``_build/``),
    compiled there first if it is missing; None if no variant compiles.
    The compile holds an exclusive lock on the directory's lock file and
    publishes the library with one ``os.replace``."""
    global build_seconds
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "librandblas_host.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):      # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            for cxx, flags in _variants():
                try:
                    subprocess.run([cxx, *flags, "-shared", "-o", tmp,
                                    _SOURCE], check=True,
                                   capture_output=True, timeout=120)
                except (OSError, subprocess.SubprocessError):
                    continue
                os.replace(tmp, path)
                build_seconds = time.perf_counter() - t0
                return path
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = build()
        if path is None:              # no variant compiled
            return None
        lib = ctypes.CDLL(path)
    except OSError:                   # no source, or a bad load
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.rbt_philox4x32.argtypes = [u32p, u32p, ctypes.c_int,
                                   ctypes.c_int64, u32p]
    lib.rbt_threefry4x32.argtypes = [u32p, u32p, ctypes.c_int,
                                     ctypes.c_int64, u32p]
    lib.rbt_fill_rowmajor.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p, ctypes.c_int, f32p]
    lib.rbt_fill_rowmajor_g.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, u32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.rbt_fisher_yates.argtypes = [
        u32p, u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i64p, f32p]
    lib.rbt_fisher_yates_g.argtypes = [
        u32p, u32p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i64p, f32p]
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.rbt_cbrng64.argtypes = [ctypes.c_int, u64p, u64p, ctypes.c_int,
                                ctypes.c_int64, u64p]
    lib.rbt_fill_rowmajor64_g.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, u64p, u64p, ctypes.c_int, f64p]
    _LIB = lib
    return _LIB


_RNG_IDS = {"philox4x32": 0, "threefry4x32": 1}


def _rng_id(rng: str) -> int:
    if rng not in _RNG_IDS:
        raise ValueError(f"native engine: unsupported rng {rng!r}")
    return _RNG_IDS[rng]


def _pad_key(key: np.ndarray, rng: str) -> np.ndarray:
    """Threefry reads 4 key words; pad shorter keys with zeros."""
    key = np.ascontiguousarray(key, dtype=np.uint32)
    need = 4 if rng == "threefry4x32" else 2
    if key.shape[0] < need:
        key = np.concatenate(
            [key, np.zeros(need - key.shape[0], np.uint32)])
    return key


def available() -> bool:
    """Whether the native library is built and loaded (one build attempt
    per process)."""
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: no C++ compiler "
                           "built native/randblas_host.cpp")
    return lib


def philox4x32(ctrs: np.ndarray, key: np.ndarray,
               rounds: int = 10) -> np.ndarray:
    """Raw Philox blocks for uint32 counters of shape (n, 4)."""
    lib = _lib()
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint32).reshape(-1, 4)
    key = np.ascontiguousarray(key, dtype=np.uint32)
    out = np.empty_like(ctrs)
    lib.rbt_philox4x32(ctrs, key, rounds, ctrs.shape[0], out)
    return out


def threefry4x32(ctrs: np.ndarray, key: np.ndarray,
                 rounds: int = 20) -> np.ndarray:
    """Raw Threefry4x32 blocks for uint32 counters of shape (n, 4)."""
    lib = _lib()
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint32).reshape(-1, 4)
    key = _pad_key(key, "threefry4x32")
    out = np.empty_like(ctrs)
    lib.rbt_threefry4x32(ctrs, key, rounds, ctrs.shape[0], out)
    return out


_CBRNG64 = {"philox2x64": (0, 2, 1), "philox4x64": (1, 4, 2),
            "threefry2x64": (2, 2, 2), "threefry4x64": (3, 4, 4)}


def cbrng64(name: str, ctrs: np.ndarray, key: np.ndarray,
            rounds: int) -> np.ndarray:
    """Raw 64-bit CBRNG blocks. name: philox2x64 | philox4x64 |
    threefry2x64 | threefry4x64; ctrs: uint64 of shape (n, width)."""
    lib = _lib()
    gen, width, key_words = _CBRNG64[name]
    ctrs = np.ascontiguousarray(ctrs, dtype=np.uint64).reshape(-1, width)
    key = np.ascontiguousarray(key, dtype=np.uint64)
    if key.shape[0] < key_words:
        raise ValueError(f"{name} needs {key_words} key words")
    out = np.empty_like(ctrs)
    lib.rbt_cbrng64(gen, ctrs, key, rounds, ctrs.shape[0], out)
    return out


def fill_rowmajor(n_cols_parent: int, n_srows: int, n_scols: int,
                  ptr: int, ctr: np.ndarray, key: np.ndarray,
                  gaussian: bool, rng: str = "philox4x32") -> np.ndarray:
    lib = _lib()
    ctr = np.ascontiguousarray(ctr, dtype=np.uint32)
    key = _pad_key(key, rng)
    out = np.empty((n_srows, n_scols), dtype=np.float32)
    lib.rbt_fill_rowmajor_g(n_cols_parent, n_srows, n_scols, ptr, ctr,
                            key, _rng_id(rng), int(gaussian), out)
    return out


def fill_rowmajor64(n_cols_parent: int, n_srows: int, n_scols: int,
                    ptr: int, ctr: np.ndarray, key: np.ndarray,
                    gaussian: bool, rng: str = "philox4x64") -> np.ndarray:
    """Native-float64 counter-addressed fill through the x64 CBRNGs, the
    engine of rng/x64.py::fill_rowmajor64 in C++ (Uniform bitwise, Gaussian
    within 1 ulp: libm's sin/cos/log against numpy's). ctr/key are uint64
    word arrays."""
    lib = _lib()
    gen, width, key_words = _CBRNG64[rng]
    ctr = np.ascontiguousarray(ctr, dtype=np.uint64)
    key = np.ascontiguousarray(key, dtype=np.uint64)
    if ctr.shape[0] != width or key.shape[0] < key_words:
        raise ValueError(f"{rng} needs {width} counter and {key_words} key "
                         "words")
    out = np.empty((n_srows, n_scols), dtype=np.float64)
    lib.rbt_fill_rowmajor64_g(gen, n_cols_parent, n_srows, n_scols, ptr,
                              ctr, key, int(gaussian), out)
    return out


def fisher_yates(ctr: np.ndarray, key: np.ndarray, vec_nnz: int,
                 dim_major: int, dim_minor: int,
                 rng: str = "philox4x32"):
    lib = _lib()
    ctr = np.ascontiguousarray(ctr, dtype=np.uint32)
    key = _pad_key(key, rng)
    idxs = np.empty((dim_minor, vec_nnz), dtype=np.int64)
    vals = np.empty((dim_minor, vec_nnz), dtype=np.float32)
    lib.rbt_fisher_yates_g(ctr, key, _rng_id(rng), vec_nnz, dim_major,
                           dim_minor, idxs.reshape(-1), vals.reshape(-1))
    return idxs, vals
