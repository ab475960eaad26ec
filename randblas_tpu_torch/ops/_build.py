"""Build the CUDA kernels with nvcc and bind them with ctypes.

The kernels' sources are ``csrc/*.cu``: ``fused_sketch.cu`` (K1, K2, K3),
``saso_sketch.cu`` (K4), ``ell_spmm.cu`` (K5), ``x64_fill.cu`` (K6) and
``saso_fill.cu`` (K7, which includes ``csrc/random123.cuh``). Each has a
plain C interface (no PyTorch headers), so nvcc builds it in seconds. The
sources compile in parallel, one nvcc per source, and link into one
library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o _build/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/librandblas_kernels.so _build/*.o

The library goes to ``randblas_tpu_torch/_build/`` (listed in .gitignore),
keyed on a hash of the sources, the headers and the flags, and is built at
first use: a process that never launches a kernel never needs nvcc. nvcc is
looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then under
``/usr/local/cuda``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "librandblas_kernels.so"
_STAMP = BUILD_DIR / "librandblas_kernels.sha256"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# nvcc's output of this process's build (ptxas registers, shared memory and
# spills per kernel), and its wall time in seconds; None when the library
# was already built
build_log = None
build_seconds = None

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of randblas_tpu_torch are built "
        "from csrc/ with the CUDA toolkit for sm_90a (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _run_all(cmds):
    """Run the commands at once; (exit codes, outputs) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs


def _ensure_built() -> Path:
    global build_log, build_seconds
    digest = _digest()
    if LIBRARY.is_file() and _STAMP.is_file() \
            and _STAMP.read_text().strip() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"librandblas_kernels.{pid}.tmp.so"
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(SOURCES, objs)]
    link = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        codes, outs = _run_all(compiles)
        if not any(codes):
            (code,), (out,) = _run_all([link])
            codes, outs, compiles = codes + [code], outs + [out], \
                compiles + [link]
        build_seconds = time.perf_counter() - t0
        build_log = "".join(outs)
        for code, cmd, out in zip(codes, compiles, outs):
            if code != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed (exit {code}): {' '.join(cmd)}\n{out}")
        os.replace(tmp, LIBRARY)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    _STAMP.write_text(digest + "\n")
    return LIBRARY


def _bind(lib):
    c_void_p, c_int, c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    words = ctypes.POINTER(ctypes.c_uint32)
    plan = ctypes.POINTER(ctypes.c_int32)
    lib.rbt_fused_sketch.argtypes = [
        c_void_p, c_int, c_int64, c_int64, c_void_p, c_void_p, c_int64,
        c_int64, c_int64, ctypes.c_uint64, words, c_int, c_int,
        ctypes.c_float, plan, c_void_p]
    lib.rbt_fused_sketch.restype = c_int
    lib.rbt_fused_sketch_T.argtypes = [
        c_void_p, c_int, c_int64, c_int64, c_void_p, c_void_p, c_int64,
        c_int64, c_int64, c_int, ctypes.c_uint64, words, c_int, c_int,
        ctypes.c_float, plan, c_void_p]
    lib.rbt_fused_sketch_T.restype = c_int
    lib.rbt_fused_max_clusters.argtypes = [c_int, ctypes.POINTER(c_int)]
    lib.rbt_fused_max_clusters.restype = c_int
    lib.rbt_fill_block.argtypes = [
        c_void_p, c_int64, c_int64, c_int, ctypes.c_uint64, ctypes.c_uint64,
        words, c_int, c_int, c_int, c_int, c_int, c_void_p]
    lib.rbt_fill_block.restype = c_int
    lib.rbt_saso_sketch.argtypes = [
        c_void_p, c_int, c_int64, c_int64, c_void_p, c_void_p, c_int,
        c_void_p, c_void_p, c_int64, c_int64, c_int64, ctypes.c_float, plan,
        c_void_p]
    lib.rbt_saso_sketch.restype = c_int
    lib.rbt_saso_max_ctas.argtypes = [ctypes.POINTER(c_int)]
    lib.rbt_saso_max_ctas.restype = c_int
    lib.rbt_ell_spmm.argtypes = [
        c_void_p, c_void_p, c_int64, c_int64, c_int, c_int, c_void_p,
        c_int64, c_int64, c_void_p, c_int64, c_int64, c_int, c_int64,
        ctypes.c_float, c_void_p]
    lib.rbt_ell_spmm.restype = c_int
    lib.rbt_fill_block64.argtypes = [
        c_void_p, c_int64, c_int64, c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), c_int, c_int, c_int, c_void_p]
    lib.rbt_fill_block64.restype = c_int
    lib.rbt_saso_fill.argtypes = [
        c_void_p, c_void_p, c_void_p, c_void_p, c_int64, c_int64, c_int64,
        words, c_int, c_int, c_int, ctypes.c_uint64, ctypes.c_uint64,
        c_void_p]
    lib.rbt_saso_fill.restype = c_int
    lib.rbt_error_string.argtypes = [c_int]
    lib.rbt_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The bound kernel library, built from the package's source if the
    build directory holds none for this source."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_ensure_built())))
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = _lib.rbt_error_string(code).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
