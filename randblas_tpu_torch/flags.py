"""Scoped overrides for the port's dispatch flags (counterpart of
randblas_tpu/flags.py).

The flags: ``use_fused`` ("auto" / True / False), ``use_kernel_fill``
(False / True) and ``use_saso_kernel`` ("auto" / True / False) live in
``randblas_tpu_torch.skge``; ``auto_blocked_ell`` ("auto" / True / False) in
``randblas_tpu_torch.sparse_data.spmm``. ``flags(...)`` scopes an override
and restores it on exit::

    with randblas_tpu_torch.flags(use_fused=False):
        B = randblas_tpu_torch.sketch(S, A)      # staged fill + GEMM
"""

from __future__ import annotations

import contextlib
import importlib

_FLAG_HOMES = {
    "use_fused": "randblas_tpu_torch.skge",
    "use_kernel_fill": "randblas_tpu_torch.skge",
    "use_saso_kernel": "randblas_tpu_torch.skge",
    "auto_blocked_ell": "randblas_tpu_torch.sparse_data.spmm",
}


def _home(name: str):
    try:
        return importlib.import_module(_FLAG_HOMES[name])
    except KeyError:
        raise ValueError(
            f"unknown randblas_tpu_torch flag {name!r}; known flags: "
            f"{sorted(_FLAG_HOMES)}") from None


def get_flag(name: str):
    """Current value of a dispatch flag."""
    return getattr(_home(name), name)


def set_flag(name: str, value) -> None:
    """Set a dispatch flag globally (prefer the `flags` context)."""
    setattr(_home(name), name, value)


@contextlib.contextmanager
def flags(**overrides):
    """Context manager scoping dispatch-flag overrides; values are restored
    on exit even if the body raises."""
    saved = {name: get_flag(name) for name in overrides}
    try:
        for name, value in overrides.items():
            set_flag(name, value)
        yield
    finally:
        for name, value in saved.items():
            set_flag(name, value)
