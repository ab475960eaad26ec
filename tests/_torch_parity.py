"""The parity helpers shared by the port's test files: the same inputs
through the JAX package and the port, compared in numpy.

- ``to_np``: a JAX array, a torch tensor (CPU or CUDA, DTensors
  gathered), a list or a number as a numpy array;
- ``rel``: ||got - want|| / ||want|| in float64 (the 2-norm of the
  flattened arrays; 0 when both are 0);
- ``assert_rel``: ``rel(got, want) <= tol`` with both values in the
  message;
- ``states``: one seed as a JAX ``RNGState`` and the port's, from the same
  words;
- ``jax_example``: a module of ``examples/`` loaded by its path (the JAX
  examples are scripts, not a package).
"""

import importlib.util
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def to_np(x):
    full = getattr(x, "full_tensor", None)
    if full is not None:
        x = full()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel(got, want) -> float:
    got = to_np(got).astype(np.float64).ravel()
    want = to_np(want).astype(np.float64).ravel()
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return float(num / den) if den else float(num)


def assert_rel(got, want, tol, what=""):
    err = rel(got, want)
    assert err <= tol, f"{what}: relative error {err:.3g} > {tol}"


def states(key, rng="philox4x32"):
    """(JAX RNGState, port RNGState) of ``RNGState.from_key(key, rng)``."""
    import randblas_tpu as rb
    import randblas_tpu_torch as rt
    j = rb.RNGState.from_key(key, rng=rng)
    return j, rt.RNGState.from_dict(j.to_dict())


def jax_example(name):
    """examples/<name>.py as a module (its imports and module-level code
    run; its main() does not)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
