"""Sketch-and-precondition least squares (Blendenpik/LSRN-style) on the
PyTorch/CUDA port (counterpart of examples/sketch_precondition_lsq.py).

The other classic RandNLA workload next to sketch-and-solve
(total_least_squares.py): for a tall overdetermined min ||A x - b||,
sketch A down to d ~ 2n rows with a SASO, take the QR of the sketch, and
use its R factor as a RIGHT preconditioner for CGLS on the FULL problem.
The sketch guarantees cond(A R^-1) = O(1) with high probability, so CGLS
converges in a few dozen iterations independent of cond(A), and the
answer is exact to solver tolerance (unlike sketch-and-solve, which is
only delta-accurate). Float64 throughout: with cond(A) ~ 1e8 the R^-1
amplification sits at the float32 noise floor. CGLS here is a host loop
over device products (the JAX example's is a lax.while_loop under jit).

Run: python examples_torch/sketch_precondition_lsq.py [m] [n] [--cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import timed         # noqa: E402
from randblas_tpu_torch.dense import default_device   # noqa: E402
from randblas_tpu_torch import RNGState                       # noqa: E402
from randblas_tpu_torch.linalg import (                       # noqa: E402
    cgls, ihs_lsq, sketch_and_precondition,
)

IHS_STEPS = 40


def make_problem(m=20000, n=400, cond=1e8, seed=0, device=None):
    """(A (m, n) float64 with singular values logspaced from 1 to 1/cond,
    b = A x_true + 1e-6 noise, x_true), on ``device``."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, n)))
    v, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = np.logspace(0, -np.log10(cond), n)
    A = torch.from_numpy((u * sv) @ v.T).to(device)
    x_true = torch.from_numpy(rng.normal(size=(n,))).to(device)
    b = A @ x_true + 1e-6 * torch.from_numpy(rng.normal(size=(m,))).to(device)
    return A, b, x_true


def solve_preconditioned(A, b, seed=0, vec_nnz=8, d=None):
    """min ||A x - b|| via SASO sketch -> QR -> right-preconditioned CGLS
    (library call: randblas_tpu_torch.linalg.sketch_and_precondition).
    Returns (x, cgls_iterations)."""
    x, iters, _ = sketch_and_precondition(
        A, b, RNGState.from_key(seed), d=d, vec_nnz=vec_nnz, tol=1e-12,
        maxiter=200)
    return x, iters


def run(m=20000, n=400, cond=1e8, seed=0, device=None):
    """{"A", "b", "x_true", "x", "iters", "x_plain", "iters_plain",
    "x_ihs", "res", "res_plain", "res_ihs", "res_true", "seconds",
    "seconds_ihs", "call": the timed preconditioned solve}: the
    preconditioned CGLS, plain CGLS (same tolerance
    and budget) and IHS with heavy-ball momentum (IHS_STEPS fixed steps)."""
    dev = default_device(device)
    A, b, x_true = make_problem(m, n, cond, seed, dev)
    def call():
        return solve_preconditioned(A, b)

    (x, iters), t_pre = timed(call, A)
    x_plain, iters_plain, _ = cgls(lambda y: A @ y, lambda r: A.T @ r, b, n)
    # iterative Hessian sketch with heavy-ball momentum: the Krylov-free
    # alternative — one sketch, a FIXED number of damped Newton steps at
    # the deterministic sqrt(n/d) rate (no convergence monitoring)
    x_ihs, t_ihs = timed(lambda: ihs_lsq(A, b, RNGState.from_key(1),
                                         iters=IHS_STEPS)[0], A)

    def res(y):
        return float(torch.linalg.norm(A @ y - b))

    return {"A": A, "b": b, "x_true": x_true, "x": x, "iters": int(iters),
            "x_plain": x_plain, "iters_plain": int(iters_plain),
            "x_ihs": x_ihs, "res": res(x), "res_plain": res(x_plain),
            "res_ihs": res(x_ihs), "res_true": res(x_true),
            "seconds": t_pre, "seconds_ihs": t_ihs, "call": call}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int, nargs="?", default=20000)
    p.add_argument("n", type=int, nargs="?", default=400)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    cond = 1e8
    r = run(args.m, args.n, cond, device="cpu" if args.cpu else None)
    print(f"cond(A) ~ {cond:.0e}, shape {args.m}x{args.n}")
    print(f"preconditioned CGLS:   {r['iters']:4d} iters, "
          f"residual {r['res']:.3e}  ({r['seconds'] * 1e3:.1f} ms/solve)")
    print(f"plain CGLS:            {r['iters_plain']:4d} iters, "
          f"residual {r['res_plain']:.3e}")
    print(f"IHS heavy-ball:        {IHS_STEPS:4d} steps, "
          f"residual {r['res_ihs']:.3e}  ({r['seconds_ihs'] * 1e3:.1f} "
          "ms/solve)")
    print(f"ground-truth residual: {r['res_true']:.3e}")


if __name__ == "__main__":
    main()
