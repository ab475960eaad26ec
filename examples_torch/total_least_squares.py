"""Sketch-and-solve total least squares on the PyTorch/CUDA port
(counterpart of examples/total_least_squares.py; reference: examples/
total-least-squares/tls_dense_skop.cc:101-203 and tls_sparse_skop.cc).

Generates a noisy errors-in-variables regression problem (m=10000, n=500,
d=2(n+1) — the reference's default scale) from the same numpy seed as the
JAX example, solves it classically and by dense-Gaussian, sparse-sign and
SRHT sketching, and reports timing and accuracy.

Run: python examples_torch/total_least_squares.py [m] [n] [--cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from examples_torch._common import (                        # noqa: E402
    HOST_DRAWS_MAX, timed)
from randblas_tpu_torch.dense import default_device   # noqa: E402
from randblas_tpu_torch import (                              # noqa: E402
    DenseDist, DenseSkOp, RNGState, SparseDist, SparseSkOp, TrigDist,
    TrigSkOp,
)
from randblas_tpu_torch.linalg import sketched_tls, tls_via_svd  # noqa: E402

# the sketches of the example: name -> operator of d x m
OPERATORS = {
    "dense": lambda d, m: DenseSkOp(DenseDist(d, m), RNGState.from_key(1)),
    # SASO with vec_nnz=8 (tls_sparse_skop.cc:146)
    "saso": lambda d, m: SparseSkOp(SparseDist(d, m, vec_nnz=8),
                                    RNGState.from_key(2)),
    # SRHT (no reference analog): O(mn log m) apply, independent of d
    "srht": lambda d, m: TrigSkOp(TrigDist(d, m), RNGState.from_key(3)),
}


def make_problem(m, n, seed=0):
    rng = np.random.default_rng(seed)
    x_true = rng.normal(size=(n,)).astype(np.float32)
    a_true = rng.normal(size=(m, n)).astype(np.float32)
    b_true = a_true @ x_true
    noise = 0.05
    a = a_true + noise * rng.normal(size=(m, n)).astype(np.float32)
    b = b_true + noise * rng.normal(size=(m,)).astype(np.float32)
    return np.hstack([a, b[:, None]]), x_true


def make_problem_on(device, m, n, seed=0):
    """The same distribution as ``make_problem``, drawn on ``device``:
    ([A b] (m, n+1) float32, x_true)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x_true = torch.randn(n, generator=g, device=device)
    ab = torch.empty((m, n + 1), device=device)
    a = ab[:, :n]
    a.normal_(generator=g)
    ab[:, n] = a @ x_true
    noise = 0.05
    a.add_(torch.randn(m, n, generator=g, device=device), alpha=noise)
    ab[:, n].add_(torch.randn(m, generator=g, device=device), alpha=noise)
    return ab, x_true


def run(m=10000, n=500, seed=0, device=None):
    """The classical TLS solution and one sketched solution an operator of
    OPERATORS, each with its relative error against the planted
    ``x_true`` and its time: {"ab", "x_true", "d", "x": {name: x}, "err":
    {...}, "seconds": {...}, "call": the dense sketch's solve} with name
    "classical" for the SVD of [A b]."""
    dev = default_device(device)
    d = 2 * (n + 1)
    if m * (n + 1) <= HOST_DRAWS_MAX:
        ab_np, x_true = make_problem(m, n, seed)
        ab = torch.from_numpy(ab_np).to(dev)
        xt = torch.from_numpy(x_true).to(dev)
        del ab_np
    else:
        ab, xt = make_problem_on(dev, m, n, seed)
    solvers = {"classical": lambda: tls_via_svd(ab)}
    for name, make in OPERATORS.items():
        S = make(d, m)
        solvers[name] = lambda S=S: sketched_tls(S, ab)
    out = {"ab": ab, "x_true": xt, "d": d, "x": {}, "err": {},
           "seconds": {}, "call": solvers.get("dense")}
    for name, solve in solvers.items():
        x, sec = timed(solve, ab)
        out["x"][name] = x
        out["err"][name] = float(torch.linalg.norm(x - xt)
                                 / torch.linalg.norm(xt))
        out["seconds"][name] = sec
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int, nargs="?", default=10000)
    p.add_argument("n", type=int, nargs="?", default=500)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(args.m, args.n, device="cpu" if args.cpu else None)
    t_c, sec = r["seconds"]["classical"], r["seconds"]
    print(f"classical TLS: {t_c:.3f}s, rel err {r['err']['classical']:.4f}")
    labels = {"dense": f"dense-sketch TLS (d={r['d']})",
              "saso": "SASO-sketch TLS (vec_nnz=8)",
              "srht": f"SRHT-sketch TLS (d={r['d']})"}
    for name, label in labels.items():
        print(f"{label}: {sec[name]:.3f}s, rel err {r['err'][name]:.4f}, "
              f"speedup {t_c / sec[name]:.1f}x")


if __name__ == "__main__":
    main()
