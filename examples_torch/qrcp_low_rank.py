"""Sketch-based QRCP low-rank approximation on the PyTorch/CUDA port
(counterpart of examples/qrcp_low_rank.py; reference: examples/
sparse-low-rank-approx/qrcp_matrixmarket.cc:220-283).

Power iteration with sketch-orthogonalize stabilization, then column-
pivoted QR on the small sketch to reveal a rank-k column subset. Reads a
MatrixMarket file if given (like the reference), otherwise generates the
JAX example's synthetic sparse matrix from the same numpy seed.

Run: python examples_torch/qrcp_low_rank.py [path.mtx] [k] [--cpu]
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
from randblas_tpu_torch.linalg import sketch_qrcp             # noqa: E402
from randblas_tpu_torch.sparse_data import COOMatrix          # noqa: E402

STABILIZERS = ("qr", "cholqr", "lu", "none")
DENSE_CHECK_MAX = 2 ** 24   # entries of A up to which the error is exact


def synthetic(m=3000, n=1200, r=12, per_vec=40, seed=0):
    """Sparse low-rank: a sum of r outer products of sparse vectors plus
    sparse noise (keeps A sparse AND approximately rank-r), dense numpy."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), dtype=np.float32)
    for t in range(r):
        u = np.zeros(m, np.float32)
        v = np.zeros(n, np.float32)
        u[rng.choice(m, per_vec, replace=False)] = rng.normal(size=per_vec)
        v[rng.choice(n, per_vec, replace=False)] = rng.normal(size=per_vec)
        dense += (10.0 - 0.5 * t) * np.outer(u, v)
    mask = rng.random(size=(m, n)) < 2e-4
    dense += 0.01 * rng.normal(size=(m, n)).astype(np.float32) * mask
    return dense


def load_matrix(path=None, device=None):
    if path:
        from scipy.io import mmread
        sp = mmread(path).tocoo()
        return COOMatrix.from_arrays(sp.shape[0], sp.shape[1], sp.row,
                                     sp.col, sp.data.astype(np.float32),
                                     device=device)
    return COOMatrix.from_dense(synthetic(), device=device)


def run(path=None, k=16, power_iters=2, device=None):
    """{"a", "q", "b", "piv", "rel" (||A - QB||_F / ||A||_F, None past
    DENSE_CHECK_MAX entries), "seconds", "study": {stabilizer: (rel,
    pivots)}, "call": the timed sketch_qrcp} — the library call with its default stabilizer, then the
    reference example's stabilizer study (quality only)."""
    dev = default_device(device)
    a = load_matrix(path, device=dev)

    def call():
        return sketch_qrcp(a, k, RNGState.from_key(7),
                           power_iters=power_iters)

    (q, b, piv), sec = timed(call, a.vals)
    dense = a.to_dense() if a.n_rows * a.n_cols <= DENSE_CHECK_MAX else None

    def rel_err(q, b):
        if dense is None:
            return None
        return float(torch.linalg.norm(dense - q @ b)
                     / torch.linalg.norm(dense))

    study = {}
    for stab in STABILIZERS:
        qs, bs, ps = sketch_qrcp(a, k, RNGState.from_key(7),
                                 power_iters=power_iters, stabilizer=stab)
        study[stab] = (rel_err(qs, bs), ps)
    return {"a": a, "q": q, "b": b, "piv": piv, "rel": rel_err(q, b),
            "seconds": sec, "study": study, "call": call}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", nargs="?", default=None)
    p.add_argument("k", type=int, nargs="?", default=16)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(args.path, args.k, device="cpu" if args.cpu else None)
    a = r["a"]
    print(f"A: {a.n_rows}x{a.n_cols}, nnz={a.nnz}")
    print(f"sketch-QRCP (k={args.k}): {r['seconds']:.3f}s")
    print("leading pivot columns:", r["piv"][:8].tolist())
    if r["rel"] is not None:
        print(f"rank-{args.k} relative Frobenius error: {r['rel']:.4f}")
    print(f"\nstabilizer study (k={args.k}, power_iters=2):")
    for stab, (rel, piv) in r["study"].items():
        err = "not computed" if rel is None else f"{rel:.5f}"
        print(f"  {stab:7s}: rel err {err}, pivots {piv[:4].tolist()}")


if __name__ == "__main__":
    main()
