"""Low-rank SVD of a MatrixMarket-file sparse matrix via power iteration,
on the PyTorch/CUDA port (counterpart of examples/svd_matrixmarket.py).

End-to-end counterpart of the reference's sparse-low-rank-approx examples
(qrcp_matrixmarket.cc:220-283, svd_matrixmarket.cc): load a .mtx file into
an ELL container, run a power-iteration rangefinder with a choice of
stabilization method (LU / QR / sketch-orthogonalize / none — the same
menu as the reference's StabilizationMethod enum), then a QB -> SVD
finish, and compare the stabilizers' achieved accuracy.

Run:  python examples_torch/svd_matrixmarket.py [--cpu] [path/to/file.mtx]
A demo matrix (rank ~20 plus noise; the same file the JAX example writes
for the same arguments) is generated into examples_torch/data/ if no path
is given. Needs scipy (for MatrixMarket parsing).
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import randblas_tpu_torch as rb                               # noqa: E402
from examples_torch._common import timed         # noqa: E402
from randblas_tpu_torch.dense import default_device   # noqa: E402
from randblas_tpu_torch.io import (                           # noqa: E402
    load_matrix_market, save_matrix_market)
from randblas_tpu_torch.linalg.qb import safe_svd              # noqa: E402
from randblas_tpu_torch.sparse_data import (                  # noqa: E402
    COOMatrix, left_spmm, right_spmm)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def demo_mtx(path, m=2000, n=1500, rank=20, density=0.05, seed=0):
    """Sparse matrix with genuine low-rank structure: a product of sparse
    factors (rank <= `rank`, decaying spectrum) plus faint sparse noise —
    the same flavor as the reference demo's rank-1-plus-noise data
    (svd_rank1_plus_noise.cc)."""
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(m, rank)) *
         (rng.random(size=(m, rank)) < density)).astype(np.float32)
    v = (rng.normal(size=(rank, n)) *
         (rng.random(size=(rank, n)) < density)).astype(np.float32)
    low = (u * (0.7 ** np.arange(rank))) @ v
    noise = (1e-5 * rng.normal(size=(m, n)) *
             (rng.random(size=(m, n)) < 0.001)).astype(np.float32)
    dense = low + noise
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # float32 values, as the JAX example stores them
    save_matrix_market(path, COOMatrix.from_dense(dense.astype(np.float32),
                                                  device="cpu"))
    return path


# -- stabilizers (qrcp_matrixmarket.cc lu_row_stabilize /
#    qr_row_stabilize / sketch_orthogonalize_rows) ----------------------

def stab_qr(y, _key):
    """Row-orthonormalize via QR of y^T (Householder LQ analog)."""
    q, _ = torch.linalg.qr(y.T)
    return q.T


def stab_lu(y, _key):
    """LU row stabilization: U rows of the LU factorization, scaled to
    unit diagonal (lu_row_stabilize). The small k x n factorization runs on
    the host: the panel can be exactly rank-deficient (3 zero pivots at
    k = 32 on the demo file), where LAPACK completes U with zero pivots but
    cuSOLVER's getrf on an H100 returned non-finite factors."""
    _, _, u = torch.linalg.lu(y.cpu())
    k = y.shape[0]
    u = u[:k].to(y.device)
    d = torch.diagonal(u)[:, None]
    return u / torch.where(d.abs() > 0, d, torch.ones_like(d))


def stab_sketch(y, key):
    """Sketch-orthogonalize rows: LQ of a sketched row space, then
    triangular solve (sketch_orthogonalize_rows)."""
    k, n = y.shape
    d_s = int(1.25 * k + 1)
    S = rb.DenseSkOp(rb.DenseDist(n, d_s), rb.RNGState.from_key(key))
    m_sk = rb.sketch_general(S, y, side="right")        # (k, d_s)
    _, r = torch.linalg.qr(m_sk.T)                      # m_sk = r^T q^T
    return torch.linalg.solve_triangular(r.T, y, upper=False)


STABILIZERS = {"qr": stab_qr, "lu": stab_lu, "sketch": stab_sketch,
               "none": lambda y, _k: y}


def power_iter_row_sketch(A, k, p, state, stabilizer="qr"):
    """Y = S A with p data-aware passes over A, row-stabilized between
    passes (power_iter_col_sketch, qrcp_matrixmarket.cc:220-283)."""
    stab = STABILIZERS[stabilizer]
    m, n = A.shape
    S = rb.DenseSkOp(rb.DenseDist(k, m), state)
    y = rb.sketch_sparse(S, A, side="left")              # (k, n)
    for i in range(p):
        y = stab(y, i)
        # alternate row spaces: y A^T (k, m) then back (k, n)
        z = left_spmm(A, y.T).T
        z = stab(z, 2 * i + 1)
        y = right_spmm(z, A)
    return y


def qb_svd(A, k, p, state, stabilizer="qr"):
    y = power_iter_row_sketch(A, k, p, state, stabilizer)    # (k, n)
    q, _ = torch.linalg.qr(y.T)                              # (n, k)
    b = left_spmm(A, q)                                      # (m, k)
    # the library's thin SVD: cuSOLVER's float32 Jacobi SVD does not
    # converge on this rank-deficient b (rank 20 < k = 32) on an H100
    ub, s, vt = safe_svd(b)
    return ub[:, :k], s[:k], (vt[:k] @ q.T)


def run(path=None, k=32, p=2, device=None):
    """{"path", "A" (ELL), "nnz", "best" (the exact rank-k error),
    "runs": {stabilizer: {"s", "err", "seconds", "call"}}}; errors
    relative in the Frobenius norm, "call" the timed qb_svd."""
    dev = default_device(device)
    path = path or demo_mtx(os.path.join(DATA, "sparse_rank20.mtx"))
    A = load_matrix_market(path, format="ell", device=dev)
    dense = A.to_dense()
    norm = torch.linalg.norm(dense)
    runs = {}
    for stab in STABILIZERS:
        def call(stab=stab):
            return qb_svd(A, k, p, rb.RNGState.from_key(7), stab)

        (u, s, vt), sec = timed(call, A.vals)
        err = float(torch.linalg.norm(dense - (u * s) @ vt) / norm)
        runs[stab] = {"s": s, "err": err, "seconds": sec, "call": call}
    sv = torch.linalg.svdvals(dense.double())
    best = float(torch.sqrt((sv[k:] ** 2).sum()) / norm)
    return {"path": path, "A": A, "nnz": A.nnz, "best": best, "runs": runs}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", nargs="?", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    dev = "cpu" if args.cpu else None
    r = run(args.path, device=dev)
    A = r["A"]
    print(f"loaded {r['path']} (device: {A.vals.device})")
    print(f"A: {A.shape[0]}x{A.shape[1]}, nnz={r['nnz']}")
    for stab, res in r["runs"].items():
        print(f"stabilizer = {stab}")
        print(f"  total {res['seconds']:.4f} s; rel fro error of rank-32 "
              f"approx: {res['err']:.3e}")
    print(f"optimal rank-32 rel error (exact SVD): {r['best']:.3e}")


if __name__ == "__main__":
    main()
