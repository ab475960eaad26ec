"""Randomized low-rank SVD of sparse data via QB on the PyTorch/CUDA port
(counterpart of examples/low_rank_svd.py; reference: examples/
sparse-low-rank-approx/svd_rank1_plus_noise.cc:217-300).

Builds the reference's test matrix — a rank-1 spike plus sparse noise —
and recovers the dominant singular triple with a sketch-based rangefinder.
Up to ``HOST_DRAWS_MAX`` entries the matrix comes from the same numpy
draws as the JAX example (a dense array, then COO); past it the COO is
built directly from the seed: the noise count is Binomial(m n, p), its
positions uniform (duplicates merged), its values N(0, 1), so no dense
copy of A ever exists.

Run: python examples_torch/low_rank_svd.py [m] [n] [--cpu]
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
from randblas_tpu_torch import RNGState                       # noqa: E402
from randblas_tpu_torch.sparse_data import COOMatrix          # noqa: E402
from randblas_tpu_torch.linalg import qb_decompose, qb_to_svd  # noqa: E402

SIGMA = 25.0            # the spike's singular value


def make_problem(m=2000, n=1500, noise_p=1e-3, vec_nnz=32, seed=0,
                 device=None):
    """(A as COO on ``device``, planted u, planted v)."""
    rng = np.random.default_rng(seed)
    # sparse rank-1 spike (the reference plants u, v with vec_nnz nonzeros
    # each via Fisher-Yates, svd_rank1_plus_noise.cc:150-180) + sparse
    # noise with nonzero probability noise_p
    u = np.zeros(m, dtype=np.float32)
    v = np.zeros(n, dtype=np.float32)
    u[rng.choice(m, vec_nnz, replace=False)] = \
        rng.choice([-1.0, 1.0], vec_nnz) / np.sqrt(vec_nnz)
    v[rng.choice(n, vec_nnz, replace=False)] = \
        rng.choice([-1.0, 1.0], vec_nnz) / np.sqrt(vec_nnz)
    if m * n <= HOST_DRAWS_MAX:
        spike = SIGMA * np.outer(u, v).astype(np.float32)
        mask = rng.random(size=(m, n)) < noise_p
        noise = (rng.normal(size=(m, n)) * mask).astype(np.float32)
        return COOMatrix.from_dense(spike + noise, device=device), u, v
    dev = default_device(device)
    su, sv = np.nonzero(u)[0], np.nonzero(v)[0]    # the spike's support
    # the linear positions, unique and sorted (row-major), on the device
    pos = torch.unique(torch.from_numpy(
        rng.integers(0, m * n, size=rng.binomial(m * n, noise_p))).to(dev))
    vals = torch.from_numpy(
        rng.normal(size=pos.numel()).astype(np.float32)).to(dev)
    spike = SIGMA * np.outer(u[su], v[sv]).astype(np.float32)
    pos = torch.cat([pos, torch.from_numpy(
        (su[:, None] * n + sv[None, :]).ravel()).to(dev)])
    vals = torch.cat([vals, torch.from_numpy(spike.ravel()).to(dev)])
    pos, inv = torch.unique(pos, return_inverse=True)
    vals = torch.zeros(pos.numel(), device=dev).index_add_(0, inv, vals)
    return COOMatrix.from_arrays(m, n, pos // n, pos % n, vals,
                                 device=dev), u, v


def run(m=2000, n=1500, noise_p=1e-3, k=8, power_iters=2, seed=0,
        device=None):
    """QB -> SVD of rank k: {"a", "u", "v" (planted), "s" (k singular
    values), "u_hat", "vt_hat", "sigma1_rel_err", "cos_u", "cos_v",
    "nnz", "seconds", "call": the timed QB -> SVD}."""
    dev = default_device(device)
    a, u, v = make_problem(m, n, noise_p, seed=seed, device=dev)

    def qb_svd():
        q, b = qb_decompose(a, k, RNGState.from_key(3),
                            power_iters=power_iters)
        return qb_to_svd(q, b)

    (u_hat, s_hat, vt_hat), sec = timed(qb_svd, a.vals)
    u_t = torch.from_numpy(u).to(dev)
    v_t = torch.from_numpy(v).to(dev)
    return {"a": a, "u": u, "v": v, "s": s_hat, "u_hat": u_hat,
            "vt_hat": vt_hat, "nnz": a.nnz, "seconds": sec, "call": qb_svd,
            "sigma1_rel_err": abs(float(s_hat[0]) - SIGMA) / SIGMA,
            "cos_u": abs(float(u_hat[:, 0] @ u_t)),
            "cos_v": abs(float(vt_hat[0] @ v_t))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("m", type=int, nargs="?", default=2000)
    p.add_argument("n", type=int, nargs="?", default=1500)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    m, n = args.m, args.n
    r = run(m, n, device="cpu" if args.cpu else None)
    print(f"A: {m}x{n}, nnz={r['nnz']} ({r['nnz'] / (m * n):.2%} dense)")
    print(f"QB->SVD (k={r['s'].numel()}): {r['seconds']:.3f}s")
    print("top singular values:", r["s"][:4].cpu().numpy().round(3))
    print(f"sigma1 rel err: {r['sigma1_rel_err']:.2e}; |cos(u)| "
          f"{r['cos_u']:.6f}, |cos(v)| {r['cos_v']:.6f}")


if __name__ == "__main__":
    main()
