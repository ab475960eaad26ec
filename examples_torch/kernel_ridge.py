"""Kernel ridge regression with a Nystrom-preconditioned CG solve, on the
PyTorch/CUDA port (counterpart of examples/kernel_ridge.py).

The production-shaped consumer of nystrom_pcg (Frangella-Tropp-Udell
2021's headline application): fit f(x) = sum_i alpha_i k(x_i, x) by
solving the n x n SPD system (K + n*mu*I) alpha = y. The kernel matrix
is dense and ill-conditioned; one rank-d Nystrom sketch of K (d matvecs,
riding the framework's sketching dispatch) buys a preconditioner that
makes CG converge in a spectrum-independent handful of iterations. K is
built ``BLOCK`` rows at a time, so no (n, n, dim) temporary exists.

Run: python examples_torch/kernel_ridge.py [n] [--cpu]
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
from randblas_tpu_torch.linalg import nystrom_pcg             # noqa: E402

BLOCK = 1024   # rows of K built at a time


def rbf_kernel(x1, x2, bandwidth):
    """exp(-||x1_i - x2_j||^2 / (2 bw^2)), BLOCK rows of x1 at a time."""
    out = torch.empty((x1.shape[0], x2.shape[0]), dtype=x1.dtype,
                      device=x1.device)
    for i in range(0, x1.shape[0], BLOCK):
        d2 = ((x1[i:i + BLOCK, None, :] - x2[None, :, :]) ** 2).sum(-1)
        out[i:i + BLOCK] = torch.exp(-d2 / (2.0 * bandwidth ** 2))
    return out


def target(z):
    return np.sin(3 * z[:, 0]) * np.cos(2 * z[:, 1]) + 0.5 * z[:, 2]


def run(n=3000, n_test=500, dim=4, d=200, seed=0, device=None):
    """{"alpha", "iters", "res" (||(K + n mu I) alpha - y||), "res_rel"
    (over ||y||), "rmse" (test error against the noiseless target; noise
    floor 0.05), "seconds", "call": the timed nystrom_pcg}."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    x_test = rng.uniform(-1, 1, (n_test, dim)).astype(np.float32)
    y = (target(x) + 0.05 * rng.normal(size=n)).astype(np.float32)

    bandwidth, mu = 0.5, 1e-4
    xt = torch.from_numpy(x).to(dev)
    yt = torch.from_numpy(y).to(dev)
    k_mat = rbf_kernel(xt, xt, bandwidth)

    def call():
        return nystrom_pcg(k_mat, yt, RNGState.from_key(1), d=d, mu=n * mu,
                           tol=1e-6)

    (alpha, iters, _), sec = timed(call, k_mat)
    k_test = rbf_kernel(torch.from_numpy(x_test).to(dev), xt, bandwidth)
    pred = (k_test @ alpha).cpu().numpy()
    rmse = float(np.sqrt(np.mean((pred - target(x_test)) ** 2)))
    res = float(torch.linalg.norm(k_mat @ alpha + n * mu * alpha - yt))
    return {"alpha": alpha, "iters": int(iters), "res": res,
            "res_rel": res / float(torch.linalg.norm(yt)), "rmse": rmse,
            "seconds": sec, "call": call}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=3000)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(args.n, device="cpu" if args.cpu else None)
    print(f"kernel ridge: n={args.n}, d=200 Nystrom sketch, "
          f"{r['iters']} CG iterations, {r['seconds']:.2f}s")
    print(f"  system residual {r['res']:.2e}, test RMSE {r['rmse']:.4f} "
          "(noise floor 0.05)")


if __name__ == "__main__":
    main()
