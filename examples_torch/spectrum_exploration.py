"""Spectrum exploration before committing a rank/shift budget, on the
PyTorch/CUDA port (counterpart of examples/spectrum_exploration.py).

The workflow the DOS tier exists for (no reference analog — the
reference ships sampling primitives, util.hh:173-334, not estimators):

1. estimate the eigenvalue DENSITY of a symmetric operator from block
   matvecs only (SLQ and KPM routes),
2. COUNT the eigenvalues in candidate intervals (eig_count) to size a
   rank budget,
3. verify the chosen rank with an actual partial eigendecomposition,
4. stream the matrix's rows through FrequentDirections and check its
   deterministic a-posteriori certificate against the truth (float64).

Run: python examples_torch/spectrum_exploration.py [n] [--cpu]
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
    FrequentDirections, eig_count, kpm_density, rand_eigh,
    spectral_density,
)

SPIKES = 12        # planted eigenvalues around 6.0
ELL = 64           # FrequentDirections' rows
ROWS = 256         # rows a FrequentDirections update


def make_problem(n=2048, seed=0):
    """A symmetric float32 (n, n) with a SPIKES-eigenvalue signal cluster
    around 6.0 on top of a noise bulk in [-1, 1] (a spiked model)."""
    rng = np.random.default_rng(seed)
    lam = np.concatenate([6.0 + 0.05 * rng.standard_normal(SPIKES),
                          np.sort(rng.uniform(-1, 1, n - SPIKES))])
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * lam) @ q.T).astype(np.float32), lam


def _integral(dens, grid):
    return float(torch.trapezoid(dens.double(), grid.double()))


def run(n=2048, seed=0, device=None):
    """{"lam" (planted), "slq": (grid, dens), "kpm": (grid, dens),
    "slq_integral", "kpm_integral", "count", "k", "w" (rand_eigh's
    eigenvalues), "fd_true", "fd_cert", "fd_worst", "seconds", "call":
    the timed spectral_density}."""
    dev = default_device(device)
    a_np, lam = make_problem(n, seed)
    a = torch.from_numpy(a_np).to(dev)
    del a_np

    def call():
        return spectral_density(a, RNGState.from_key(7), probes=8, steps=48)

    (grid, dens, st), sec = timed(call, a)
    gridk, densk, st = kpm_density(a, st, degree=128, probes=8,
                                   bounds=(-1.5, 6.5))
    # how big is the spike cluster? (interval endpoints in the gap)
    count, st = eig_count(a, 4.0, 7.0, st, probes=48, steps=64)
    k = int(round(float(count)))
    w, _ = rand_eigh(a, k, st)

    # stream the rows; FD certifies its own covariance error
    fd = FrequentDirections(n, ell=ELL, device=dev)
    for i in range(0, n, ROWS):
        fd.update(a[i:i + ROWS])
    b = fd.sketch().double()
    a64 = a.double()
    # the 2-norm of the symmetric error matrix, in float64
    true_err = float(torch.linalg.eigvalsh(a64.T @ a64 - b.T @ b).abs().max())
    return {"lam": lam, "slq": (grid, dens), "kpm": (gridk, densk),
            "slq_integral": _integral(dens, grid),
            "kpm_integral": _integral(densk, gridk),
            "count": float(count), "k": k, "w": w, "fd_true": true_err,
            "fd_cert": float(fd.shrink_mass),
            "fd_worst": float(torch.linalg.norm(a64) ** 2 / ELL),
            "seconds": sec, "call": call}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2048)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(args.n, device="cpu" if args.cpu else None)
    print(f"SLQ density ({r['seconds']:.2f}s): integral = "
          f"{r['slq_integral']:.0f} (n = {args.n})")
    print(f"KPM density integral = {r['kpm_integral']:.0f}")
    print(f"eig_count[4, 7] = {r['count']:.2f} -> rank budget k = {r['k']}")
    print("recovered spike eigenvalues:",
          np.sort(r["w"].cpu().numpy())[::-1][:4].round(3), "...")
    print(f"FrequentDirections: true covariance error {r['fd_true']:.1f} "
          f"<= certificate {r['fd_cert']:.1f} <= worst-case "
          f"{r['fd_worst']:.1f}")


if __name__ == "__main__":
    main()
