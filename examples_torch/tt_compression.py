"""Tensor-train compression of a discretized multivariate function, on the
PyTorch/CUDA port (counterpart of examples/tt_compression.py).

The 4-way Hilbert-like tensor  X[i,j,k,l] = 1 / (1 + i + j + k + l)
(n = 48 per mode, 5.3M entries) has rapidly decaying TT spectrum — the
classic example of a function tensor that is LOW-RANK in the TT format
while having no useful low-rank structure in any single matricization of
moderate aspect ratio.

Pipeline shown:
  1. ``tt_from_dense``: randomized TT-SVD at a rank budget — storage
     drops from n^4 to ~4 n r^2 while the relative error tracks the
     TT spectrum's decay.
  2. TT arithmetic + ``tt_round``: form  Y = X + 0.5 X  exactly (ranks
     double), then round back down with the Randomize-then-Orthogonalize
     sweep.
  3. Error certificates against the dense truth at this toy size.

Run: python examples_torch/tt_compression.py [n] [--cpu]
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
    tt_add, tt_from_dense, tt_norm, tt_round, tt_scale,
)

RANKS = (2, 4, 8, 12)
ROUND_RANK = 8


def hilbert(n=48, p=4):
    idx = np.arange(n)
    grids = np.meshgrid(*([idx] * p), indexing="ij")
    return (1.0 / (1.0 + sum(grids))).astype(np.float32)


def run(n=48, p=4, device=None):
    """{"size", "compress": {rank: (rel err, storage, seconds)},
    "sum_ranks", "rounded_ranks", "round_err", "tt_norm", "dense_norm",
    "call": the timed tt_from_dense at ROUND_RANK}:
    the compressions, then 1.5 X as tt_add(X, 0.5 X) rounded back to
    ROUND_RANK (errors relative in the Frobenius norm)."""
    dev = default_device(device)
    x = torch.from_numpy(hilbert(n, p)).to(dev)
    xn = float(torch.linalg.norm(x))
    st = RNGState.from_key(5)
    compress = {}
    for rank in RANKS:
        start = st
        (tt, st), sec = timed(
            lambda: tt_from_dense(x, rank, start, power_iters=2), x)
        err = float(torch.linalg.norm(tt.full() - x)) / xn
        store = sum(g.numel() for g in tt.cores)
        compress[rank] = (err, store, sec)

    # arithmetic + rounding: Y = 1.5 X with ranks doubled, then rounded
    tt, st = tt_from_dense(x, ROUND_RANK, st, power_iters=2)
    y = tt_add(tt, tt_scale(tt, 0.5))
    r, st = tt_round(y, ROUND_RANK, st)
    err = float(torch.linalg.norm(r.full() - 1.5 * x)) / (1.5 * xn)
    return {"size": x.numel(), "compress": compress, "sum_ranks": y.ranks,
            "rounded_ranks": r.ranks, "round_err": err,
            "tt_norm": float(tt_norm(r)), "dense_norm": 1.5 * xn,
            "call": lambda: tt_from_dense(x, ROUND_RANK, RNGState.from_key(5),
                                          power_iters=2)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="?", default=48)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(args.n, device="cpu" if args.cpu else None)
    size = r["size"]
    print(f"X: {(args.n,) * 4} = {size:,} entries "
          f"({size * 4 / 2 ** 20:.1f} MiB dense)")
    for rank, (err, store, sec) in r["compress"].items():
        print(f"  rank {rank:3d}: rel err {err:.2e}, storage {store:,} "
              f"({store / size:.2%} of dense, {sec:.2f}s)")
    print(f"\ntt_add ranks: {r['sum_ranks']} (exact sum, ranks add)")
    print(f"tt_round back to {r['rounded_ranks']}: rel err "
          f"{r['round_err']:.2e}")
    print(f"norm check: tt_norm={r['tt_norm']:.4f} "
          f"dense={r['dense_norm']:.4f}")
    if not r["round_err"] < 1e-3:
        raise SystemExit("rounding lost the sum")
    print("ok: TT pipeline compresses, adds, and rounds within the "
          "TT spectrum's decay")


if __name__ == "__main__":
    main()
