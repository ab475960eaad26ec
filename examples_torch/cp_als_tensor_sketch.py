"""Randomized CP tensor decomposition on the PyTorch/CUDA port: ALS with
TensorSketch-compressed least squares (counterpart of
examples/cp_als_tensor_sketch.py; the CPRAND idea of
Battaglino-Ballard-Kolda 2018).

CP-ALS fits X ~= sum_r a_r o b_r o c_r by cycling least-squares solves

    min_A || X_(1) - A (B (kr) C)^T ||_F

whose design matrix is the Khatri-Rao product Z = B (kr) C with J*K
rows. TensorSketch compresses both sides to d rows WITHOUT forming Z:
S Z comes from ``tensor_sketch([B, C], d, state)`` (FFT-combined
CountSketches) and S X_(1)^T from ``tensor_sketch_explicit``, one
segment-sum over the combined hash/sign pair (``index_add_``). The
sketched normal equations are R x R. Each mode update draws a FRESH
seed-chained sketch (CPRAND's resampling), so the whole decomposition
replays bit-identically from the initial seed. TensorSketch's variance
constant grows as 3^p in the number of modes, so it needs d >> 3^p R^2;
the Kronecker FJLT (CPRAND-MIX) has no such constant and reaches the
exact fit at d = 128.

Run: python examples_torch/cp_als_tensor_sketch.py [--cpu]
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
from randblas_tpu_torch.tensor import (                       # noqa: E402
    kfjlt_sketch, kfjlt_sketch_explicit, tensor_sketch,
    tensor_sketch_explicit,
)


def khatri_rao(b, c):
    """Explicit (J*K, R) Khatri-Rao product, row index j*K + k (the
    exact-ALS oracle; the sketched path never forms this)."""
    j, r = b.shape
    k, _ = c.shape
    return (b[:, None, :] * c[None, :, :]).reshape(j * k, r)


def _ridged(g, ridge):
    return g + ridge * torch.trace(g) * torch.eye(g.shape[0], dtype=g.dtype,
                                                  device=g.device)


def solve_mode(x_unf, kr_factors, d, state, ridge=1e-8, sketch="ts"):
    """One sketched factor update: lstsq of (S Z) A^T = S X_(mode)^T
    through the R x R normal equations. Returns (factor, next_state).
    sketch='ts' uses TensorSketch; 'kfjlt' the Kronecker FJLT."""
    dims = (kr_factors[0].shape[0], kr_factors[1].shape[0])
    struct, explicit = ((tensor_sketch, tensor_sketch_explicit)
                        if sketch == "ts"
                        else (kfjlt_sketch, kfjlt_sketch_explicit))
    sz, nxt = struct(kr_factors, d, state)                  # (d, R)
    sxt, _ = explicit(x_unf.T, dims, d, state)              # (d, I)
    g = _ridged(sz.T @ sz, ridge)
    return torch.linalg.solve(g, sz.T @ sxt).T, nxt


def exact_mode(x_unf, kr_factors, ridge=1e-8):
    z = khatri_rao(*kr_factors)
    g = _ridged(z.T @ z, ridge)
    return torch.linalg.solve(g, z.T @ x_unf.T).T


def normalize(f):
    nrm = torch.linalg.norm(f, dim=0)
    return f / torch.clamp(nrm, min=1e-30), nrm


def fit(x, a, b, c):
    """1 - ||X - [[a, b, c]]||_F / ||X||_F, in float64."""
    x = x.double()
    xh = torch.einsum("ir,jr,kr->ijk", a.double(), b.double(), c.double())
    return float(1.0 - torch.linalg.norm(xh - x) / torch.linalg.norm(x))


def cp_als(x, rank, sweeps, d=None, state=None, sketch="ts"):
    """d=None: exact ALS. d set: sketch-compressed ALS ('ts' or
    'kfjlt')."""
    i_, j_, k_ = x.shape
    x1 = x.reshape(i_, j_ * k_)                          # col j*K + k
    x2 = x.permute(1, 0, 2).reshape(j_, i_ * k_)         # col i*K + k
    x3 = x.permute(2, 0, 1).reshape(k_, i_ * j_)         # col i*J + j
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal((j_, rank)).astype(
        np.float32)).to(x.device)
    c = torch.from_numpy(rng.standard_normal((k_, rank)).astype(
        np.float32)).to(x.device)
    a = None
    for _ in range(sweeps):
        if d is None:
            a = exact_mode(x1, [b, c])
            b = exact_mode(x2, [a, c])
            c = exact_mode(x3, [a, b])
        else:
            a, state = solve_mode(x1, [b, c], d, state, sketch=sketch)
            b, state = solve_mode(x2, [a, c], d, state, sketch=sketch)
            c, state = solve_mode(x3, [a, b], d, state, sketch=sketch)
        # rebalance: unit-norm a, b; c absorbs their weights so the
        # reconstruction a o b o c is unchanged
        a, la = normalize(a)
        b, lb = normalize(b)
        c = c * (la * lb)[None, :]
    return a, b, c


def make_tensor(shape=(100, 150, 150), rank=5, seed=0):
    """A rank-``rank`` tensor plus 1% Gaussian noise, float32 numpy."""
    rng = np.random.default_rng(seed)
    af, bf, cf = (rng.standard_normal((s, rank)) for s in shape)
    x = np.einsum("ir,jr,kr->ijk", af, bf, cf)
    return (x + 0.01 * np.linalg.norm(x) / np.sqrt(x.size)
            * rng.standard_normal(x.shape)).astype(np.float32)


def run(shape=(100, 150, 150), rank=5, sweeps_exact=8, sweeps=10,
        d_ts=4096, d_kf=128, seed=0, device=None):
    """Fits and times of exact ALS, TensorSketch ALS at d_ts, KFJLT ALS
    at d_kf and TensorSketch ALS at d_kf: {"fit": {...}, "seconds": {...},
    "factors": {...}} keyed "exact", "ts", "kfjlt", "ts_small", and
    "call": the TensorSketch ALS at d_ts."""
    dev = default_device(device)
    x = torch.from_numpy(make_tensor(shape, rank, seed)).to(dev)
    runs = {
        "exact": lambda: cp_als(x, rank, sweeps=sweeps_exact),
        "ts": lambda: cp_als(x, rank, sweeps, d=d_ts,
                             state=RNGState.from_key(7)),
        "kfjlt": lambda: cp_als(x, rank, sweeps, d=d_kf,
                                state=RNGState.from_key(7), sketch="kfjlt"),
        "ts_small": lambda: cp_als(x, rank, sweeps, d=d_kf,
                                   state=RNGState.from_key(7), sketch="ts"),
    }
    out = {"fit": {}, "seconds": {}, "factors": {}, "call": runs["ts"]}
    for name, fn in runs.items():
        abc, out["seconds"][name] = timed(fn, x)
        out["factors"][name] = abc
        out["fit"][name] = fit(x, *abc)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device)")
    args = p.parse_args(argv)
    r = run(device="cpu" if args.cpu else None)
    f, t = r["fit"], r["seconds"]
    print(f"exact CP-ALS     : fit {f['exact']:.4f}  ({t['exact']:.2f}s, "
          f"Z is {150 * 150} x 5)")
    print(f"sketched (d=4096): fit {f['ts']:.4f}  ({t['ts']:.2f}s, "
          "SZ is 4096 x 5, Z never formed)")
    print(f"KFJLT    (d= 128): fit {f['kfjlt']:.4f}  ({t['kfjlt']:.2f}s — "
          "no 3^p constant, 32x smaller d; TensorSketch at d=128 "
          f"plateaus at {f['ts_small']:.4f})")
    if not f["ts"] > 0.95 * f["exact"]:
        raise SystemExit("sketched ALS lost the fit")
    if not f["kfjlt"] > 0.95 * f["exact"]:
        raise SystemExit("KFJLT ALS lost the fit at d=128")
    print("ok: TensorSketch ALS matches the exact fit at d << J*K; "
          "KFJLT matches it at d = 128 where TensorSketch plateaus")


if __name__ == "__main__":
    main()
