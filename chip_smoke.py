#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (randblas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``randblas_tpu_torch/csrc`` with nvcc, checks
the fill kernel K3 and the fused sketch kernel K1 against their plain
PyTorch versions on the card, drives the main path

    sketch_general(DenseSkOp(DenseDist(1024, 65536), RNGState.from_key(0)),
                   A, side="left")          # A: (65536, 4096) float32

once through the public entry point, checks that it launched K1 and not
K3, and times that call, K1's wrapper, its plain version, the staged route
and K3 with CUDA events. The line before the last is a JSON object
describing the main path's kernel (K3 is off that path and is reported on
an earlier line); the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the exit code is
non-zero and no result line is printed. Without a CUDA device it exits
non-zero before running anything. It imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

D, M, N = 1024, 65536, 4096          # the main path's shape
K1_REL_TOL = 1e-3    # K1 vs its plain version: both round the operands to
                     # bf16 and sum in float32, in another order
BF16_REL_TOL = 1e-2  # bf16 output: one bf16 ulp of the output (2^-8)
STAGED_REL_TOL = 2e-2  # bf16-operand product vs the float32 staged route
                       # (the JAX suite's fused-vs-materialized bound)
GAUSS_ABS_TOL = 1e-4   # K3 Gaussian vs the plain fill: libm ulps on |x| < 7


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def time_ms(fn, reps=5, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import fused_sketch as fs

    dev = torch.device("cuda")
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]
    # -- phase 1: the machine ----------------------------------------------
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(sh(_build._nvcc(), "--version").splitlines()[-1])

    # -- phase 2: build the kernels from the checkout's sources -----------
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds or 0.0:.1f} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 3: K3 against the plain fill, element by element ----------
    def op(dims, family="Gaussian", key=0, rng="philox4x32", state=None,
           major="Long"):
        dist = rt.DenseDist(*dims, rt.DenseDistName[family],
                            rt.MajorAxis[major])
        return rt.DenseSkOp(dist, state or rt.RNGState.from_key(key, rng))

    wrap = rt.RNGState.from_arrays([0xFFFFFFF0, 0xFFFFFFFF, 0xFFFFFFFF, 0],
                                   [5, 0])
    far_ro, far_co = 2 ** 15 - 8, 2 ** 20 - 1001   # row offset * stride > 2^33
    k3_cases = [
        ("uniform", op((D, M), "Uniform", 1), (1000, 3000, 7, 5)),
        ("gaussian", op((D, M), key=2), (1000, 3000, 7, 5)),
        ("unaligned co_s", op((D, M), key=3), (64, 4001, 0, 3)),
        ("colmajor natural", op((3000, 500), key=4), (2999, 400, 1, 7)),
        ("threefry", op((D, M), "Uniform", 5, "threefry4x32"),
         (100, 999, 3, 2)),
        ("offset > 2^32 uniform", op((2 ** 15, 2 ** 20), "Uniform", 6),
         (8, 1000, far_ro, far_co)),
        ("offset > 2^32 gaussian", op((2 ** 15, 2 ** 20), key=6),
         (8, 1000, far_ro, far_co)),
        ("counter wrap uniform", op((D, M), "Uniform", state=wrap),
         (16, 4096, 0, 0)),
        ("counter wrap gaussian", op((D, M), state=wrap), (16, 4096, 0, 0)),
    ]
    for name, S, (r, c, ro, co) in k3_cases:
        got = fs.fill_block(S, r, c, ro, co, device=dev)
        want = fs.fill_block_reference(S, r, c, ro, co, device=dev)
        torch.cuda.synchronize()
        check(got.shape == (r, c), f"K3 {name}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        err = (got - want).abs().max().item()
        if S.dist.family == rt.DenseDistName.Uniform:
            check(torch.equal(got, want), f"K3 {name}: not bitwise ({err})")
            print(f"K3 {name}: bitwise equal ({r}x{c} at {ro},{co})")
        else:
            check(err <= GAUSS_ABS_TOL, f"K3 {name}: max abs err {err}")
            print(f"K3 {name}: max abs err {err:.3g} <= {GAUSS_ABS_TOL} "
                  f"({r}x{c} at {ro},{co}; bitwise: "
                  f"{torch.equal(got, want)})")

    # -- phase 4: the main path through the public entry point -----------
    S = op((D, M))
    A = torch.from_numpy(
        np.random.default_rng(0).standard_normal((M, N), dtype=np.float32)
    ).to(dev)
    fs.fused_sketch.launches = 0
    fs.fill_block.launches = 0
    skge.route_counts.clear()
    B = rt.sketch_general(S, A, side="left")
    torch.cuda.synchronize()
    launches = {"K1": fs.fused_sketch.launches, "K3": fs.fill_block.launches}
    print(f"main path: routes {dict(skge.route_counts)}, "
          f"launches {launches}")
    check(launches == {"K1": 1, "K3": 0}, f"main path launches {launches}")
    check(B.shape == (D, N) and B.dtype == torch.float32,
          f"B is {tuple(B.shape)} {B.dtype}")
    check(bool(torch.isfinite(B).all()), "B has non-finite values")
    # off the main path: the staged route with the kernel fill (K3), through
    # the same entry point, counted on its own
    fs.fused_sketch.launches = 0
    fs.fill_block.launches = 0
    skge.route_counts.clear()
    with rt.flags(use_fused=False, use_kernel_fill=True):
        B_staged = rt.sketch_general(S, A, side="left")
    torch.cuda.synchronize()
    staged_launches = {"K1": fs.fused_sketch.launches,
                       "K3": fs.fill_block.launches}
    print(f"staged route with use_kernel_fill: routes "
          f"{dict(skge.route_counts)}, launches {staged_launches}")
    check(staged_launches == {"K1": 0, "K3": 1},
          f"staged route launches {staged_launches}")

    B_ref = fs.fused_sketch_reference(S, A)
    torch.cuda.synchronize()
    k1_abs = (B - B_ref).abs().max().item()
    k1_rel = rel_err(B, B_ref)
    check(k1_rel <= K1_REL_TOL, f"K1 vs plain: rel err {k1_rel}")
    print(f"K1 vs plain at {D}x{M}@{M}x{N}: max abs err {k1_abs:.4g}, "
          f"normalised {k1_rel:.3g} <= {K1_REL_TOL}")
    staged_rel = rel_err(B, B_staged)
    check(staged_rel <= STAGED_REL_TOL, f"K1 vs staged: {staged_rel}")
    print(f"K1 vs the float32 staged route: normalised {staged_rel:.3g} "
          f"<= {STAGED_REL_TOL}")

    k1_cases = [
        ("ragged d=1000 n=4000 co_s=3", S, A[:60000, :4000].contiguous(),
         dict(d=1000, ro_s=5, co_s=3), K1_REL_TOL),
        ("bf16 data", S, A[:, :512].to(torch.bfloat16), {}, BF16_REL_TOL),
        ("threefry uniform alpha=0.5",
         op((256, 8192), "Uniform", 7, "threefry4x32"),
         A[:8192, :300].contiguous(), dict(alpha=0.5), K1_REL_TOL),
        ("offset > 2^32", op((2 ** 15, 2 ** 20), key=8),
         A[:4096, :256].contiguous(),
         dict(d=64, ro_s=2 ** 15 - 64, co_s=2 ** 20 - 4097), K1_REL_TOL),
        ("counter wrap", op((D, M), state=wrap), A[:4096, :256].contiguous(),
         dict(d=200), K1_REL_TOL),
    ]
    for name, S_c, A_c, kw, tol in k1_cases:
        n_before = fs.fused_sketch.launches
        got = rt.sketch_general(S_c, A_c, side="left", **kw)
        kw_ref = {("rows_s" if k == "d" else k): v for k, v in kw.items()}
        kw_ref["cols_s"] = A_c.shape[0]
        want = fs.fused_sketch_reference(S_c, A_c, **kw_ref)
        torch.cuda.synchronize()
        check(fs.fused_sketch.launches == n_before + 1,
              f"K1 {name}: not launched")
        check(got.shape == want.shape and got.dtype == A_c.dtype,
              f"K1 {name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()), f"K1 {name}: non-finite")
        err = rel_err(got, want)
        check(err <= tol, f"K1 {name}: rel err {err}")
        print(f"K1 {name}: normalised err {err:.3g} <= {tol}")

    # -- phase 5: times at the main-path shape ----------------------------
    flops = 2.0 * D * M * N
    main_ms = time_ms(lambda: rt.sketch_general(S, A, side="left"))
    k1_ms = time_ms(lambda: fs.fused_sketch(S, A))
    plain_ms = time_ms(lambda: fs.fused_sketch_reference(S, A), reps=3)

    def staged():
        with rt.flags(use_fused=False):
            return rt.sketch_general(S, A, side="left")

    staged_ms = time_ms(staged, reps=3)
    k3_ms = time_ms(lambda: fs.fill_block(S, D, M, device=dev))
    k3_plain_ms = time_ms(
        lambda: fs.fill_block_reference(S, D, M, device=dev), reps=3)
    k3_err = (fs.fill_block(S, D, M, device=dev)
              - fs.fill_block_reference(S, D, M, device=dev)).abs().max()
    k3_err = k3_err.item()
    check(k3_err <= GAUSS_ABS_TOL, f"K3 main-shape fill: {k3_err}")
    for name, ms in (("main path sketch_general (fused route)", main_ms),
                     ("K1 fused_sketch wrapper", k1_ms),
                     ("K1 plain (fill + bf16 round + fp32 matmul)", plain_ms),
                     ("staged route (plain fill + fp32 matmul)", staged_ms)):
        print(f"time {name}: {ms:.3f} ms = {flops / ms / 1e9:.2f} TFLOP/s "
              f"[{card}]")
    print(f"time K3 fill_block_kernel {D}x{M}: {k3_ms:.3f} ms; plain fill "
          f"{k3_plain_ms:.3f} ms [{card}]")
    # K3 is off the main path (launches 0 there), so the kernels line below
    # lists the path's kernel only; K3's own check and times are above
    print("K3 fill_block_kernel (randblas_tpu_torch/csrc/fused_sketch.cu, "
          "replaces randblas_tpu/ops/fused_sketch.py:446): launches "
          f"{staged_launches['K3']} on the staged route with use_kernel_fill,"
          f" max abs err {k3_err:.3g}, {k3_ms:.3f} ms, plain {k3_plain_ms:.3f}"
          " ms")

    kernels = [
        {"name": "fused_sketch_kernel (K1)", "route": "cuda",
         "source": "randblas_tpu_torch/csrc/fused_sketch.cu",
         "replaces": "randblas_tpu/ops/fused_sketch.py:127",
         "launches": launches["K1"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": plain_ms},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
