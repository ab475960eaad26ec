#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (randblas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``randblas_tpu_torch/csrc`` with nvcc, checks
the fill kernel K3 and the fused sketch kernels K1 and K2 against their
plain PyTorch versions on the card, and drives these paths through the
public entry points, each with the launch counts set to 0 just before it
and read just after:

- the main path, a left sketch by a wide Gaussian operator, which launches
  K1 once and K3 never:

    sketch_general(DenseSkOp(DenseDist(1024, 65536), RNGState.from_key(0)),
                   A, side="left")          # A: (65536, 4096) float32

- (a) its backward pass, ``B.backward(G)`` with G (1024, 4096): K1 once
  forward, K2 once backward;
- (b) the adjoint ``sketch_general(S, Y, op_s="T")``, Y (1024, 4096): the
  left-Trans route through K2 once, output (65536, 4096);
- (c) the wide+Short (ColMajor-natural) operator at the main shape: the
  left ColMajor route through K2 once;
- (d) the right sketch of benchmarks/run_all.py config 2, A2 (16384, 16384)
  by a Uniform DenseDist(16392, 1032) at d=1024, ro_s=co_s=8: the right
  route through K1 once (the autotranspose identity);

and the staged route with ``use_kernel_fill``, which launches K3 once and
no fused kernel. Then it times each kernel, its plain version, the bf16
``torch.matmul`` of the pre-materialised operator (a yardstick the port
never calls) and the paths with CUDA events. The line before the last is a
JSON object listing K1, K2 and K3; the last line is {"ok": true,
"device": {...}}. Any failed check raises, so the exit code is non-zero
and no result line is printed. Without a CUDA device it exits non-zero
before running anything. It imports nothing of JAX.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

D, M, N = 1024, 65536, 4096          # the main path's shape
R2, C2, D2 = 16384, 16384, 1024      # run_all.py config 2: A2 (R2, C2), d
K1_REL_TOL = 1e-3    # K1/K2 vs their plain versions: both round the
                     # operands to bf16 and sum in float32, in another order
BF16_REL_TOL = 1e-2  # bf16 output: one bf16 ulp of the output (2^-8)
STAGED_REL_TOL = 2e-2  # bf16-operand product vs the float32 staged route
                       # (the JAX suite's fused-vs-materialized bound)
GAUSS_ABS_TOL = 1e-4   # K3 Gaussian vs the plain fill: libm ulps on |x| < 7
F32_REL_TOL = 1e-5     # the staged backward of a square dist: float32 fill
                       # and product, the same arithmetic as its reference
PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s at 700 W (data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(*cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


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


def bound(flops, nbytes):
    """(least ms, what bounds it): the operations at the bf16 tensor-core
    peak against each input byte read once and each output byte written
    once at the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


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
    kernel = None
    for line in (_build.build_log or "").splitlines():
        name = re.search(r"(fused_sketch_T_kernel|fused_sketch_kernel|"
                         r"fill_block_kernel)I(.+?)EEv", line)
        if name:
            kernel = f"{name.group(1)}[{name.group(2)}]"
        elif "registers" in line or "spill" in line:
            print("  ptxas:", kernel, line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    counters = {"K1": fs.fused_sketch, "K2": fs.fused_sketch_colmajor,
                "K3": fs.fill_block}

    def reset():
        for c in counters.values():
            c.launches = 0
        skge.route_counts.clear()

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    def drive(name, fn, expect):
        """Run one path with the counts at 0, and check its launches."""
        reset()
        out = fn()
        got = counts()
        print(f"{name}: routes {dict(skge.route_counts)}, launches {got}")
        check(got == expect, f"{name}: launches {got}, expected {expect}")
        return out, got

    # -- phase 3: K3 against the plain fill, element by element ----------
    def op(dims, family="Gaussian", key=0, rng="philox4x32", state=None,
           major="Long"):
        dist = rt.DenseDist(*dims, rt.DenseDistName[family],
                            rt.MajorAxis[major])
        return rt.DenseSkOp(dist, state or rt.RNGState.from_key(key, rng))

    def transposed(S):
        d = S.dist
        return rt.DenseSkOp(rt.DenseDist(d.n_cols, d.n_rows, d.family,
                                         d.major_axis), S.seed_state)

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
    B, main_launches = drive(
        "main path", lambda: rt.sketch_general(S, A, side="left"),
        {"K1": 1, "K2": 0, "K3": 0})
    check(B.shape == (D, N) and B.dtype == torch.float32,
          f"B is {tuple(B.shape)} {B.dtype}")
    check(bool(torch.isfinite(B).all()), "B has non-finite values")

    def staged_fill():
        with rt.flags(use_fused=False, use_kernel_fill=True):
            return rt.sketch_general(S, A, side="left")

    # off the main path: the staged route with the kernel fill (K3), through
    # the same entry point
    B_staged, staged_launches = drive(
        "staged route with use_kernel_fill", staged_fill,
        {"K1": 0, "K2": 0, "K3": 1})

    B_ref = fs.fused_sketch_reference(S, A)
    torch.cuda.synchronize()
    k1_abs = abs_err(B, B_ref)
    k1_rel = rel_err(B, B_ref)
    check(k1_rel <= K1_REL_TOL, f"K1 vs plain: rel err {k1_rel}")
    print(f"K1 vs plain at {D}x{M}@{M}x{N}: max abs err {k1_abs:.4g}, "
          f"normalised {k1_rel:.3g} <= {K1_REL_TOL}")
    staged_rel = rel_err(B, B_staged)
    check(staged_rel <= STAGED_REL_TOL, f"K1 vs staged: {staged_rel}")
    print(f"K1 vs the float32 staged route: normalised {staged_rel:.3g} "
          f"<= {STAGED_REL_TOL}")
    del B_staged, B_ref

    def case(kname, name, S_c, A_c, kw, tol, reference):
        n_before = counters[kname].launches
        got = rt.sketch_general(S_c, A_c, side="left", **kw)
        kw_ref = {("rows_s" if k == "d" else k): v for k, v in kw.items()}
        kw_ref["cols_s"] = A_c.shape[0]
        want = reference(S_c, A_c, **kw_ref)
        torch.cuda.synchronize()
        check(counters[kname].launches == n_before + 1,
              f"{kname} {name}: not launched")
        check(got.shape == want.shape and got.dtype == A_c.dtype,
              f"{kname} {name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{kname} {name}: non-finite")
        err = rel_err(got, want)
        check(err <= tol, f"{kname} {name}: rel err {err}")
        print(f"{kname} {name}: normalised err {err:.3g} <= {tol}")

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
        case("K1", name, S_c, A_c, kw, tol, fs.fused_sketch_reference)

    # -- phase 5: the paths of K2 and the right route, at full width -----
    G = torch.from_numpy(
        np.random.default_rng(1).standard_normal((D, N), dtype=np.float32)
    ).to(dev)
    S_t = transposed(S)        # DenseDist(65536, 1024): ColMajor-natural

    def backward():
        A.requires_grad_(True)
        rt.sketch_general(S, A, side="left").backward(G)
        return A.grad

    grad, grad_launches = drive("(a) backward of the main path", backward,
                                {"K1": 1, "K2": 1, "K3": 0})
    A.requires_grad_(False)
    A.grad = None
    grad_ref = fs.fused_sketch_colmajor_reference(S_t, G)
    torch.cuda.synchronize()
    check(grad.shape == (M, N), f"(a) A.grad is {tuple(grad.shape)}")
    check(bool(torch.isfinite(grad).all()), "(a) A.grad has non-finite values")
    k2_abs = abs_err(grad, grad_ref)
    k2_rel = rel_err(grad, grad_ref)
    check(k2_rel <= K1_REL_TOL, f"(a) A.grad vs plain K2: {k2_rel}")
    print(f"(a) A.grad vs plain K2 on the transposed dist: max abs err "
          f"{k2_abs:.4g}, normalised {k2_rel:.3g} <= {K1_REL_TOL}")

    adj, _ = drive("(b) adjoint S^T Y",
                   lambda: rt.sketch_general(S, G, op_s="T"),
                   {"K1": 0, "K2": 1, "K3": 0})
    check(skge.route_counts == {"left_trans_fused": 1},
          f"(b) routes {dict(skge.route_counts)}")
    check(adj.shape == (M, N), f"(b) output {tuple(adj.shape)}")
    check(torch.equal(adj, grad), "(b) adjoint differs from (a)'s A.grad")
    print("(b) adjoint S^T Y equals (a)'s A.grad bit for bit (same K2 call)")
    del grad, grad_ref, adj

    S_c = op((D, M), major="Short")
    Bc, _ = drive("(c) wide+Short ColMajor forward",
                  lambda: rt.sketch_general(S_c, A),
                  {"K1": 0, "K2": 1, "K3": 0})
    check(skge.route_counts == {"left_colmajor_fused": 1},
          f"(c) routes {dict(skge.route_counts)}")
    c_rel = rel_err(Bc, fs.fused_sketch_colmajor_reference(S_c, A))
    check(Bc.shape == (D, N) and c_rel <= K1_REL_TOL, f"(c) rel err {c_rel}")
    print(f"(c) K2 vs plain: normalised {c_rel:.3g} <= {K1_REL_TOL}")
    del Bc

    A2 = torch.from_numpy(
        np.random.default_rng(2).standard_normal((R2, C2), dtype=np.float32)
    ).to(dev)
    S2 = op((C2 + 8, D2 + 8), "Uniform", 3)   # tall+Long: ColMajor-natural

    def right():
        return rt.sketch_general(S2, A2, side="right", d=D2, ro_s=8, co_s=8)

    B2, _ = drive("(d) right sketch, run_all.py config 2", right,
                  {"K1": 1, "K2": 0, "K3": 0})
    check(skge.route_counts == {"right_fused": 1},
          f"(d) routes {dict(skge.route_counts)}")
    B2_ref = fs.fused_sketch_reference(transposed(S2), A2.T, rows_s=D2,
                                       cols_s=C2, ro_s=8, co_s=8).T
    d_rel = rel_err(B2, B2_ref)
    check(B2.shape == (R2, D2) and d_rel <= K1_REL_TOL, f"(d) rel {d_rel}")
    print(f"(d) right route vs plain K1 on the transposed dist: normalised "
          f"{d_rel:.3g} <= {K1_REL_TOL}")
    del B2, B2_ref

    wrap_t = op((M, D), state=wrap)
    k2_cases = [
        ("ragged d=1000 n=4000 ro_s=5 co_s=3", S_c,
         A[:60000, :4000].contiguous(), dict(d=1000, ro_s=5, co_s=3),
         K1_REL_TOL),
        ("unaligned ro_s=3, backward shape", S_t, G[:1000, :1000].contiguous(),
         dict(d=60000, ro_s=3, co_s=24), K1_REL_TOL),
        ("threefry uniform alpha=0.5",
         op((8192, 256), "Uniform", 7, "threefry4x32"),
         A[:256, :300].contiguous(), dict(alpha=0.5), K1_REL_TOL),
        ("bf16 data", S_c, A[:, :512].to(torch.bfloat16), {}, BF16_REL_TOL),
        ("offset > 2^32", op((2 ** 20, 2 ** 15), key=8),
         A[:1024, :256].contiguous(),
         dict(d=256, ro_s=2 ** 20 - 300, co_s=2 ** 15 - 1030), K1_REL_TOL),
        ("counter wrap", wrap_t, G[:, :256].contiguous(), dict(d=6000),
         K1_REL_TOL),
    ]
    for name, S_k, A_k, kw, tol in k2_cases:
        case("K2", name, S_k, A_k, kw, tol,
             fs.fused_sketch_colmajor_reference)

    # a square dist transposes to itself: its backward pass is staged
    S_sq = op((2048, 2048), key=9)            # square+Long: ColMajor
    A_sq = A[:2048, :512].clone().requires_grad_(True)
    G_sq = G[:, :512].repeat(2, 1).contiguous()
    drive("square dist forward (K2) and staged backward",
          lambda: rt.sketch_general(S_sq, A_sq).backward(G_sq),
          {"K1": 0, "K2": 1, "K3": 0})
    sq_ref = S_sq.materialize(device=dev).T @ G_sq
    sq_rel = rel_err(A_sq.grad, sq_ref)
    check(sq_rel <= F32_REL_TOL, f"square backward: rel err {sq_rel}")
    print(f"square dist backward vs the filled block's float32 product: "
          f"normalised {sq_rel:.3g} <= {F32_REL_TOL}")
    del A_sq, G_sq, sq_ref

    # -- phase 6: times at the paths' shapes -------------------------------
    flops = 2.0 * D * M * N
    main_ms = time_ms(lambda: rt.sketch_general(S, A, side="left"))
    k1_ms = time_ms(lambda: fs.fused_sketch(S, A))
    plain_ms = time_ms(lambda: fs.fused_sketch_reference(S, A), reps=3)
    S_bf = S.materialize(device=dev).to(torch.bfloat16)
    A_bf = A.to(torch.bfloat16)
    k1_lib_ms = time_ms(lambda: torch.matmul(S_bf, A_bf))
    del S_bf

    def staged():
        with rt.flags(use_fused=False):
            return rt.sketch_general(S, A, side="left")

    staged_ms = time_ms(staged, reps=3)

    k2_ms = time_ms(lambda: fs.fused_sketch_colmajor(S_t, G))
    k2_plain_ms = time_ms(lambda: fs.fused_sketch_colmajor_reference(S_t, G),
                          reps=3)
    St_bf = S_t.materialize(device=dev).to(torch.bfloat16)
    G_bf = G.to(torch.bfloat16)
    k2_lib_ms = time_ms(lambda: torch.matmul(St_bf, G_bf))
    del St_bf

    def backward_step():
        A.requires_grad_(True)
        rt.sketch_general(S, A, side="left").backward(G)
        A.grad = None

    bwd_ms = time_ms(backward_step, reps=3)
    A.requires_grad_(False)
    adj_ms = time_ms(lambda: rt.sketch_general(S, G, op_s="T"))
    c_ms = time_ms(lambda: rt.sketch_general(S_c, A))
    Sc_bf = S_c.materialize(device=dev).to(torch.bfloat16)
    c_lib_ms = time_ms(lambda: torch.matmul(Sc_bf, A_bf))
    del Sc_bf, A_bf
    d_ms = time_ms(right)
    S2_bf = S2.submat(C2, D2, 8, 8, device=dev).to(torch.bfloat16)
    A2_bf = A2.to(torch.bfloat16)
    d_lib_ms = time_ms(lambda: torch.matmul(A2_bf, S2_bf))
    del S2_bf, A2_bf

    k3_ms = time_ms(lambda: fs.fill_block(S, D, M, device=dev))
    k3_plain_ms = time_ms(
        lambda: fs.fill_block_reference(S, D, M, device=dev), reps=3)
    k3_err = abs_err(fs.fill_block(S, D, M, device=dev),
                     fs.fill_block_reference(S, D, M, device=dev))
    check(k3_err <= GAUSS_ABS_TOL, f"K3 main-shape fill: {k3_err}")

    f32 = 4
    k1_bound = bound(flops, (M * N + D * N) * f32)
    k2_bound = bound(flops, (D * N + M * N) * f32)
    k3_bound = bound(0.0, D * M * f32)
    for name, ms, lib, work in (
            ("main path sketch_general (K1 route)", main_ms, k1_lib_ms, 1),
            ("K1 fused_sketch wrapper", k1_ms, k1_lib_ms, 1),
            ("K1 plain (fill + bf16 round + fp32 matmul)", plain_ms, None, 1),
            ("staged route (plain fill + fp32 matmul)", staged_ms, None, 1),
            ("K2 wrapper at the backward shape 65536x1024@1024x4096", k2_ms,
             k2_lib_ms, 1),
            ("K2 plain at the backward shape", k2_plain_ms, None, 1),
            ("(a) forward + backward of the main path", bwd_ms, None, 2),
            ("(b) adjoint sketch_general(S, Y, op_s='T')", adj_ms,
             k2_lib_ms, 1),
            ("(c) wide+Short sketch_general (K2 route)", c_ms, c_lib_ms, 1),
            ("(d) right sketch, run_all.py config 2 (K1 route)", d_ms,
             d_lib_ms, 1)):
        lib_txt = "" if lib is None else f"; bf16 torch.matmul {lib:.3f} ms"
        print(f"time {name}: {ms:.3f} ms = "
              f"{work * flops / ms / 1e9:.2f} TFLOP/s{lib_txt} [{card}]")
    print(f"time K3 fill_block_kernel {D}x{M}: {k3_ms:.3f} ms; plain fill "
          f"{k3_plain_ms:.3f} ms [{card}]")
    print(f"bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), K3 {k3_bound[0]:.4f} ms "
          f"({k3_bound[1]}), at {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 and "
          f"{PEAK_BYTES / 1e12:.2f} TB/s")

    def entry(name, fn, line, launches, err, ms, plain, bnd, lib):
        return {"name": f"{fn} ({name})", "route": "cuda",
                "source": "randblas_tpu_torch/csrc/fused_sketch.cu",
                "replaces": f"randblas_tpu/ops/fused_sketch.py:{line}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib}

    # launches: K1 on the main path, K2 on its backward pass (a), K3 on the
    # staged use_kernel_fill run
    kernels = [
        entry("K1", "fused_sketch_kernel", 127, main_launches["K1"], k1_abs,
              k1_ms, plain_ms, k1_bound, k1_lib_ms),
        entry("K2", "fused_sketch_T_kernel", 366, grad_launches["K2"],
              k2_abs, k2_ms, k2_plain_ms, k2_bound, k2_lib_ms),
        entry("K3", "fill_block_kernel", 446, staged_launches["K3"], k3_err,
              k3_ms, k3_plain_ms, k3_bound, None),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
