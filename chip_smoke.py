#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (randblas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``randblas_tpu_torch/csrc`` with nvcc, checks
the fill kernel K3, the fused sketch kernels K1 and K2, the SASO sketch
kernel K4 and the BlockedELL SpMM kernel K5 against their plain PyTorch
versions on the card (K4 and K5 also launched twice on the same inputs and
compared bit for bit), and drives these paths through the public entry
points, each with the launch counts set to 0 just before it and read just
after:

- the main path, a left sketch by a wide Gaussian operator, which launches
  K1 once and no other kernel:

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
- (e) run_all.py config 3: a SASO SparseDist(1024, 65536, vec_nnz=8),
  filled on the card, sketching A3 (65536, 2048) float32 from the left:
  K4 once;
- (e') the transposed full route: a right sketch of A3^T (2048, 65536) by
  the tall SASO SparseDist(65536, 1024, vec_nnz=8): K4 once, on a
  column-major view of the data;
- (f) run_all.py config 4: sketch_sparse of COO data (20000 x 10000, 1e6
  entries) from the left by DenseDist(512, 20000): the COO route, no
  kernel;
- (g) config 4b: the same data as a word-major BlockedELL, sketched from
  the right by DenseDist(10000, 512): K5 once; and the same right sketch
  of the COO data, which reaches K5 once through the cached BlockedELL
  conversion;

and the staged route with ``use_kernel_fill``, which launches K3 once and
no other kernel, and a float32 SASO sketch at d=3000 (past the old d limit
of K4), which takes K4 once. For K1 and K2 it also prints the launch plan
of the main path and of (b) (tiles, thread-block cluster, grid, contraction
splits, how many times the operator is generated, and the card's
cudaOccupancyMaxActiveClusters), K4's plan at (e), whether ``cuobjdump
-sass`` shows HGMMA (wgmma) in every K1, K2 and K4 instantiation, their
cases at the edges of the cluster and the tiles in float32 and bf16 (each
launched twice and compared bit for bit; for K4 also d up to 4096, d < 64,
m < TK, column-major and strided data; for K5 rows with no entry, a full
row, column chunks and natural-order B), path (d)'s peak device memory
beside that of the same call handed a contiguous copy of A2^T, and one
torch.profiler window over five main-path calls. Then it times each kernel, its plain version, a PyTorch
library call on the same inputs (a yardstick the port never calls: bf16
``torch.matmul`` on the materialised operator for K1, K2 and K4, and
``torch.sparse.mm`` on a CUDA CSR tensor with float32 data for K4 and K5)
and the paths with CUDA events. The line before the last is a JSON object
listing K1 to K5; the last line is {"ok": true, "device": {...}}. Any
failed check raises, so the exit code is non-zero and no result line is
printed. Without a CUDA device it exits non-zero before running anything.
It imports nothing of JAX.
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
K4_REL_TOL = 1e-5     # K4 vs its plain version: the same bf16-rounded data
                      # times exact signs, float32 sums in another order
K5_REL_TOL = 1e-6     # K5 vs its plain version: the same products (exact in
                      # float32) summed in the same order; expected bitwise
COO_REL_TOL = 1e-4    # two float32 products of 20000-term sums in other
                      # orders (index_put_ accumulates with atomics)
PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s at 700 W (data sheet)
PEAK_F32 = 67e12       # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
D3, M3, N3, K3_NNZ = 1024, 65536, 2048, 8   # run_all.py config 3
R4, C4, D4, NNZ4 = 20000, 10000, 512, 1_000_000   # run_all.py config 4
KERNEL_NAMES = ("fused_sketch_T_kernel", "fused_sketch_kernel",
                "fused_sketch_reduce_kernel", "fill_block_kernel",
                "saso_sketch_kernel", "saso_reduce_kernel", "ell_spmm_kernel")
WGMMA_KERNELS = ("fused_sketch_kernel", "fused_sketch_T_kernel",
                 "saso_sketch_kernel")


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


def bound(flops, nbytes, peak=PEAK_BF16):
    """(least ms, what bounds it): the operations at their peak rate (the
    bf16 tensor cores unless given) against each input byte read once and
    each output byte written once at the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def sass_check(library):
    """Whether each K1/K2/K4 instantiation in the built library's SASS runs its
    product on HGMMA (wgmma), by cuobjdump where the toolkit has it."""
    from randblas_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        print("cuobjdump not found: HGMMA not checked")
        return
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    found = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        name = next((k for k in WGMMA_KERNELS if k + "I" in head), None)
        if name:
            found.setdefault(name, []).append("HGMMA" in block)
    for name in WGMMA_KERNELS:
        got = found.get(name, [])
        check(got and all(got), f"{name}: HGMMA missing in the SASS ({got})")
        print(f"SASS: HGMMA in all {len(got)} instantiations of {name}")


def entry(name, fn, src, line, launches, err, ms, plain, bnd, lib):
    """One kernel's object of the kernels line: the kernel ``fn`` in
    csrc/<src>.cu replaces randblas_tpu/ops/<src>.py:<line>."""
    return {"name": f"{fn} ({name})", "route": "cuda",
            "source": f"randblas_tpu_torch/csrc/{src}.cu",
            "replaces": f"randblas_tpu/ops/{src}.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib}


def sparse_paths(rt, dev, drive, card):
    """Phase 7: the paths of the sparse-sign operators (K4) and of sparse
    data (K5) at run_all.py's config 3 and 4 sizes, the kernels' edge cases
    against their plain versions (each launched twice and compared bit for
    bit), and their times. Returns the kernels-line entries of K4 and K5."""
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.ops import ell_spmm as ell
    from randblas_tpu_torch.ops import saso_sketch as saso
    from randblas_tpu_torch.sparse_data import ELLMatrix

    # -- (e) config 3: a SASO sketch of dense data, filled on the card ----
    A3 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (M3, N3), dtype=np.float32)).to(dev)
    S3 = rt.SparseSkOp(rt.SparseDist(D3, M3, vec_nnz=K3_NNZ),
                       rt.RNGState.from_key(3))
    B3, e_launches = drive("(e) SASO sketch, run_all.py config 3",
                           lambda: rt.sketch_general(S3, A3), {"K4": 1})
    check(skge.route_counts == {"sparse_saso_kernel": 1},
          f"(e) routes {dict(skge.route_counts)}")
    check(B3.shape == (D3, N3) and B3.dtype == torch.float32,
          f"(e) B is {tuple(B3.shape)} {B3.dtype}")
    check(bool(torch.isfinite(B3).all()), "(e) non-finite values")
    s3 = S3.filled(dev)
    idx3 = s3.rows.reshape(M3, K3_NNZ)
    sgn3 = s3.vals.reshape(M3, K3_NNZ)
    B3_plain = saso.saso_sketch_reference(idx3, sgn3, A3, D3)
    S3_dense = s3.materialize()
    torch.cuda.synchronize()
    k4_abs, k4_rel = abs_err(B3, B3_plain), rel_err(B3, B3_plain)
    check(k4_rel <= K4_REL_TOL, f"(e) K4 vs plain: {k4_rel}")
    e_f32 = rel_err(B3, S3_dense @ A3)
    check(e_f32 <= STAGED_REL_TOL, f"(e) K4 vs float32 product: {e_f32}")
    print(f"(e) K4 vs plain: max abs err {k4_abs:.4g}, normalised "
          f"{k4_rel:.3g} <= {K4_REL_TOL}; vs the float32 densified product "
          f"{e_f32:.3g} <= {STAGED_REL_TOL}")
    del B3_plain
    active = saso.max_active_ctas(dev)
    plan = saso.launch_plan(D3, M3, N3, active)
    print(f"plan (e) K4 {D3}x{M3}@{M3}x{N3}: TI {plan.ti}, TN {plan.tn}, TK "
          f"{plan.tk}, {plan.row_tiles} x {plan.col_tiles} tiles, grid "
          f"{plan.grid} ({plan.splits} splits of {plan.split_steps} steps); "
          f"cudaOccupancyMaxActiveClusters (clusters of one CTA) {active}")
    check(plan.grid[0] * plan.splits <= active,
          f"(e) K4's grid takes more than one round: {plan}")

    # -- (e') the transposed full route: a right sketch by a tall SASO ----
    A3r = A3.T.contiguous()          # (2048, 65536): the data of (e')
    S3t = rt.SparseSkOp(rt.SparseDist(M3, D3, vec_nnz=K3_NNZ),
                        rt.RNGState.from_key(4))
    Be, _ = drive("(e') right sketch by a tall SASO",
                  lambda: rt.sketch_general(S3t, A3r, side="right"),
                  {"K4": 1})
    check(skge.route_counts == {"sparse_saso_kernel": 1},
          f"(e') routes {dict(skge.route_counts)}")
    check(Be.shape == (N3, D3), f"(e') output {tuple(Be.shape)}")
    st = S3t.filled(dev)
    Be_plain = saso.saso_sketch_reference(
        st.cols.reshape(M3, K3_NNZ), st.vals.reshape(M3, K3_NNZ), A3r.T,
        D3).T
    ep_rel = rel_err(Be, Be_plain)
    ep_f32 = rel_err(Be, A3r @ st.materialize())
    check(ep_rel <= K4_REL_TOL, f"(e') K4 vs plain: {ep_rel}")
    check(ep_f32 <= STAGED_REL_TOL, f"(e') vs float32 product: {ep_f32}")
    print(f"(e') K4 on the column-major view vs plain: normalised "
          f"{ep_rel:.3g} <= {K4_REL_TOL}; vs float32 {ep_f32:.3g}")
    del Be, Be_plain, st

    # -- K4 edge cases, each launched twice ------------------------------
    def k4_case(name, idx, sgn, a, d, alpha=1.0):
        n0 = saso.saso_sketch.launches
        got = saso.saso_sketch(idx, sgn, a, d, alpha)
        again = saso.saso_sketch(idx, sgn, a, d, alpha)
        want = saso.saso_sketch_reference(idx, sgn, a, d, alpha)
        torch.cuda.synchronize()
        check(saso.saso_sketch.launches == n0 + 2, f"K4 {name}: launches")
        check(torch.equal(got, again), f"K4 {name}: repeat not bitwise")
        err = rel_err(got, want)
        check(err <= K4_REL_TOL, f"K4 {name}: rel err {err}")
        print(f"K4 {name}: normalised err {err:.3g} <= {K4_REL_TOL}; "
              "repeat bitwise equal")

    def structure(d, m, k, key):
        s = rt.SparseSkOp(rt.SparseDist(d, m, vec_nnz=k),
                          rt.RNGState.from_key(key)).filled(dev)
        return s.rows.reshape(m, k), s.vals.reshape(m, k)

    k4_case("config 3", idx3, sgn3, A3, D3)
    k4_case("ragged d=1000 m=60001 n=777", *structure(1000, 60001, 8, 5),
            A3[:60001, :777], 1000)
    k4_case("k=1 d=513 n=7", *structure(513, 4096, 1, 6),
            A3[:4096, :7].contiguous(), 513)
    k4_case("k=3 d=60 n=33", *structure(60, 500, 3, 7),
            A3[:500, :33].contiguous(), 60)
    k4_case("k=16 d=1000 n=129", *structure(1000, 2048, 16, 8),
            A3[:2048, :129].contiguous(), 1000)
    k4_case("alpha=-0.75", *structure(256, 2048, 8, 9),
            A3[:2048, :64].contiguous(), 256, alpha=-0.75)
    pad_idx, pad_sgn = structure(300, 5000, 8, 10)
    pad_idx = pad_idx.clone()
    pad_idx[100:900] = -1
    k4_case("padding columns (-1)", pad_idx, pad_sgn,
            A3[:5000, :96].contiguous(), 300)
    k4_case("bf16 data", idx3, sgn3, A3[:, :256].to(torch.bfloat16), D3)
    k4_case("column-major data", *structure(700, 3000, 8, 11),
            A3r[:100, :3000].T, 700)
    k4_case("d=1620 at k=8 (the old shared-memory limit)",
            *structure(1620, 8192, 8, 12), A3[:8192, :64].contiguous(), 1620)
    k4_case("d=2048 k=8", *structure(2048, 8192, 8, 13),
            A3[:8192, :200].contiguous(), 2048)
    k4_case("d=4096 k=8 (the gate's largest d)", *structure(4096, 8192, 8, 14),
            A3[:8192, :130].contiguous(), 4096)
    k4_case("d=3000 k=16 (d not a multiple of TI)",
            *structure(3000, 6000, 16, 15), A3[:6000, :96].contiguous(), 3000)
    k4_case("d=40 (d < 64)", *structure(40, 4096, 4, 16),
            A3[:4096, :50].contiguous(), 40)
    k4_case(f"n = TN*8+1 = {saso.TN * 8 + 1}", *structure(512, 4096, 8, 17),
            A3[:4096, :saso.TN * 8 + 1], 512)
    k4_case("m=40 (m < TK)", *structure(30, 40, 2, 18),
            A3[:40, :300].contiguous(), 30)
    k4_case("column-major data at d=3000", *structure(3000, 5000, 8, 19),
            A3r[:150, :5000].T, 3000)
    k4_case("strided data (neither stride 1: element loads)",
            *structure(700, 3000, 8, 20), A3[:6000:2, :300:3], 700)
    k4_case("bf16 data at d=2048", *structure(2048, 8192, 8, 21),
            A3[:8192, :128].to(torch.bfloat16), 2048)

    # the gate is the JAX package's: a float32 SASO sketch with
    # 1620 < d <= 4096 takes K4
    S_wide = rt.SparseSkOp(rt.SparseDist(3000, 16384, vec_nnz=8),
                           rt.RNGState.from_key(22))
    A_wide = A3[:16384, :256].contiguous()
    B_wide, _ = drive("SASO sketch at d=3000 (past the old d limit)",
                      lambda: rt.sketch_general(S_wide, A_wide), {"K4": 1})
    check(skge.route_counts == {"sparse_saso_kernel": 1},
          f"d=3000 routes {dict(skge.route_counts)}")
    sw = S_wide.filled(dev)
    w_rel = rel_err(B_wide, saso.saso_sketch_reference(
        sw.rows.reshape(16384, 8), sw.vals.reshape(16384, 8), A_wide, 3000))
    check(w_rel <= K4_REL_TOL, f"d=3000 K4 vs plain: {w_rel}")
    print(f"d=3000: sparse_saso_kernel, K4 vs plain normalised {w_rel:.3g} "
          f"<= {K4_REL_TOL}")
    del B_wide, A_wide, sw

    # -- (f) config 4: sketch_sparse of COO data from the left ------------
    rng = np.random.default_rng(3)
    rows4 = rng.integers(0, R4, NNZ4)
    cols4 = rng.integers(0, C4, NNZ4)
    vals4 = rng.normal(size=NNZ4).astype(np.float32)
    coo = rt.COOMatrix.from_arrays(R4, C4, rows4, cols4, vals4, device=dev)
    S4 = rt.DenseSkOp(rt.DenseDist(D4, R4), rt.RNGState.from_key(5))
    B4, _ = drive("(f) sketch_sparse of COO data, run_all.py config 4",
                  lambda: rt.sketch_sparse(S4, coo, side="left"), {})
    dense4 = coo.to_dense()
    f_rel = rel_err(B4, S4.materialize(device=dev) @ dense4)
    check(B4.shape == (D4, C4) and f_rel <= COO_REL_TOL, f"(f) {f_rel}")
    print(f"(f) vs the float32 dense product: normalised {f_rel:.3g} <= "
          f"{COO_REL_TOL}")
    del B4

    # -- (g) config 4b: the same data as a word-major BlockedELL ----------
    t0 = time.perf_counter()
    bell = ELLMatrix.from_coo(coo).blocked(word_major=4)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    table_bytes = (bell.local_cols.numel() + bell.vals.numel()) * 4
    entries = int((bell.local_cols >= 0).sum())
    print(f"(g) BlockedELL set-up on the host: {setup_s:.3f} s; n_kblocks "
          f"{bell.n_kblocks}, bw {bell.bw}, tables {table_bytes / 1e6:.1f} MB "
          f"for {entries} entries, overflow {bell.ovf_nnz}")
    S4b = rt.DenseSkOp(rt.DenseDist(C4, D4), rt.RNGState.from_key(6))
    Bg, g_launches = drive(
        "(g) right sketch of a word-major BlockedELL, config 4b",
        lambda: rt.sketch_sparse(S4b, bell, side="right"), {"K5": 1})
    check(Bg.shape == (R4, D4), f"(g) output {tuple(Bg.shape)}")
    check(bool(torch.isfinite(Bg).all()), "(g) non-finite values")
    blk = S4b.materialize(device=dev)           # (10000, 512), natural rows
    Bg_plain = ell.blocked_ell_reference(bell, blk, b_order="natural")
    torch.cuda.synchronize()
    k5_abs, k5_rel = abs_err(Bg, Bg_plain), rel_err(Bg, Bg_plain)
    check(k5_rel <= K5_REL_TOL, f"(g) K5 vs plain: {k5_rel}")
    g_f32 = rel_err(Bg, dense4 @ blk)
    check(g_f32 <= STAGED_REL_TOL, f"(g) vs float32 product: {g_f32}")
    print(f"(g) K5 vs plain: max abs err {k5_abs:.4g}, normalised "
          f"{k5_rel:.3g} <= {K5_REL_TOL} (bitwise: "
          f"{torch.equal(Bg, Bg_plain)}); vs the float32 product "
          f"{g_f32:.3g} <= {STAGED_REL_TOL}")
    Bc, _ = drive("(g) the same right sketch of the COO data",
                  lambda: rt.sketch_sparse(S4b, coo, side="right"),
                  {"K5": 1})
    c_rel = rel_err(Bc, Bg)
    check(c_rel <= K4_REL_TOL, f"(g) COO route vs BlockedELL: {c_rel}")
    print(f"(g) the COO data through the cached BlockedELL vs the "
          f"word-major BlockedELL: normalised {c_rel:.3g} <= {K4_REL_TOL}")
    del Bc, Bg_plain, dense4

    # -- K5 edge cases ----------------------------------------------------
    def k5_case(name, bell_c, b, alpha=1.0, order="storage"):
        n0 = ell.blocked_ell_matmul.launches
        got = ell.blocked_ell_matmul(bell_c, b, alpha, b_order=order)
        again = ell.blocked_ell_matmul(bell_c, b, alpha, b_order=order)
        want = ell.blocked_ell_reference(bell_c, b, alpha, order)
        torch.cuda.synchronize()
        check(ell.blocked_ell_matmul.launches == n0 + 2,
              f"K5 {name}: launches")
        # the COO overflow pass sums with atomics: bitwise only without it
        repeat = torch.equal(got, again)
        check(repeat or bell_c.ovf_nnz, f"K5 {name}: repeat not bitwise")
        err = rel_err(got, want)
        check(err <= K5_REL_TOL, f"K5 {name}: rel err {err}")
        print(f"K5 {name}: normalised err {err:.3g} <= {K5_REL_TOL}; "
              f"repeat bitwise equal: {repeat}")

    k5_case("config 4b", bell, blk, order="natural")
    k5_case("word-major in storage order", bell,
            ell.to_word_major_rows(blk, 4, C4))
    rng = np.random.default_rng(7)
    small = rt.COOMatrix.from_arrays(
        3000, 5000, rng.integers(0, 3000, 200_000),
        rng.integers(0, 5000, 200_000),
        rng.normal(size=200_000).astype(np.float32), device=dev)
    e_small = ELLMatrix.from_coo(small)
    B_small = torch.from_numpy(rng.standard_normal(
        (5000, 1100), dtype=np.float32)).to(dev)
    plain_bell = e_small.blocked()
    k5_case("repeated (row, column), n=1100 (3 column chunks)", plain_bell,
            B_small)
    k5_case("ragged n=77, alpha=-0.5", plain_bell,
            B_small[:, :77].contiguous(), alpha=-0.5)
    k5_case("bw_cap=2 overflow", e_small.blocked(bw_cap=2), B_small[:, :256])
    k5_case("word_major, bw_cap=1 overflow",
            e_small.blocked(word_major=4, bw_cap=1), B_small[:, :64],
            order="natural")
    k5_case("bf16 B", plain_bell, B_small[:, :128].to(torch.bfloat16))
    # the compaction's edges: rows with no entry (only even rows have
    # entries), and a full row (row 0 takes every column: all its slots of
    # every 64-slot chunk are full, bw = kb = 128)
    even = rt.COOMatrix.from_arrays(
        3000, 5000, 2 * rng.integers(0, 1500, 100_000),
        rng.integers(0, 5000, 100_000),
        rng.normal(size=100_000).astype(np.float32), device=dev)
    k5_case("empty rows (odd rows have no entry)",
            ELLMatrix.from_coo(even).blocked(), B_small[:, :512].contiguous())
    full_rows = np.concatenate([np.zeros(5000, np.int64),
                                rng.integers(1, 3000, 20_000)])
    full_cols = np.concatenate([np.arange(5000),
                                rng.integers(0, 5000, 20_000)])
    dense_row = rt.COOMatrix.from_arrays(
        3000, 5000, full_rows, full_cols,
        rng.normal(size=full_rows.size).astype(np.float32), device=dev)
    full_bell = ELLMatrix.from_coo(dense_row).blocked()
    check(full_bell.bw == full_bell.kb, f"full row: bw {full_bell.bw}")
    k5_case(f"a full row (bw = kb = {full_bell.kb}, {full_bell.n_kblocks} "
            "blocks)", full_bell, B_small[:, :300].contiguous())
    k5_case("word-major, natural-order B, n=1100 (3 column chunks)",
            e_small.blocked(word_major=4), B_small, order="natural")
    del small, e_small, B_small, plain_bell, even, dense_row, full_bell

    # -- times ------------------------------------------------------------
    k4_ms = time_ms(lambda: saso.saso_sketch(idx3, sgn3, A3, D3))
    k4_plain_ms = time_ms(
        lambda: saso.saso_sketch_reference(idx3, sgn3, A3, D3), reps=3)
    e_ms = time_ms(lambda: rt.sketch_general(S3, A3))
    fill_ms = time_ms(lambda: S3.filled(dev))
    ep_ms = time_ms(lambda: rt.sketch_general(S3t, A3r, side="right"))
    S3_csr = S3_dense.to_sparse_csr()
    k4_lib_ms = time_ms(lambda: torch.sparse.mm(S3_csr, A3))
    S3_bf, A3_bf = S3_dense.to(torch.bfloat16), A3.to(torch.bfloat16)
    k4_mm_ms = time_ms(lambda: torch.matmul(S3_bf, A3_bf))
    del S3_csr, S3_bf, A3_bf, S3_dense, A3r
    k5_ms = time_ms(lambda: ell.blocked_ell_matmul(bell, blk,
                                                   b_order="natural"))
    k5_plain_ms = time_ms(lambda: ell.blocked_ell_reference(
        bell, blk, b_order="natural"), reps=3)
    g_ms = time_ms(lambda: rt.sketch_sparse(S4b, bell, side="right"))
    gc_ms = time_ms(lambda: rt.sketch_sparse(S4b, coo, side="right"))
    f_ms = time_ms(lambda: rt.sketch_sparse(S4, coo, side="left"))
    coo_csr = torch.sparse_coo_tensor(
        torch.stack([coo.rows.long(), coo.cols.long()]), coo.vals,
        (R4, C4)).coalesce().to_sparse_csr()
    k5_lib_ms = time_ms(lambda: torch.sparse.mm(coo_csr, blk))
    del coo_csr

    f32 = 4
    k4_bound = bound(2.0 * K3_NNZ * M3 * N3,
                     (M3 * N3 + D3 * N3) * f32 + K3_NNZ * M3 * 8, PEAK_F32)
    k5_bound = bound(2.0 * entries * D4,
                     table_bytes + (C4 * D4 + R4 * D4) * f32, PEAK_F32)
    for name, ms in (
            ("K4 saso_sketch wrapper, config 3", k4_ms),
            ("K4 plain (bf16 round + one index_add_ per slot)", k4_plain_ms),
            ("(e) sketch_general, config 3 (Fisher-Yates fill + K4)", e_ms),
            ("(e) the Fisher-Yates fill alone, on the card", fill_ms),
            ("(e') right sketch by the tall SASO (fill + K4)", ep_ms),
            ("torch.sparse.mm, S3 as CUDA CSR, float32 A3", k4_lib_ms),
            ("bf16 torch.matmul on the densified S3", k4_mm_ms),
            ("K5 blocked_ell_matmul, config 4b", k5_ms),
            ("K5 plain (one gather pass per slot)", k5_plain_ms),
            ("(g) sketch_sparse of the BlockedELL (fill + K5)", g_ms),
            ("(g) sketch_sparse of the COO data, conversion cached", gc_ms),
            ("(f) sketch_sparse of the COO data from the left", f_ms),
            ("torch.sparse.mm, the data as CUDA CSR, float32 block",
             k5_lib_ms)):
        print(f"time {name}: {ms:.3f} ms [{card}]")
    print(f"set-up: BlockedELL.from_ell (with ELLMatrix.from_coo) on the host "
          f"{setup_s:.3f} s [{card}]")
    print(f"bounds: K4 {k4_bound[0]:.4f} ms ({k4_bound[1]}), K5 "
          f"{k5_bound[0]:.4f} ms ({k5_bound[1]}), at {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s float32 and {PEAK_BYTES / 1e12:.2f} TB/s; K4's dense "
          f"tensor-core product (2 d m n) alone "
          f"{2.0 * D3 * M3 * N3 / PEAK_BF16 * 1e3:.4f} ms at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16")

    # launches: K4 on path (e), K5 on path (g)
    return [entry("K4", "saso_sketch_kernel", "saso_sketch", 67,
                  e_launches["K4"], k4_abs, k4_ms, k4_plain_ms, k4_bound,
                  k4_lib_ms),
            entry("K5", "ell_spmm_kernel", "ell_spmm", 209, g_launches["K5"],
                  k5_abs, k5_ms, k5_plain_ms, k5_bound, k5_lib_ms)]


def profile_main(rt, S, A, card):
    """One torch.profiler window over five main-path calls: K1's device
    time per call and the share of the window in which the card ran no
    kernel, against the window's wall time with the profiler on and the
    same five calls' wall time without it."""
    from torch.profiler import ProfilerActivity, profile

    def five_calls():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            rt.sketch_general(S, A, side="left")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    bare_us = five_calls()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_us = five_calls()
    def device_us(e):  # the name changed across PyTorch versions
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in kernels)
    k1_us = sum(device_us(e) for e in kernels
                if "fused_sketch_kernel" in e.key
                or "fused_sketch_reduce_kernel" in e.key)
    if busy_us == 0:
        print("profiler: the trace shows no device time; host share not "
              "measured")
        return
    print(f"profiler, 5 main-path calls: K1 (with its split sum) "
          f"{k1_us / 5e3:.3f} ms device time per call; device busy "
          f"{busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall with the "
          f"profiler on (idle share {1 - busy_us / wall_us:.3f}), of "
          f"{bare_us / 1e3:.3f} ms without it (idle share "
          f"{max(0.0, 1 - busy_us / bare_us):.3f}) [{card}]")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import ell_spmm as ell
    from randblas_tpu_torch.ops import fused_sketch as fs
    from randblas_tpu_torch.ops import saso_sketch as saso

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
    sass_check(_build.LIBRARY)
    kernel = None
    for line in (_build.build_log or "").splitlines():
        if "Used" in line and "registers" in line or "spill" in line:
            print("  ptxas:", kernel, line.strip())
            continue
        name = next((k for k in KERNEL_NAMES if k in line), None)
        if name:
            args = re.search(name + r"I(.+?)EEv", line)
            kernel = f"{name}[{args.group(1)}]" if args else name

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    counters = {"K1": fs.fused_sketch, "K2": fs.fused_sketch_colmajor,
                "K3": fs.fill_block, "K4": saso.saso_sketch,
                "K5": ell.blocked_ell_matmul}

    def reset():
        for c in counters.values():
            c.launches = 0
        skge.route_counts.clear()

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    def drive(name, fn, expect):
        """Run one path with the counts at 0, and check its launches (the
        kernels ``expect`` does not name must not launch)."""
        expect = {k: expect.get(k, 0) for k in counters}
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
    active = fs.max_active_clusters(dev)
    for label, (d_p, m_p, n_p) in (("main path, K1", (D, M, N)),
                                   ("(b) and (a)'s backward, K2", (M, D, N))):
        plan = fs.launch_plan(d_p, m_p, n_p, 0, active)
        print(f"plan {label} {d_p}x{m_p}@{m_p}x{n_p}: TI {plan.ti}, TN "
              f"{plan.tn}, TK {plan.tk}, cluster {plan.cluster}, grid "
              f"{plan.grid + (plan.splits,)} ({plan.splits} splits of "
              f"{plan.split_steps} steps), regeneration factor {plan.regen}; "
              f"cudaOccupancyMaxActiveClusters {active}")
        check(plan.regen <= 2, f"{label}: S generated {plan.regen} times")

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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    B2, _ = drive("(d) right sketch, run_all.py config 2", right,
                  {"K1": 1, "K2": 0, "K3": 0})
    d_peak = torch.cuda.max_memory_allocated() - mem0
    check(skge.route_counts == {"right_fused": 1},
          f"(d) routes {dict(skge.route_counts)}")
    B2_ref = fs.fused_sketch_reference(transposed(S2), A2.T, rows_s=D2,
                                       cols_s=C2, ro_s=8, co_s=8).T
    d_rel = rel_err(B2, B2_ref)
    check(B2.shape == (R2, D2) and d_rel <= K1_REL_TOL, f"(d) rel {d_rel}")
    print(f"(d) right route vs plain K1 on the transposed dist: normalised "
          f"{d_rel:.3g} <= {K1_REL_TOL}")
    del B2, B2_ref
    # the same K1 call handed a contiguous copy of A2^T, as the route did
    # before K1 read A through strides
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    fs.fused_sketch(transposed(S2), A2.T.contiguous(), rows_s=D2, cols_s=C2,
                    ro_s=8, co_s=8)
    torch.cuda.synchronize()
    copy_peak = torch.cuda.max_memory_allocated() - mem0
    print(f"(d) peak device memory above the inputs: {d_peak / 1e9:.3f} GB "
          f"(K1 reads A2^T in place); with a contiguous copy of A2^T "
          f"{copy_peak / 1e9:.3f} GB")

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

    # K1 and K2 at the edges of the cluster and the tiles, float32 and bf16,
    # each launched twice on the same inputs: the sums must be bitwise
    # repeatable (fixed order, no atomics)
    def edge(kname, name, S_e, A_e, kw, tol):
        wrapper, reference = (
            (fs.fused_sketch, fs.fused_sketch_reference) if kname == "K1"
            else (fs.fused_sketch_colmajor, fs.fused_sketch_colmajor_reference))
        n_before = counters[kname].launches
        got = wrapper(S_e, A_e, **kw)
        again = wrapper(S_e, A_e, **kw)
        want = reference(S_e, A_e, **kw)
        torch.cuda.synchronize()
        check(counters[kname].launches == n_before + 2,
              f"{kname} {name}: launches")
        check(torch.equal(got, again), f"{kname} {name}: repeat not bitwise")
        err = rel_err(got, want)
        check(err <= tol, f"{kname} {name}: rel err {err}")
        plan = fs.launch_plan(kw["rows_s"], *A_e.shape,
                              kw.get("ro_s", 0) % 4 if kname == "K2" else 0,
                              active)
        print(f"{kname} {name} {str(A_e.dtype)[6:]}: normalised err "
              f"{err:.3g} <= {tol}; repeat bitwise equal; cluster "
              f"{plan.cluster}, grid {plan.grid + (plan.splits,)}")

    wide = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2000, fs.TN * 16 + 1), dtype=np.float32)).to(dev)
    edges = [
        (f"n = TN*8+1 = {fs.TN * 8 + 1}", A[:3000, :fs.TN * 8 + 1],
         dict(rows_s=300)),
        (f"n = TN*16+1 = {fs.TN * 16 + 1}", wide, dict(rows_s=200)),
        ("n < TN (n=100)", A[:2000, :100], dict(rows_s=256)),
        ("d < TI (d=50)", A[:4096, :512], dict(rows_s=50)),
        ("m < TK (m=40)", A[:40, :300], dict(rows_s=200)),
        (f"all-phantom CTAs (n = 5 TN = {5 * fs.TN}: 5 column tiles in a "
         "cluster of 8)", A[:1000, :5 * fs.TN], dict(rows_s=130)),
    ]
    for name, A_e, kw in edges:
        for A_t, tol in ((A_e.contiguous(), K1_REL_TOL),
                         (A_e.to(torch.bfloat16), BF16_REL_TOL)):
            kw = dict(kw, cols_s=A_t.shape[0])
            edge("K1", name, S, A_t, kw, tol)
            edge("K2", name, S_c, A_t, dict(kw, ro_s=3), tol)
    del wide

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
    profile_main(rt, S, A, card)

    # launches: K1 on the main path, K2 on its backward pass (a), K3 on the
    # staged use_kernel_fill run
    kernels = [
        entry("K1", "fused_sketch_kernel", "fused_sketch", 127,
              main_launches["K1"], k1_abs, k1_ms, plain_ms, k1_bound,
              k1_lib_ms),
        entry("K2", "fused_sketch_T_kernel", "fused_sketch", 366,
              grad_launches["K2"], k2_abs, k2_ms, k2_plain_ms, k2_bound,
              k2_lib_ms),
        entry("K3", "fill_block_kernel", "fused_sketch", 446,
              staged_launches["K3"], k3_err, k3_ms, k3_plain_ms, k3_bound,
              None),
    ]
    del A, G, A2, S_c
    torch.cuda.empty_cache()
    kernels += sparse_paths(rt, dev, drive, card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
