#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (randblas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

It builds the kernels from ``randblas_tpu_torch/csrc`` with nvcc, checks
the fill kernel K3 (in both Gaussian transforms and both orientations, a
ColMajor block's natural one through the transposed operator, bit for bit),
the lazy fill ``fill_dense_submat``, which runs K3 on the card,
against the plain fill (bit for bit, float32, float64 and bf16), the fused
sketch kernels K1 and K2, the SASO sketch kernel K4, the BlockedELL SpMM
kernel K5, the x64 fill kernel K6 and the sparse-sign fill kernel K7
against their plain PyTorch versions on the card (K4 and K5 also launched
twice on the same inputs and compared bit for bit; K6 and K7 bit for bit),
and drives
these paths through the public entry points, each with the launch counts
set to 0 just before it and read just after:

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
  filled on the card by K7 once, sketching A3 (65536, 2048) float32 from
  the left: K4 once; K7's fill alone bit for bit its plain version, its
  times and its bound (every path that fills a lazy sparse operator on
  the card counts one K7 launch a fill);
- (e') the transposed full route: a right sketch of A3^T (2048, 65536) by
  the tall SASO SparseDist(65536, 1024, vec_nnz=8): K7 once, K4 once, on
  a column-major view of the data;
- (f) run_all.py config 4: sketch_sparse of COO data (20000 x 10000, 1e6
  entries) from the left by DenseDist(512, 20000): K3 once for the
  operator block, then the COO route;
- (g) config 4b: the same data as a word-major BlockedELL, sketched from
  the right by DenseDist(10000, 512): K3 once (the ColMajor block in math
  orientation) and K5 once; and the same right sketch of the COO data,
  which reaches K5 once through the cached BlockedELL conversion;

and the staged route (K3 once, its product against that of the plain
fill), the staged route with ``use_kernel_fill`` (K3 once, the TPU
kernel's transform), a square distribution's backward pass (K2 and K3
once) and a float32 SASO sketch at d=3000 (past the old d limit of K4),
which takes K4 once. Phase 8 drives the linalg tier and the SRHT and
tensor sketches at the benchmarks' shapes, each checked and timed (data
made on the card from ``--seed``, default 0):

- (h) an SRHT sketch ``TrigSkOp(TrigDist(1024, 65536))`` of A (65536,
  4096) from the left, and the right sketch of A^T with ``op_s="T"``: no
  kernel (Hadamard stages as matmuls), against the explicit operator's
  float32 product;
- (i) ``linalg.rsvd`` of a 32768 x 4096 matrix with planted singular
  values at rank 256 (oversample 8, two power iterations), with the
  Gaussian operator (K3 once, for the thin operator) and the SRHT one,
  against the planted values and float64 ``svdvals``, beside
  ``torch.svd_lowrank``; and ``linalg.cholqr`` of the rangefinder's sketch
  with TF32 allowed by the caller;
- (j) ``linalg.sketch_and_precondition`` of a 131072 x 2048 system of
  condition ~1e3 at d = 4096, 'saso' (the Fisher–Yates fill, K4 once for
  A, the fixed-nnz route for b) and 'gaussian' (K1 once for A, the staged
  route for b: K3 once), against float64 ``torch.linalg.lstsq``, beside
  float32 ``torch.linalg.lstsq``;
- (k) ``linalg.sketched_tls`` of run_all.py config 1 in float64
  (``DenseDist(4002, 100000)``, [A b] 100000 x 2001): the staged route, K3
  once, against exact TLS from the Gram's eigenvectors;
- (l) ``tensor_sketch`` of two 65536 x 64 factors to d = 1024 (K4 once a
  factor) against the direct float64 convolution of their CountSketches.

Phase 9 drives the x64 operators and linalg groups 2-3 at the shapes of
``benchmarks/linalg_bench.py``, each path with its routes and launch
counts, its check, its time beside the library call's where there is one,
and one profiled call (device busy time, idle share, top kernels):

- (m) ``sketch_general`` of a ``DenseDist(1024, 65536)`` operator seeded
  with Philox4x64, Gaussian and Uniform, on A (65536, 512) float64: K6
  fills the operator on the card (``fill_block64_kernel`` once;
  ``dense.x64_engine_counts`` {"card": 1}), then a float64 matmul. K6's
  block bit for bit its plain version on the card; row blocks of K6
  against the native and numpy host engines (Uniform bitwise, Gaussian
  within X64_CARD_GAUSS_ULP; the engines against each other within 2
  ulp), Philox4x64 and Threefry4x64; the product against the materialised
  operator's; K6's times (one call, back to back, device time: CUDA
  events around 20 launches queued while the card sleeps) beside its
  plain version's and the host engine's fill of the same block, and its
  bound, the larger of the bytes written and the operations bound of
  ``kernel_variants.k6_census`` of the built kernel's SASS (the busiest
  arithmetic pipe at the card's maximum SM clock; the time to issue every
  instruction printed beside it, not as a bound);
- (m') the right sketch of A (512, 65536) float64 by the ColMajor-natural
  ``DenseDist(65536, 1024)`` seeded with Threefry2x64: K6 once, through
  ``fill_block64_T_kernel`` (the block in math orientation), with the same
  checks and times;
- (n) ``nystrom_pcg`` (K1 and K3 once) and ``rpcholesky_pcg`` (no kernel)
  on A = G G^T + 0.1 I, n = 8192, d = rank = 512: the residual and x
  against a float64 solve, the PCG iterations, whether Nystrom's Cholesky
  held;
- (o) ``xtrace``, ``xdiag`` and ``hutchpp`` of the implicit Gram of
  G (16384, 256) at budget 64 (K3 for the probes) against the same calls
  on the CPU, and test_tpu_hardware.py's controlled spectrum (n = 1024,
  budget 96) with its bounds;
- (p) ``leverage_scores`` (K4 once) of A (524288, 512) against float64
  QR's, and ``sample_lsq`` (K4 once) at s = 8192 against the float64
  least-squares residual;
- (q) ``amm`` of (2048, 262144) x (262144, 2048) at s = 16384 (no kernel)
  against its error bound;
- (r) ``random_fourier_features`` of x (65536, 128) to D = 4096 (K2 and K3
  once) against the formula on the same bf16-rounded operands, and its
  RBF kernel approximation;
- (s) ``rsvd_krylov``, ``column_id``, ``cur`` and ``spectral_norm`` on
  (i)'s planted 32768 x 4096 matrix at rank 256 (K3 once per
  rangefinder), and the first Krylov block's SVD by ``torch.linalg.svd``
  beside ``linalg.qb.safe_svd`` (orthogonality and reconstruction);
- (t) ``sgmres`` (K4 three times) at n = 8192 with its true residual, and
  ``sketched_eigs`` (K3 once), symmetric and not, on 16 planted
  eigenvalues against float64 ``eigvalsh``;
- (u) ``rgs_qr`` of A (65536, 512) and test_tpu_hardware.py's cond 3e7
  case (K3 once; K1, K2 and K4 never);
- (v) ``rand_geigh`` on the bench's pencil and on a planted one, and
  ``rand_eigh``, against float64 ``eigvalsh`` (K3 once).

Phase 10 drives linalg groups 4-5 at ``benchmarks/linalg_bench.py``'s
shapes with PyTorch's default TF32 setting (off), each path with its launch
counts, every block it hands K3 held bit for bit against the plain fill,
its time beside the library call's where there is one, one profiled call,
and ``tests/test_tpu_hardware.py``'s case of the module at its own size and
bounds (its float64 numpy oracles copied here, as the test modules import
jax):

- (w) ``single_pass_svd`` of (i)'s planted 32768 x 4096 matrix at rank 256
  (K3 twice) against TYUC17's expected error and the same call in float64
  on the same operators; ``StreamingSketch`` over 8 row chunks (K3 10
  times) against it; ``FrequentDirections`` over 65536 x 1024, ell = 256,
  by ``update`` in chunks of 4096 and by ``ingest``, and ``fd_pass``, bit
  for bit equal, against the GLPW16 certificate (no kernel), one shrink
  timed apart; beside float32 ``torch.linalg.svd`` and the exact Gram;
- (x) on the implicit Gram of G (16384, 256) with 16 probes (K3 once a
  call): ``spectral_density`` (60 steps), ``kpm_density`` (degree 128)
  and ``eig_count`` against G^T G's 256 eigenvalues, ``logdet`` of
  I + G G^T against float64 log det(I + G^T G), ``lanczos_fn_apply`` of
  its square root against the float64 formula (no kernel), and the
  Lanczos tridiagonals' batched eigendecomposition against float64 numpy;
- (y) ``block_kaczmarz`` and ``block_gauss_seidel`` ('shuffle': K3 once,
  'colnorm') on 65536 x 1024, block 512, 48 steps, against the port's CPU
  run on the same inputs, beside float32 ``torch.linalg.lstsq``;
- (z) ``tt_round`` of (64)^4 from rank 128 to 64 (K3 4 times),
  ``tt_from_dense`` (3) and ``tucker_from_dense`` (4) of a 64^4 tensor,
  ``tt_single_pass`` and a ``TTStream`` of 4 additive updates at rank 16
  (8 each; their sketches against each other), and ``tt_matvec`` of a
  rank-8 TT-matrix against the mode-by-mode contraction.

Phase 11 drives the distributed layer (``randblas_tpu_torch.parallel``),
numbered as the JAX package's ``dryrun_multichip``. Through a real NCCL
process group of one rank (``initialize_multihost`` on a localhost port)
and a 1 x 1 ``make_sketch_mesh``, with DTensor inputs: (M1)
``distributed_sketch`` at the main shape (K1 1, bitwise
``sketch_general``'s) and its backward pass (K1 1, K2 1), (M8)
``distributed_rsvd`` and (M9) ``distributed_krylov_rangefinder`` on (i)'s
planted matrix (K3 1 each), (M13) ``distributed_fd`` at FD's 65536 x 1024,
ell = 256, and (M14) ``ihs_lsq(mesh=)`` at (j)'s shape (K1 1) against the
unsharded run. NCCL takes one rank a card, so 1 x 4, 4 x 1 and 2 x 2 meshes
are emulated: each shard body runs on the card in turn at full width and
the partials are added in rank order, against the single-device sketch:
(M1) left at the main shape (K1 a shard; each shard's tile from K3 bitwise
the slice of one full K3 fill), (M2) right at config 2 (K1 a shard), (M3)
SASO at config 3 (K4 a shard), (M4) the column layout (K1 a shard where
``skge.fused_profitable`` takes its tile; 1 x 4's 1024 columns staged, K3
a shard), (M5) sparse data at config 4 (K3 a shard), (M6) pad-and-shard
at d = 1000, m = 65000, n = 4093, (M7) SRHT columns (no kernel), (M13) FD
over four shards merged.

Phase 12 drives the solver tier and the tensor sketches on sharded inputs
(DTensors) on the same 1 x 1 NCCL mesh, numbered after the JAX package's
``dryrun_multichip`` cases 10-12: (M10) ``sgmres`` on a row-sharded A at
(t)'s shape (K4 3), (M11) ``block_kaczmarz`` on a row-sharded system and
(M12) ``block_gauss_seidel`` on a column-sharded one at (y)'s ('shuffle':
K3 once; 'colnorm': none), (M15) ``tensor_sketch`` (K4 2) and (M16)
``kfjlt_sketch`` (none) of column-sharded factors at (l)'s. Each against
the unsharded call on the card (the dryrun's rtol 1e-4, atol 1e-5 and
sgmres's true residual below 1e-4; the tensor sketches bitwise), with the
same next_state, timed by ``randblas_tpu_torch.profiling.time_op`` beside
the unsharded call.

Phase 13 checks the H100 dispatch gates (``gate_sweep.py``'s boundaries):
at the grid points nearest each side of each boundary of K1, K2, the
left-Trans and right routes, K4, K5, the COO model and the SRHT's stage
cap, the route "auto" takes on the card (launch counts and routes) is the
gate's decision and its result is within the bound of the forced other
route, both timed; the main path once more (K1 once); and config 4b plus
one full row (slot width 136) through ``left_spmm`` on the COO route, no
table built, within 1e-6 of the plain float32 product. The K1/K2 edge cases of
phases 4 and 5 and the square distribution's forward pass run under
``use_fused=True``, since "auto" takes the staged route at their shapes.

Phase 14 runs the eleven applications of ``examples_torch/`` through
their ``run()`` on the card at the JAX examples' default sizes, and (A1)
total least squares at m = 2^20, (A2) the rank-1-plus-noise QB SVD at
200000 x 150000 (its COO drawn on the card), (A6) kernel ridge at n =
32768 and (A10) the distributed sketch at the main shape on a 1 x 1 NCCL
mesh (APP_SCALED), each with its launches (APP_LAUNCHES), its ground truth
(a planted structure or the random-matrix prediction, a float64 reference,
or its certificate, against the bounds APP_*), its time and the idle share
of one profiled call.

Phase 15 runs the port's card tier, ``python -m pytest --noconftest -q
tests/test_torch_cuda_hardware.py`` (the counterparts of
tests/test_tpu_hardware.py and the Hopper branches of K1-K6, each against
its plain version), in a subprocess, prints its pass, fail and skip counts
and its seconds, and fails the run if a test failed, erred or skipped.

For K1 and K2 it also prints the launch plan
of the main path and of (b) (tiles, the panel step, thread-block cluster,
grid, contraction splits and the panel steps of one, how many times the
operator is generated, and the card's
cudaOccupancyMaxActiveClusters), K4's plan at (e), whether ``cuobjdump
-sass`` shows HGMMA (wgmma) in every K1, K2 and K4 instantiation, their
cases at the edges of the cluster and the tiles in float32 and bf16 (each
launched twice and compared bit for bit; for K4 also d up to 4096, d < 64,
m < TK, column-major and strided data; for K5 rows with no entry, a full
row, column chunks and natural-order B), path (d)'s peak device memory
beside that of the same call handed a contiguous copy of A2^T, and one
torch.profiler window over five main-path calls, and K3's static SASS
instruction mix. Then it times each kernel, its plain version, a PyTorch
library call on the same inputs (a yardstick the port never calls: bf16
``torch.matmul`` on the materialised operator for K1, K2 and K4, and
``torch.sparse.mm`` on a CUDA CSR tensor with float32 data for K4 and K5)
and the paths with CUDA events (K3 also 20 calls back to back and by its
device time in a torch.profiler window, in both transforms at the paths'
shapes, its wrappers' host time per call on a 4 x 4 block, and the
operator blocks of (f) and (g) beside the plain fill). The line before the
last is a JSON object listing K1 to K7, each with one call's time through
its wrapper; K3's entry is the fill the staged route runs (1024 x 65536,
the staged fill's transform), with the launches of that route and two more
keys, its device time (``device_ms``) and its time a call 20 calls back to
back (``seq_ms``); K6's is (m)'s Gaussian fill, with the same two keys (its
device time by CUDA events) and (m')'s ColMajor fill under ``colmajor_*``
keys, its bound max(bytes, operations); K7's is (e)'s fill, with the same
two keys, the plain version's device time and the operations bound of the
SASS census at (e)'s k (``plain_device_ms``, ``operations_ms``), its bound
max(bytes, operations). The last line is {"ok":
true, "device": {...}}. Any failed check raises, so the exit code is
non-zero and no result line is printed. Without a CUDA device it exits
non-zero before running anything.
It imports nothing of JAX. Its timing and census helpers are
``kernel_variants.py``'s, beside it.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from kernel_variants import (all_device_ms, device_ms, event_device_us,
                             issue_ms, k6_census, k6_values_per_iter,
                             k7_census, launch_ms, max_sm_clock,
                             operations_bound, sass_of, time_ms)

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
HEAVY_ROW_TOL = 1e-6  # (13) config 4b plus a full row through the COO
                      # route vs the plain float32 product of the densified
                      # data: the same product, repeated entries summed in
                      # another order
SRHT_REL_TOL = 2e-5   # (h) SRHT vs the explicit operator's float32 product:
                      # 65536-term sums of +-a in other orders (two stages
                      # of 256 against one long dot product)
RSVD_TOL = 1e-4       # (i) top-256 singular values, max abs err / s_1
                      # (float32 products and SVDs, s_256 = 0.1 s_1)
ORTH_TOL = 5e-6       # (i) max |Q^T Q - I| of cholqr with TF32 allowed:
                      # float32 CholQR2 reads ~1e-7, a TF32 Gram ~1e-4
LSQ_TOL = 1e-2        # (j) ||x - x64|| / ||x64||: CGLS stops at a normal
                      # residual of 100 eps (1.2e-5); x's error is up to
                      # cond(A) ~ 1e3 times that
TLS_SLACK = 2.0       # (k) times the Gaussian sketch's expected error
TS_REL_TOL = 1e-5     # (l) the FFT's float32 rounding (log d terms)
# phase 8's shapes: (h) SRHT (d, m, n) at the main shape; (i) rSVD (m, n,
# rank), benchmarks/linalg_bench.py:46-49; (j) sketch-and-precondition
# (m, n, d), its bench_ridge / bench_ihs shape; (k) sketched TLS (m, n, d),
# benchmarks/run_all.py config 1; (l) TensorSketch (m, n, d) of two factors,
# linalg_bench.py:502-517
PHASE8 = {"h": (D, M, N), "i": (32768, 4096, 256), "j": (131072, 2048, 4096),
          "k": (100_000, 2000, 4002), "l": (65536, 64, 1024)}
# phase 9's shapes, benchmarks/linalg_bench.py's unless named: (m) the x64
# sketch (d, m, n); (n) Nystrom and RPCholesky PCG (n, G's columns, d =
# rank), :64-79 and :137-151; (o) trace and diagonal (n, G's columns,
# budget), :255-294; (p) leverage scores and sample_lsq (m, n, s),
# :220-236; (q) AMM (m, n, p, s), :200-217; (r) random Fourier features
# (n, dim, D), :238-252; (s) (i)'s planted matrix (m, n, rank); (t) sGMRES
# and sketched eigenpairs (n, basis, k, eigs basis), :97-135; (u) RGS QR
# (m, k, block), :421-448; (v) the eigensolvers (n, k), :174-198
PHASE9 = {"m": (1024, 65536, 512), "n": (8192, 64, 512),
          "o": (16384, 256, 64), "p": (524288, 512, 8192),
          "q": (2048, 262144, 2048, 16384), "r": (65536, 128, 4096),
          "s": (32768, 4096, 256), "t": (8192, 80, 16, 64),
          "u": (65536, 512, 128), "v": (8192, 32)}
X64_PROD_TOL = 1e-12  # (m) vs the materialised operator's float64 product
X64_GAUSS_ULP = 2     # (m) native vs numpy Gaussian: libm's and numpy's sin,
                      # cos, log a last bit apart, then r * sin rounds once
                      # more (1 ulp is the JAX package's note, dense.py:49;
                      # 2 is what a (64, 65536) block shows on the CPU)
X64_CARD_GAUSS_ULP = 4  # (m), (m') K6's Gaussian values vs the host engines:
                        # CUDA's float64 sin, cos (2 ulp) and log (1 ulp)
                        # against glibc's and numpy's, then r * sin rounds
PCG_RES_TOL = 1e-4    # (n) ||(A + mu I) x - b|| / ||b|| (PCG stops at 1e-5)
PCG_X_TOL = 1e-3      # (n) ||x - x64|| / ||x64||
TRACE_CPU_TOL = 1e-4  # (o) the card's estimate vs the CPU's, relative
LEV_RATIO = (0.25, 4.0)     # (p) estimated / exact scores, every row
LEV_MEDIAN = (0.8, 1.25)    # (p) their median, at embed_factor 8: the
                            # estimate's bias is ~d / (d - n - 1), 1.33 at
                            # the default d = 4n and 1.14 at d = 8n
LSQ_SLACK = 1.2       # (p) sample_lsq's residual / the float64 optimum
AMM_SLACK = 3.0       # (q) times ||A||_F ||B||_F / sqrt(s)
RFF_TOL = 1e-3        # (r) vs the formula with K2's plain projection
                      # (the same bf16 operands), / sqrt(2/D): float32 sums
                      # of 128 terms of |x w| <= ~60 in another order
RFF_KERNEL = 5.0      # (r) max |z z^T - exp(-d^2 / 2 bw^2)| * sqrt(D)
KRYLOV_TOL = 1e-4     # (s) top-256 singular values, max abs err / s_1
SVD_TOL = 5e-5        # (s) safe_svd: max |U^T U - I| and the reconstruction
                      # / max |y|: Householder QR of 258 columns in float32
                      # (n eps = 1.5e-5 at worst)
ID_SLACK = 10.0       # (s) ID and CUR errors / ||A - A_256||_F
SPEC_TOL = 1e-2       # (s) spectral_norm's own tol, relative to s_1
SGMRES_TOL = 1e-4     # (t) true relative residual
RITZ_TOL = 1e-3       # (t), (v) eigenvalues, max abs err / max |ref|
RGS_REC_TOL = 1e-5    # (u) ||QR - A|| / ||A||
RGS_HW = (2e-4, 2e-3)  # (u) cond 3e7: reconstruction, ||Q^T Q - I||_2
# phase 10's shapes, benchmarks/linalg_bench.py's: (w) (i)'s planted matrix
# (m, n, rank) and FD's stream (m, n, ell, chunk), :334-381; (x) the
# implicit Gram (n, G's columns, probes), :383-418; (y) Kaczmarz and
# Gauss-Seidel (m, n, block, steps), :296-332; (z) the TT and Tucker tensors
# (mode size, modes), :450-497
PHASE10 = {"w": (32768, 4096, 256), "fd": (65536, 1024, 256, 4096),
           "x": (16384, 256, 16), "y": (65536, 1024, 512, 48),
           "z": (64, 4)}
SPSVD_HW = (1e-2, 1.1e-2)  # (w) test_tpu_hardware.py:389-417: s to 1e-2
                           # relative, reconstruction < 1.1e-2
STREAM_TOL = 1e-5     # (w) StreamingSketch vs single_pass_svd, / s_1
FD_HW = (1.02, 1e-3, 0.6)  # (w) test_tpu_hardware.py:588-620: gram error
                           # <= mass * 1.02 + 1e-3 ||A||_F^2, mass <= 1.02
                           # ||A||_F^2 / ell and < 0.6 of it
TINY_EIGH_TOL = 1e-5  # (x) the tridiagonals' nodes (/ max |node|) and
                      # weights (they sum to 1) vs float64 numpy.linalg.eigh
LOGDET_TOL = 0.1      # (x) vs float64 log det: 16 Gaussian probes spread
                      # ~2% (sqrt(2/16) ||log(I + G G^T)||_F / logdet)
FN_TOL = 1e-4         # (x) sqrt(I + G G^T) B vs the float64 formula, / max
COUNT_TOL = 0.1       # (x) eig_count vs 256 (16 Rademacher probes spread
                      # ~2%), and the densities' cluster masses (as
                      # test_tpu_hardware.py:537-585)
DOS_TOTAL_TOL = 0.05  # (x) trapezoid(density) vs n (the same test's bound)
KACZ_CPU_TOL = 1e-4   # (y) the card's x vs the port's CPU run, / max |x|
KACZ_HW = (1e-3, 5e-3)  # (y) test_tpu_hardware.py:478-505
TT_EXACT_TOL = 1e-3   # (z) rounding 2x (rank 64) back to rank 64, and the
                      # single-pass recovery of a rank-16 tensor, relative
TT_STREAM_TOL = 1e-5  # (z) TTStream's sketches Psi_k vs one pass's, / max
TT_MATVEC_TOL = 1e-4  # (z) tt_matvec vs the mode-by-mode contraction
TT_HW = 1e-2          # (z) test_tpu_hardware.py:798-840: exact recovery
ORTH_HW = 2e-2        # (z) test_tpu_hardware.py:843-870: U^T U - I
# phase 11's meshes, emulated on one card, and its pad-and-shard shape (d,
# m, n); the bounds of (M9) and (M14)
MESHES11 = ((1, 4), (4, 1), (2, 2))
PAD11 = (1000, 65000, 4093)
KRYLOV11_SLACK = 1.05  # (M9) ||A - Q Q^T A||_F / the planted rank-256 tail:
                       # depth 2 captures the top 256 to (3e-2)^5
KRYLOV11_ORTH = 1e-5   # (M9) max |Q^T Q - I| (float32 Grams, two passes)
IHS11_TOL = 1e-4       # (M14) the mesh's x vs the unsharded run's (the
                       # dryrun's rtol)
# phase 14, the applications (examples_torch/): the JAX examples' default
# sizes, then (A1), (A2), (A6), (A10) grown in m and n only
APP_SCALED = {"A1": (1_048_576, 500), "A2": (200_000, 150_000, 1e-3),
              "A6": 32_768, "A10": (1024, 65_536, 4096)}
# each bound set from the port's CPU run at the default size (its reading
# in parentheses) before the first card run
APP_TLS_X64 = 1e-3    # (A1) classical x vs the float64 TLS solution,
                      # relative (5.5e-7; cuSOLVER's float32 SVD ~1e-4)
APP_TLS_ERR = 0.08    # (A1) sketched x vs x_true (0.052-0.054)
APP_RANK1 = (1e-2, 0.99)   # (A2) sigma_1 vs 25, relative (5.6e-3); |cos|
                           # to the planted u, v (0.9974, 0.9984)
APP_RMT = (1e-2, 0.03)     # (A2) scaled: sigma_1 relative to, and |cos|
                           # within, the random-matrix prediction (its CPU
                           # analog 20000 x 15000 at p = 1e-2: 1.3e-3, 0.011)
APP_RMT_ITERS = 12    # (A2) scaled: power iterations that resolve the
                      # spike (converged on the CPU analogs)
APP_QRCP_ERR = 1e-3   # (A3) ||A - QB|| / ||A|| (2.6e-4; study 2.6e-4-3.0e-4)
APP_QRCP_PIVOTS = [342, 77, 969, 231, 140, 906, 350, 305]  # (A3) leading
APP_SVD_SLACK = 1.5   # (A4) 'qr', 'sketch' error / the exact rank-32 error
                      # (1.017, 1.025)
APP_SVD_UNSTABLE = 0.1     # (A4) 'lu', 'none' error, set by rounding
                           # (6.4e-4, 1.8e-2)
APP_LSQ = (60, 1e-6, 1e-4)  # (A5) CGLS iterations (46); x vs float64 lstsq
                            # (1.5e-7); IHS x vs lstsq (4.1e-5)
APP_LSQ_RES = 1e-8    # (A5) residuals over lstsq's, minus 1 (1e-13)
APP_KRR = (1e-5, 40, 0.05)  # (A6) relative system residual (1.1e-6; 1.1e-6
                            # at n = 8192), CG iterations (21; 24), test
                            # RMSE (0.035; noise floor 0.05)
APP_DOS = (0.05, 0.5, 1e-3)  # (A7) density integrals / n (3e-5); eig_count
                             # vs 12 (0.035); Ritz values vs planted (5e-5)
APP_CP = (0.98, 0.95)  # (A8) exact fit (0.990); sketched fits / exact (the
                       # example's own bound; 0.99998, 0.9993)
APP_TT = (2e-4, 1e-3, 1e-3)  # (A9) rank-8 error (9.8e-5); rounding error
                             # (the example's bound; 9.9e-5); tt_norm (1.1e-4)
APP_DIST = (1e-5, 1e-4)  # (A10) rangefinder |Q^T Q - I| (4.8e-7);
                         # distributed_rsvd singular values (6.2e-7); the
                         # 1 x 1 mesh bitwise the single-device sketch (0)
# phase 14's launches a case: an example's timed call runs twice (a warm-up
# and one timed call). Written before the first card run from the gates'
# code and corrected to what the card showed (PERF.md, PR 13): (A2), (A3)
# reach K5 (their COO data, three products a QB; the prediction had the
# COO route); (A6) takes K1 for the Nystrom sketch's right product and K3
# for its test matrix; (A8)'s CountSketches K4 80; (A9) K3 31; (A10)'s
# 1 x 1 mesh took K1 where sketch_general stays staged (repaired: the
# shards ask fused_profitable); (A2s) took K5 through 1.9e9 table slots
# (repaired: spmm.BLOCKED_ELL_MAX_SLOTS). K7 fills each lazy
# sparse operator on the card once: (A1) 2, (A5) 6, (A8) 480, as the card
# showed
APP_LAUNCHES = {
    "A1": {"K3": 2, "K4": 2, "K7": 2}, "A1s": {"K3": 2, "K4": 2, "K7": 2},
    "A2": {"K3": 2, "K5": 6}, "A2s": {"K3": 2}, "A2s_resolved": {"K3": 1},
    "A3": {"K3": 6, "K5": 18}, "A4": {"K3": 16}, "A5": {"K7": 6},
    "A6": {"K1": 2, "K3": 2}, "A6s": {"K1": 2, "K3": 2}, "A7": {"K3": 5},
    "A8": {"K4": 80, "K7": 480}, "A9": {"K3": 31}, "A10": {"K3": 7},
    "A10s": {"K1": 6, "K3": 1}, "A11": {},
}
PEAK_BF16 = 989e12     # H100 SXM dense bf16 FLOP/s at 700 W (data sheet)
PEAK_F32 = 67e12       # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
D3, M3, N3, K3_NNZ = 1024, 65536, 2048, 8   # run_all.py config 3
R4, C4, D4, NNZ4 = 20000, 10000, 512, 1_000_000   # run_all.py config 4
KERNEL_NAMES = ("fused_sketch_T_kernel", "fused_sketch_kernel",
                "fused_sketch_reduce_kernel", "fill_block_T_kernel",
                "fill_block_kernel", "saso_sketch_kernel",
                "saso_reduce_kernel", "ell_spmm_kernel",
                "fill_block64_T_kernel", "fill_block64_kernel",
                "saso_fill_kernel")
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


def host_us(fn, calls=200):
    """Host microseconds per call of ``fn``, calls back to back: for a call
    whose kernels take a few microseconds, the host's own work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def k3_times(rt, fs, dev, card, shapes):
    """K3 at the paths' shapes, in each Gaussian transform (Uniform values
    take none), beside the byte bound: one call through the wrapper by CUDA
    events (median of 10, the wrapper's host work inside the window), 20
    calls back to back (per call; the host work hides behind the kernels
    where they take longer) and the kernel's device time by torch.profiler
    (20 calls). Returns the first shape's (one call, back to back, device)
    times by transform."""
    first = {}
    for label, S, rows, cols in shapes:
        bnd = bound(0.0, rows * cols * 4)
        gaussian = S.dist.family == rt.DenseDistName.Gaussian
        for transform in fs.FILL_TRANSFORMS[:2 if gaussian else 1]:
            def fill():
                return fs.fill_block(S, rows, cols, device=dev,
                                     transform=transform)

            def twenty():
                for _ in range(20):
                    fill()

            ms = time_ms(fill, reps=10)
            seq = time_ms(twenty) / 20
            dms = device_ms(fill, "fill_block")
            if S is shapes[0][1]:
                first[transform] = (ms, seq, dms)
            dev_txt = ("device time not measured" if dms is None else
                       f"device {dms:.4f} ms ({bnd[0] / dms:.0%} of the "
                       "bound)")
            print(f"time K3 {label}, {transform if gaussian else 'uniform'}"
                  f": one call {ms:.4f} ms ({bnd[0] / ms:.0%} of the bound), "
                  f"back to back {seq:.4f} ms ({bnd[0] / seq:.0%}), "
                  f"{dev_txt}; bound {bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
    S = shapes[0][1]
    blk = torch.ones(4, 4, device=dev)
    print(f"host time per call, 200 calls back to back on a 4x4 block: "
          f"fill_block {host_us(lambda: fs.fill_block(S, 4, 4, device=dev)):.1f}"
          f" us, fill_dense_submat (K3) "
          f"{host_us(lambda: S.submat(4, 4, 0, 0, device=dev)):.1f} us, one "
          f"PyTorch op (add_) {host_us(lambda: blk.add_(1.0)):.1f} us "
          f"[{card}]")
    return first


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
    sass = sass_of(library)
    if sass is None:
        print("cuobjdump not found: HGMMA not checked")
        return
    found = {}
    for block in sass.split("Function : ")[1:]:
        head = block.split("\n", 1)[0]
        name = next((k for k in WGMMA_KERNELS if k + "I" in head), None)
        if name:
            found.setdefault(name, []).append("HGMMA" in block)
        fill = re.search(r"(fill_block(?:_T)?_kernel)I(.+?)EEv", head)
        if fill:  # K3's static instruction mix, slow paths included
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                             block)
            mix = {k: sum(o.startswith(k) for o in ops)
                   for k in ("MUFU", "SHFL", "STG", "STS", "BRA")}
            print(f"SASS {fill.group(1)}[{fill.group(2)}]: {len(ops)} "
                  f"instructions, {mix}")
    for name in WGMMA_KERNELS:
        got = found.get(name, [])
        check(got and all(got), f"{name}: HGMMA missing in the SASS ({got})")
        print(f"SASS: HGMMA in all {len(got)} instantiations of {name}")


def entry(name, fn, src, line, launches, err, ms, plain, bnd, lib, **more):
    """One kernel's object of the kernels line: the kernel ``fn`` in
    csrc/<src>.cu replaces randblas_tpu/ops/<src>.py:<line>; ``more`` adds
    keys."""
    return {"name": f"{fn} ({name})", "route": "cuda",
            "source": f"randblas_tpu_torch/csrc/{src}.cu",
            "replaces": f"randblas_tpu/ops/{src}.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": lib, **more}


def fill_kernel(dev, card, S, launches):
    """K7 at (e)'s fill of ``S`` (its launches ``launches``, counted in (e)'s
    own run): the wrapper's three outputs bit for bit against the plain
    version on the card at the same seed; one call (CUDA events), 20 calls
    back to back (per call), its device time (launch_ms: CUDA events around
    20 launches queued while the card sleeps); the plain version's time (its
    ~380 launches, host-paced) and device time (torch.profiler, every
    kernel); its bound the larger of the bytes written and the operations
    bound of the SASS census of the register-log kernel at (e)'s k, at the
    card's maximum SM clock. Returns K7's kernels-line entry."""
    from randblas_tpu_torch import sparse
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import saso_fill as sf
    dim_major, dim_minor = sparse._dims(S.dist)
    k, st = S.dist.vec_nnz, S.seed_state

    def fill():
        return sf.saso_fill(st, k, dim_major, dim_minor, device=dev)

    def plain():
        return sparse.repeated_fisher_yates_reference(st, k, dim_major,
                                                      dim_minor, device=dev)

    def twenty():
        for _ in range(20):
            fill()
    major, minor, vals = fill()
    idx, sgn = plain()
    torch.cuda.synchronize()
    rows = torch.arange(dim_minor, dtype=torch.int32,
                        device=dev).repeat_interleave(k)
    err = max(abs_err(major, idx.reshape(-1)), abs_err(minor, rows),
              abs_err(vals, sgn.reshape(-1)))
    check(torch.equal(major, idx.reshape(-1)) and torch.equal(minor, rows)
          and torch.equal(vals, sgn.reshape(-1)),
          f"K7 at (e)'s fill vs its plain version: {err}")
    print(f"K7 at (e)'s fill {dim_major}x{dim_minor}, k={k}: indices and "
          "signs bitwise its plain version on the card")
    del major, minor, vals, idx, sgn, rows
    ms = time_ms(fill)
    seq = time_ms(twenty) / 20
    dms = launch_ms(fill)
    plain_ms = time_ms(plain, reps=3)
    plain_dev = all_device_ms(plain)
    n = dim_minor * k
    bnd = bound(0.0, n * (4 + 4 + 4))   # int32 rows and cols, float32 vals
    census = k7_census(k, str(_build.BUILD_DIR / "k7_census"))
    ops_txt = "operations not counted (no cuobjdump)"
    ops = None
    if census is not None:
        c = census[(st.rng, 1 if k == 1 else sf.REGISTER_LOG)]
        check(not c["loop"], f"K7 census at k={k}: a loop in {c}")
        hz = max_sm_clock()
        ops = operations_bound(c["per_vector"], dim_minor, hz)
        issue = issue_ms(c["per_vector"], dim_minor, hz)
        ops_txt = (f"operations {ops[0]:.4f} ms ({ops[1]} at "
                   f"{hz / 1e6:.0f} MHz; per vector {c['per_vector']}; "
                   f"issuing every instruction {issue:.4f} ms, not a bound)")
        if ops[0] > bnd[0]:
            bnd = (ops[0], "operations")
    print(f"time K7 (e)'s fill {dim_major}x{dim_minor}, k={k}: one call "
          f"{ms:.4f} ms ({bnd[0] / ms:.0%} of the bound), back to back "
          f"{seq:.4f} ms ({bnd[0] / seq:.0%}), device {dms:.4f} ms "
          f"({bnd[0] / dms:.0%}); bound {bnd[0]:.4f} ms ({bnd[1]}; bytes "
          f"{n * 12 / PEAK_BYTES * 1e3:.4f} ms; {ops_txt}); plain version "
          f"{plain_ms:.3f} ms, its device time "
          f"{'not measured' if plain_dev is None else f'{plain_dev:.3f} ms'}"
          f" [{card}]")
    return dict(entry("K7", "saso_fill_kernel", "saso_fill", 0, launches,
                      err, ms, plain_ms, bnd, None, device_ms=dms,
                      seq_ms=seq, plain_device_ms=plain_dev,
                      operations_ms=None if ops is None else ops[0]),
                replaces="randblas_tpu/sparse.py:82")


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
                           lambda: rt.sketch_general(S3, A3),
                           {"K4": 1, "K7": 1})
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
    k7 = fill_kernel(dev, card, S3, e_launches["K7"])

    # -- (e') the transposed full route: a right sketch by a tall SASO ----
    A3r = A3.T.contiguous()          # (2048, 65536): the data of (e')
    S3t = rt.SparseSkOp(rt.SparseDist(M3, D3, vec_nnz=K3_NNZ),
                        rt.RNGState.from_key(4))
    Be, _ = drive("(e') right sketch by a tall SASO",
                  lambda: rt.sketch_general(S3t, A3r, side="right"),
                  {"K4": 1, "K7": 1})
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
                      lambda: rt.sketch_general(S_wide, A_wide),
                      {"K4": 1, "K7": 1})
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
                  lambda: rt.sketch_sparse(S4, coo, side="left"), {"K3": 1})
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
        lambda: rt.sketch_sparse(S4b, bell, side="right"),
        {"K3": 1, "K5": 1})
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
                  {"K3": 1, "K5": 1})
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
    # the operator blocks of (f) and (g) alone: K3 (the route) and the plain
    # fill that carried them before it
    fill_times = {}
    for label, S_b, r_b, c_b in (("(f)", S4, D4, R4), ("(g)", S4b, C4, D4)):
        fill_times[label] = (
            time_ms(lambda: S_b.submat(r_b, c_b, 0, 0, device=dev)),
            time_ms(lambda: rt.dense.fill_dense_submat_reference(
                S_b.dist, S_b.seed_state, r_b, c_b, device=dev), reps=3))
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
            ("torch.sparse.mm, the data as CUDA CSR, float32 block",
             k5_lib_ms)):
        print(f"time {name}: {ms:.3f} ms [{card}]")
    # beside each path's time with the plain block fill, as this script
    # read it on an NVIDIA H100 80GB HBM3 at 700 W before K3 carried it
    for name, ms, before in (
            ("(g) sketch_sparse of the BlockedELL (K3 fill + K5)", g_ms, 4.124),
            ("(g) sketch_sparse of the COO data, conversion cached", gc_ms,
             4.777),
            ("(f) sketch_sparse of the COO data from the left (K3 fill)",
             f_ms, 9.672)):
        print(f"time {name}: {ms:.3f} ms (with the plain fill: "
              f"{before:.3f} ms) [{card}]")
    for label, (k3_fill, plain_fill) in fill_times.items():
        print(f"time {label}'s operator block alone: through K3 "
              f"{k3_fill:.3f} ms, by the plain fill {plain_fill:.3f} ms "
              f"[{card}]")
    print(f"set-up: BlockedELL.from_ell (with ELLMatrix.from_coo) on the host "
          f"{setup_s:.3f} s [{card}]")
    print(f"bounds: K4 {k4_bound[0]:.4f} ms ({k4_bound[1]}), K5 "
          f"{k5_bound[0]:.4f} ms ({k5_bound[1]}), at {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s float32 and {PEAK_BYTES / 1e12:.2f} TB/s; K4's dense "
          f"tensor-core product (2 d m n) alone "
          f"{2.0 * D3 * M3 * N3 / PEAK_BF16 * 1e3:.4f} ms at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16")

    # launches: K4 and K7 on path (e), K5 on path (g)
    return [entry("K4", "saso_sketch_kernel", "saso_sketch", 67,
                  e_launches["K4"], k4_abs, k4_ms, k4_plain_ms, k4_bound,
                  k4_lib_ms),
            entry("K5", "ell_spmm_kernel", "ell_spmm", 209, g_launches["K5"],
                  k5_abs, k5_ms, k5_plain_ms, k5_bound, k5_lib_ms)], k7


def srht_explicit(S, dev):
    """The (d, m) SRHT operator from its signs and indices, entry by entry:
    S[i, j] = sign_j (-1)^popcount(idx_i & j)."""
    signs, idx = S._sample(dev)
    x = idx.long()[:, None] & torch.arange(S.n_cols, device=dev)[None, :]
    parity = torch.zeros_like(x)
    for b in range(max(S.dist.padded_cols.bit_length() - 1, 1)):
        parity ^= (x >> b) & 1
    return (1 - 2 * parity).to(torch.float32) * signs[None, :]


def breakdown(label, fn, card, top=3, warm=True, apart=None):
    """One call of ``fn`` in a torch.profiler window: the card's busy time
    against the call's wall time (the idle share), and the ``top`` kernels
    by device time. ``warm``: one call before the window. ``apart``:
    {kernel name: device ms a launch, measured apart} for kernels the call
    launches once: where the trace lacks one (late in a long process it
    has dropped the x64 fill's kernel from such windows), its time apart
    counts as busy, and the line says so. A trace with no kernel of the
    call measures nothing: the line says "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((event_device_us(e) / 1e3, e.key) for e in
                      prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    if not kernels:
        print(f"profiler {label}: device busy and idle share not measured "
              f"(the trace recorded no kernel of the call) [{card}]")
        return
    added = {n: ms for n, ms in (apart or {}).items()
             if ms and not any(n in k for _, k in kernels)}
    kernels = sorted(kernels + [(ms, n) for n, ms in added.items()],
                     reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    heads = ", ".join(f"{name[:60]} {ms:.3f} ms"
                      for ms, name in kernels[:top])
    idle = max(0.0, 1 - busy_ms / wall_ms)
    note = (f" ({', '.join(added)} missing from the trace: its device time "
            "measured apart)" if added else "")
    print(f"profiler {label}, one call{note}: device busy {busy_ms:.3f} of "
          f"{wall_ms:.3f} ms wall (idle share {idle:.3f}); top kernels: "
          f"{heads} [{card}]")


def planted(randn, m, n, rank):
    """(A, s): an (m, n) float32 matrix U diag(s) V^T with random
    orthonormal U, V and planted singular values s: geometric decay 1 ->
    0.1 over the top ``rank``, then a 30x gap and 3e-3 -> 3e-5. rSVD's
    error on s_rank is then ~(s_(rank+9) / s_rank)^5 ~ 2e-8 (oversample 8,
    power_iters 2)."""
    U = torch.linalg.qr(randn(m, n)).Q
    V = torch.linalg.qr(randn(n, n)).Q
    i = torch.arange(n, device=U.device, dtype=torch.float64)
    sig = torch.where(i < rank, 10 ** (-i / rank),
                      3e-3 * 10 ** (-2 * (i - rank) / (n - rank))).float()
    return (U * sig) @ V.T, sig


def linalg_paths(rt, dev, drive, card, seed):
    """Phase 8: the SRHT sketch, randomized SVD, sketch-and-precondition
    least squares, sketched TLS and TensorSketch at the benchmarks' shapes,
    each against its plain check, with its launch counts and times (CUDA
    events, median of 5 after a warm-up). The data are made on the card
    from ``seed``."""
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.tensor import _countsketch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def rel(x, ref):
        return ((x.double() - ref.double()).norm() / ref.double().norm()
                ).item()

    # -- (h) SRHT sketch at the main shape, left and right --------------
    dh, mh, nh = PHASE8["h"]
    Sh = rt.TrigSkOp(rt.TrigDist(dh, mh), rt.RNGState.from_key(seed + 11))
    Ah = randn(mh, nh)
    Bh, _ = drive("(h) SRHT sketch, left", lambda: rt.sketch_general(Sh, Ah),
                  {})
    check(skge.route_counts == {"srht": 1},
          f"(h) routes {dict(skge.route_counts)}")
    Ar = Ah.T                                  # (4096, 65536), a view
    Bhr, _ = drive("(h) SRHT sketch, right, op_s='T'",
                   lambda: rt.sketch_general(Sh, Ar, side="right", op_s="T"),
                   {})
    check(Bh.shape == (dh, nh) and Bhr.shape == (nh, dh),
          f"(h) shapes {tuple(Bh.shape)} {tuple(Bhr.shape)}")
    S_exp = srht_explicit(Sh, dev)
    ref = S_exp @ Ah                 # float32, TF32 off
    h_err, hr_err = rel_err(Bh, ref), rel_err(Bhr, ref.T)
    check(h_err <= SRHT_REL_TOL and hr_err <= SRHT_REL_TOL,
          f"(h) vs the explicit operator: {h_err}, {hr_err}")
    print(f"(h) SRHT vs the explicit ({dh}, {mh}) operator's float32 "
          f"product: left {h_err:.3g}, right {hr_err:.3g} <= "
          f"{SRHT_REL_TOL} (normalised by max |ref|)")
    h_ms = time_ms(lambda: rt.sketch_general(Sh, Ah))
    hr_ms = time_ms(lambda: rt.sketch_general(Sh, Ar, side="right",
                                              op_s="T"))
    h_lib = time_ms(lambda: torch.matmul(S_exp, Ah))
    print(f"time (h) SRHT sketch_general {dh}x{mh} @ {mh}x{nh}: left "
          f"{h_ms:.3f} ms, right op_s='T' {hr_ms:.3f} ms; the explicit "
          f"operator's float32 torch.matmul {h_lib:.3f} ms [{card}]")
    breakdown("(h) SRHT left", lambda: rt.sketch_general(Sh, Ah), card)
    del Sh, Ah, Ar, Bh, Bhr, S_exp, ref

    # -- (i) rSVD at linalg_bench.py's shape -----------------------------
    mi, ni, rank = PHASE8["i"]
    Ai, sig = planted(randn, mi, ni, rank)
    # the singular values of A, in float64 (cuSOLVER's float32 SVD of A is
    # the looser reference: its error is printed beside)
    t0 = time.perf_counter()
    sv = torch.linalg.svdvals(Ai.double())[:rank].float()
    sv_s = time.perf_counter() - t0
    e32 = ((torch.linalg.svdvals(Ai)[:rank] - sig[:rank]).abs().max()
           / sig[0]).item()
    print(f"(i) A = U diag(s) V^T, {mi}x{ni}: float64 svdvals of A vs the "
          f"planted s {((sv - sig[:rank]).abs().max() / sig[0]).item():.3g} "
          f"({sv_s:.1f} s); float32 svdvals of A vs the planted s {e32:.3g}")
    st_i = rt.RNGState.from_key(seed + 12)
    rs = {}
    for op, expect in (("gaussian", {"K3": 1}), ("srht", {})):
        (u, s, vt), _ = drive(f"(i) rsvd, {op}",
                              lambda: la.rsvd(Ai, rank, st_i, operator=op),
                              expect)
        check(u.shape == (mi, rank) and vt.shape == (rank, ni)
              and bool(torch.isfinite(u).all()), f"(i) {op} factors")
        e_sig = ((s - sig[:rank]).abs().max() / sig[0]).item()
        e_sv = ((s - sv).abs().max() / sv[0]).item()
        check(e_sig <= RSVD_TOL and e_sv <= RSVD_TOL,
              f"(i) {op}: {e_sig}, {e_sv}")
        rs[op] = time_ms(lambda: la.rsvd(Ai, rank, st_i, operator=op))
        print(f"(i) rsvd {op}: top-{rank} singular values vs the planted "
              f"ones {e_sig:.3g}, vs float64 svdvals(A) {e_sv:.3g} <= "
              f"{RSVD_TOL} (max abs err / s_1); {rs[op]:.3f} ms [{card}]")
        breakdown(f"(i) rsvd {op}",
                  lambda: la.rsvd(Ai, rank, st_i, operator=op), card)
    lib = time_ms(lambda: torch.svd_lowrank(Ai, q=rank + 8, niter=2))
    s_lib = torch.svd_lowrank(Ai, q=rank + 8, niter=2)[1][:rank]
    e_lib = ((s_lib - sig[:rank]).abs().max() / sig[0]).item()
    print(f"time (i) torch.svd_lowrank(A, q={rank + 8}, niter=2) {lib:.3f} "
          f"ms, its top-{rank} vs the planted {e_lib:.3g} [{card}]")
    # cholqr with TF32 allowed by the caller: its products stay float32
    S_i = rt.DenseSkOp(rt.DenseDist(ni, rank + 8), st_i)
    y = Ai @ S_i.materialize(device=dev)       # the rangefinder's sketch
    eye = torch.eye(rank + 8, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        q, _ = la.cholqr(y)
        kept = torch.backends.cuda.matmul.allow_tf32
        g = y.T @ y                             # a TF32 Gram, for contrast
        naive, info = torch.linalg.cholesky_ex(0.5 * (g + g.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    orth = (q.T @ q - eye).abs().max().item()
    check(kept, "cholqr did not restore the caller's allow_tf32")
    check(orth <= ORTH_TOL, f"(i) cholqr under TF32: |Q^T Q - I| {orth}")
    qn = torch.linalg.solve_triangular(naive, y.T, upper=False).T
    naive_orth = (qn.T @ qn - eye).abs().max().item()
    print(f"(i) cholqr of the {mi}x{rank + 8} sketch with allow_tf32 on: "
          f"max |Q^T Q - I| {orth:.3g} <= {ORTH_TOL}, the flag restored; "
          f"one CholQR pass on a TF32 Gram: {naive_orth:.3g} (Cholesky info "
          f"{int(info)})")
    del Ai, sv, y, q, qn

    # -- (j) sketch-and-precondition least squares -----------------------
    mj, nj, dj = PHASE8["j"]
    Aj = randn(mj, nj) * torch.logspace(0, -3, nj, device=dev)  # cond ~1e3
    bj = Aj @ randn(nj) + 1e-3 * randn(mj)
    x64 = torch.linalg.lstsq(Aj.double(), bj.double()[:, None]).solution[:, 0]
    st_j = rt.RNGState.from_key(seed + 13)
    # A through the kernels; b (one column) through the routes the gates
    # give a vector: the fixed-nnz route (d m = 2^29) and the staged one
    for op, expect, route in (
            ("saso", {"K4": 1, "K7": 2},
             {"sparse_saso_kernel": 1, "sparse_fixed_nnz": 1}),
            ("gaussian", {"K1": 1, "K3": 1},
             {"left_fused": 1, "left_staged": 1})):
        (x, iters, _), _ = drive(
            f"(j) sketch_and_precondition, {op}",
            lambda: la.sketch_and_precondition(Aj, bj, st_j, operator=op),
            expect)
        check(skge.route_counts == route,
              f"(j) {op} routes {dict(skge.route_counts)}")
        err = rel(x, x64)
        check(err <= LSQ_TOL, f"(j) {op}: rel err {err}")
        ms = time_ms(lambda: la.sketch_and_precondition(Aj, bj, st_j,
                                                        operator=op))
        print(f"(j) {op} (d={dj}): {iters} CGLS iterations, x vs float64 "
              f"torch.linalg.lstsq {err:.3g} <= {LSQ_TOL}; {ms:.3f} ms "
              f"[{card}]")
        breakdown(f"(j) {op}", lambda: la.sketch_and_precondition(
            Aj, bj, st_j, operator=op), card)
    lib = time_ms(lambda: torch.linalg.lstsq(Aj, bj[:, None]))
    lib_err = rel(torch.linalg.lstsq(Aj, bj[:, None]).solution[:, 0], x64)
    Sj = rt.SparseSkOp(rt.SparseDist(dj, mj, vec_nnz=8), st_j)
    fy = time_ms(lambda: Sj.filled(dev))
    print(f"time (j) float32 torch.linalg.lstsq {lib:.3f} ms (x vs float64 "
          f"{lib_err:.3g}); the Fisher-Yates fill of SparseDist({dj}, {mj}, "
          f"8) alone {fy:.3f} ms [{card}]")
    del Aj, bj, x64

    # -- (k) sketched TLS in float64, run_all.py config 1 ----------------
    mk, nk, dk = PHASE8["k"]
    Ak = randn(mk, nk, dtype=torch.float64)
    bk = Ak @ randn(nk, dtype=torch.float64) + 1e-2 * randn(
        mk, dtype=torch.float64)
    ab = torch.cat([Ak, bk[:, None]], dim=1)
    del Ak, bk
    Sk = rt.DenseSkOp(rt.DenseDist(dk, mk), rt.RNGState.from_key(seed + 14),
                      dtype=torch.float64)
    xs, _ = drive("(k) sketched_tls, float64", lambda: la.sketched_tls(Sk, ab),
                  {"K3": 1})
    check(skge.route_counts == {"left_staged": 1},
          f"(k) routes {dict(skge.route_counts)}")
    gram = ab.T @ ab
    v = torch.linalg.eigh(gram)[1][:, 0]
    xe = -v[:-1] / v[-1]                        # exact TLS of [A b]
    r_norm = (ab @ torch.cat([xe, xe.new_ones(1).neg()])).norm()
    s_min = torch.linalg.eigvalsh(gram[:nk, :nk])[0].sqrt()
    # Gaussian sketch-and-solve: E ||A (x_s - x)||^2 = n / (d - n - 1)
    # ||r||^2, so ||x_s - x|| / ||x|| is about sqrt(n / (d - n - 1)) ||r||
    # / (s_min ||x||); TLS_SLACK times that
    tls_bound = (TLS_SLACK * (nk / (dk - nk - 1)) ** 0.5 * r_norm
                 / (s_min * xe.norm())).item()
    err = rel(xs, xe)
    check(err <= tls_bound, f"(k) rel err {err} > {tls_bound}")
    ms = time_ms(lambda: la.sketched_tls(Sk, ab))
    print(f"(k) sketched TLS ({dk} x {mk} float64 operator, [A b] "
          f"{mk} x {nk + 1}) vs exact TLS (eigh of the Gram): {err:.3g} <= "
          f"{tls_bound:.3g}; {ms:.3f} ms [{card}]")
    breakdown("(k) sketched TLS", lambda: la.sketched_tls(Sk, ab), card)
    del ab, gram

    # -- (l) TensorSketch at linalg_bench.py's shape ---------------------
    ml, nl, dl = PHASE8["l"]
    A1, A2 = randn(ml, nl), randn(ml, nl)
    st_l = rt.RNGState.from_key(seed + 15)
    (ts, _), _ = drive("(l) tensor_sketch of two factors",
                       lambda: rt.tensor_sketch([A1, A2], dl, st_l),
                       {"K4": 2, "K7": 2})
    check(skge.route_counts == {"sparse_saso_kernel": 2},
          f"(l) routes {dict(skge.route_counts)}")
    C1 = _countsketch(dl, ml, st_l).filled(dev)
    C2 = _countsketch(dl, ml, C1.next_state).filled(dev)

    def conv(cast):
        """The circular convolution of the factors' CountSketches, in
        float64, term by term (O(d^2 n))."""
        c1, c2 = (torch.zeros(dl, nl, dtype=torch.float64, device=dev)
                  .index_add_(0, C.rows.long(),
                              C.vals.double()[:, None] * cast(A).double())
                  for C, A in ((C1, A1), (C2, A2)))
        r = torch.arange(dl, device=dev)
        return torch.einsum("ran,an->rn", c2[(r[:, None] - r[None, :]) % dl],
                            c1)

    # K4 contracts the factors rounded to bf16: the same rounding here
    ref = conv(lambda A: A.to(torch.bfloat16))
    err = rel_err(ts, ref)
    check(err <= TS_REL_TOL, f"(l) vs the direct convolution: {err}")
    err32 = rel_err(ts, conv(lambda A: A))
    ms = time_ms(lambda: rt.tensor_sketch([A1, A2], dl, st_l))
    print(f"(l) tensor_sketch vs the direct float64 convolution of the "
          f"CountSketches of the bf16-rounded factors: {err:.3g} <= "
          f"{TS_REL_TOL}; of the float32 factors {err32:.3g}; {ms:.3f} ms "
          f"[{card}]")
    breakdown("(l) tensor_sketch",
              lambda: rt.tensor_sketch([A1, A2], dl, st_l), card)


def solver_paths(rt, dev, drive, card, seed):
    """Phase 9: the x64 sketch and linalg groups 2-3 at the benchmarks'
    shapes, paths (m) to (v), each against its check, with its routes,
    launch counts, time (CUDA events, median of 5 after a warm-up) beside
    the library call's where there is one, and one profiled call. The data
    are made on the card from ``seed``. Each path is a function, so its
    tensors are freed before the next one starts."""
    import math
    from randblas_tpu_torch import dense as tdense
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import native, skge
    import importlib
    from randblas_tpu_torch.linalg import qb, rgs
    from randblas_tpu_torch.linalg.embed import make_embedding
    # the module, not the function of the same name that linalg exports
    sg = importlib.import_module("randblas_tpu_torch.linalg.sgmres")
    from randblas_tpu_torch.ops import fused_sketch as fs
    from randblas_tpu_torch.ops import x64_fill

    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def eye(n, dtype=torch.float32):
        return torch.eye(n, device=dev, dtype=dtype)

    def rel(x, ref):
        return ((x.double() - ref.double()).norm() / ref.double().norm()
                ).item()

    def routes(label, want):
        check(dict(skge.route_counts) == want,
              f"{label} routes {dict(skge.route_counts)}, expected {want}")

    def top_abs(w, k):
        """The k values of largest magnitude, ascending."""
        return torch.sort(w[torch.argsort(w.abs(), descending=True)[:k]])[0]

    def timed(label, fn, lib=None, lib_name=""):
        ms = time_ms(fn)
        lib_txt = ("" if lib is None
                   else f"; {lib_name} {time_ms(lib):.3f} ms")
        print(f"time {label}: {ms:.3f} ms{lib_txt} [{card}]")
        return ms

    # -- (m) the x64 sketch: K6 fills on the card, float64 GEMM ------------
    k6 = {}
    census = {}

    def k6_operations(kernel, S, values):
        """(ms, text): the operations bound of K6's instantiation for S at
        ``values`` values, from the census of the built library's SASS
        (the busiest arithmetic pipe) at the card's maximum SM clock, and
        a text naming that pipe and the time to issue every instruction
        (a diagnostic, not a bound); None where the toolkit has no
        cuobjdump."""
        from randblas_tpu_torch.ops import _build
        if not census:
            sass = sass_of(_build.LIBRARY)
            if sass is None:
                return None
            text = (_build._PKG / "csrc" / "x64_fill.cu").read_text()
            census.update(k6_census(sass, k6_values_per_iter(text)),
                          sm_hz=max_sm_clock())
        gauss = S.dist.family == rt.DenseDistName.Gaussian
        per_value = census[(kernel, S.seed_state.rng, gauss)]["per_value"]
        hz = census["sm_hz"]
        ms, pipe = operations_bound(per_value, values, hz)
        issue = issue_ms(per_value, values, hz)
        return ms, (f"{pipe} at {hz / 1e6:.0f} MHz; issuing every "
                    f"instruction {issue:.4f} ms, not a bound")

    def host_ulps(label, op_, rows, cols, fam):
        """K6's (rows, cols) block of ``op_`` against the native and numpy
        host engines' (Uniform bitwise, Gaussian within
        X64_CARD_GAUSS_ULP), and the engines against each other."""
        check(native.available(), f"{label} the native host engine did not "
              "build (into randblas_tpu_torch/_build/)")
        card_blk = op_.submat(rows, cols, 0, 0, device=dev).cpu().numpy()
        native_blk = op_.submat(rows, cols, 0, 0, device="cpu").numpy()
        with rt.flags(use_native_x64=False):
            numpy_blk = op_.submat(rows, cols, 0, 0, device="cpu").numpy()

        def ulps(got, want):
            return float(np.max(np.abs(got - want)
                                / np.spacing(np.abs(want))))
        u_nn = ulps(native_blk, numpy_blk)
        u_cn, u_cp = ulps(card_blk, native_blk), ulps(card_blk, numpy_blk)
        gauss = fam == "Gaussian"
        check(u_nn <= X64_GAUSS_ULP if gauss else u_nn == 0,
              f"{label} {fam}: native vs numpy {u_nn} ulp")
        check(max(u_cn, u_cp) <= X64_CARD_GAUSS_ULP if gauss
              else u_cn == u_cp == 0,
              f"{label} {fam}: K6 vs native {u_cn}, vs numpy {u_cp} ulp")
        print(f"{label} {op_.seed_state.rng} {fam} ({rows}, {cols}) block: "
              f"K6 vs the native engine {u_cn:.0f} ulp, vs the numpy "
              f"engine {u_cp:.0f} ulp (Uniform bitwise, Gaussian <= "
              f"{X64_CARD_GAUSS_ULP}); native vs numpy {u_nn:.0f} ulp "
              f"(Gaussian <= {X64_GAUSS_ULP})")

    def k6_times(label, S, rows, cols, kernel):
        """K6 at a path's block: one call through the wrapper (CUDA
        events), 20 calls back to back (per call), its device time
        (kernel_variants.launch_ms: CUDA events around 20 launches queued
        while the card sleeps), its plain version, and the host engine's
        fill of the same block that the path ran before K6 (host clock,
        median of 3); its bound the larger of the bytes written and the
        operations bound of the census of the built kernel's SASS."""
        def fill():
            return x64_fill.fill_block64(S, rows, cols, device=dev)

        def twenty():
            for _ in range(20):
                fill()
        ms = time_ms(fill)
        seq = time_ms(twenty) / 20
        dms = launch_ms(fill)
        plain = time_ms(lambda: x64_fill.fill_block64_reference(
            S, rows, cols, device=dev), reps=3)
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            S.materialize(device="cpu")
            host.append((time.perf_counter() - t0) * 1e3)
        bnd = bound(0.0, rows * cols * 8)
        ops = k6_operations(kernel, S, rows * cols)
        if ops is not None and ops[0] > bnd[0]:
            bnd = (ops[0], "operations")
        ops_txt = ("operations not counted (no cuobjdump)" if ops is None
                   else f"operations {ops[0]:.4f} ms ({ops[1]})")
        dev_txt = f"device {dms:.4f} ms ({bnd[0] / dms:.0%} of the bound)"
        print(f"time K6 {label} {rows}x{cols}: one call {ms:.4f} ms "
              f"({bnd[0] / ms:.0%} of the bound), back to back {seq:.4f} "
              f"ms ({bnd[0] / seq:.0%}), {dev_txt}; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}; {ops_txt}); plain version "
              f"{plain:.3f} ms; "
              f"the host engine's fill of the block {sorted(host)[1]:.3f} "
              f"ms (host clock) [{card}]")
        return ms, seq, dms, plain, bnd

    def path_m():
        dm, mm, nm = PHASE9["m"]
        Am = randn(mm, nm, dtype=torch.float64)
        for fam in ("Gaussian", "Uniform"):
            dist = rt.DenseDist(dm, mm, rt.DenseDistName[fam])
            Sm = rt.DenseSkOp(dist, rt.RNGState.from_key(seed + 21,
                                                          "philox4x64"))
            check(Sm.dtype == torch.float64, f"(m) dtype {Sm.dtype}")
            tdense.x64_engine_counts.clear()
            Bm, got = drive(f"(m) x64 sketch {dm}x{mm} @ {mm}x{nm}, {fam}",
                            lambda: rt.sketch_general(Sm, Am), {"K6": 1})
            routes("(m)", {"left_staged": 1})
            check(dict(tdense.x64_engine_counts) == {"card": 1},
                  f"(m) engines {dict(tdense.x64_engine_counts)}")
            S_mat = Sm.materialize(device=dev)
            err = rel_err(Bm, torch.matmul(S_mat, Am))
            check(err <= X64_PROD_TOL, f"(m) {fam} product: {err}")
            want = x64_fill.fill_block64_reference(Sm, dm, mm, device=dev)
            k6_err = abs_err(S_mat, want)
            check(torch.equal(S_mat, want),
                  f"(m) {fam}: K6 vs its plain version {k6_err}")
            del want
            print(f"(m) {fam}: K6 bitwise its plain version on the card")
            for rng, cols in (("philox4x64", mm), ("threefry4x64", 4096)):
                op_ = rt.DenseSkOp(
                    rt.DenseDist(dm, cols, rt.DenseDistName[fam]),
                    rt.RNGState.from_key(seed + 21, rng))
                host_ulps("(m)", op_, min(64, dm), cols, fam)
            ms, seq, dms, plain, bnd = k6_times(f"(m) {fam}", Sm, dm, mm,
                                                "fill_block64_kernel")
            prod_ms = time_ms(lambda: torch.matmul(S_mat, Am))
            call_ms = timed(f"(m) x64 sketch_general, {fam}",
                            lambda: rt.sketch_general(Sm, Am))
            print(f"(m) {fam}: vs torch.matmul of the materialised operator "
                  f"{err:.3g} <= {X64_PROD_TOL}; K6 {ms:.3f} ms, float64 "
                  f"product {prod_ms:.3f} ms, the call {call_ms:.3f} ms "
                  f"[{card}]")
            if fam == "Gaussian":
                k6.update(launches=got["K6"], err=k6_err, ms=ms, seq_ms=seq,
                          device_ms=dms, plain_ms=plain, bound=bnd)
                breakdown("(m) x64 sketch", lambda: rt.sketch_general(Sm, Am),
                          card, apart={"fill_block64_kernel": dms})
            del S_mat, Bm

    # -- (m') the ColMajor-natural x64 sketch from the right: K6's T kernel -
    def path_m_right():
        dm, mm, nm = PHASE9["m"]
        # its own generator, so that the data of the paths after it are
        # those they had before (m') was added
        Ar = torch.randn(nm, mm, device=dev, dtype=torch.float64,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed + 22))
        Sr = rt.DenseSkOp(rt.DenseDist(mm, dm),
                          rt.RNGState.from_key(seed + 22, "threefry2x64"))
        check(rt.dist_to_layout(Sr.dist) == rt.Layout.ColMajor,
              "(m') the operator is not ColMajor-natural")
        tdense.x64_engine_counts.clear()
        Br, got = drive(f"(m') x64 right sketch {nm}x{mm} @ {mm}x{dm}, "
                        "Threefry2x64", lambda: rt.sketch_general(
                            Sr, Ar, side="right"), {"K6": 1})
        routes("(m')", {"right_staged": 1})
        check(dict(tdense.x64_engine_counts) == {"card": 1},
              f"(m') engines {dict(tdense.x64_engine_counts)}")
        S_mat = Sr.materialize(device=dev)
        err = rel_err(Br, torch.matmul(Ar, S_mat))
        check(err <= X64_PROD_TOL, f"(m') product: {err}")
        want = x64_fill.fill_block64_reference(Sr, mm, dm, device=dev)
        k6_err = abs_err(S_mat, want)
        check(torch.equal(S_mat, want),
              f"(m') K6 (T) vs its plain version {k6_err}")
        del want
        print("(m') K6's fill_block64_T_kernel bitwise its plain version on "
              "the card")
        host_ulps("(m')", Sr, 4096, dm, "Gaussian")
        ms, seq, dms, plain, bnd = k6_times(
            "(m') ColMajor, math orientation", Sr, mm, dm,
            "fill_block64_T_kernel")
        call_ms = timed("(m') x64 sketch_general, right",
                        lambda: rt.sketch_general(Sr, Ar, side="right"))
        print(f"(m'): vs the materialised operator's product {err:.3g} <= "
              f"{X64_PROD_TOL}; the call {call_ms:.3f} ms [{card}]")
        k6.update(colmajor_launches=got["K6"], colmajor_err=k6_err,
                  colmajor_ms=ms, colmajor_seq_ms=seq,
                  colmajor_device_ms=dms,
                  colmajor_plain_ms=plain, colmajor_bound_ms=bnd[0],
                  colmajor_bound_by=bnd[1])
        breakdown("(m') x64 right sketch",
                  lambda: rt.sketch_general(Sr, Ar, side="right"), card,
                  apart={"fill_block64_T_kernel": dms})
        del S_mat, Br

    # -- (n) Nystrom PCG and RPCholesky PCG -------------------------------
    def path_n():
        nn, gk, dn = PHASE9["n"]
        G = randn(nn, gk) / 8.0
        An = G @ G.T + 0.1 * eye(nn)
        bn = randn(nn)
        mu = 1e-3
        x64n = torch.linalg.solve(An.double() + mu * eye(nn, torch.float64),
                                  bn.double())
        st_n = rt.RNGState.from_key(seed + 23)
        om = rt.DenseSkOp(rt.DenseDist(nn, dn), st_n).materialize(
            device=dev).double()
        gram = torch.linalg.eigvalsh(om.T @ An.double() @ om)
        u, lam, _ = la.nystrom(An, dn, st_n)
        print(f"(n) nystrom's shifted Cholesky of the Gram (sketch by the "
              f"right_fused route, K1): "
              f"{'succeeded' if bool(torch.isfinite(lam).all()) else 'FAILED'}"
              f"; lam[0] {lam[0].item():.6g}, lam[{gk - 1}] "
              f"{lam[gk - 1].item():.6g}, lam[{gk}] {lam[gk].item():.6g} "
              f"(exact: ~{nn / gk:.0f} and 0.1); the Gram Omega^T A Omega's "
              f"eigenvalues (float64) {gram[0].item():.4g} to "
              f"{gram[-1].item():.4g}")
        for name, fn, expect, want_routes in (
                ("nystrom_pcg", lambda: la.nystrom_pcg(
                    An, bn, st_n, d=dn, mu=mu, tol=1e-5, maxiter=60),
                 {"K1": 1, "K3": 1}, {"right_fused": 1}),
                ("rpcholesky_pcg", lambda: la.rpcholesky_pcg(
                    An, bn, st_n, rank=dn, mu=mu, tol=1e-5, maxiter=60),
                 {}, {})):
            (x, iters, _), _ = drive(f"(n) {name}, n={nn}, d=rank={dn}", fn,
                                     expect)
            routes(f"(n) {name}", want_routes)
            res = ((An.double() @ x.double() + mu * x.double() - bn.double())
                   .norm() / bn.double().norm()).item()
            err = rel(x, x64n)
            check(res <= PCG_RES_TOL and err <= PCG_X_TOL,
                  f"(n) {name}: residual {res}, error {err}")
            ms = timed(f"(n) {name}", fn)
            print(f"(n) {name}: {iters} PCG iterations, ||(A + mu I) x - b||"
                  f" / ||b|| {res:.3g} <= {PCG_RES_TOL}, x vs float64 solve "
                  f"{err:.3g} <= {PCG_X_TOL}; {ms:.3f} ms [{card}]")
            breakdown(f"(n) {name}", fn, card)
        Anm = An + mu * eye(nn)
        lib = time_ms(lambda: torch.linalg.solve(Anm, bn))
        print(f"time (n) float32 torch.linalg.solve {lib:.3f} ms, x vs "
              f"float64 "
              f"{rel(torch.linalg.solve(Anm, bn), x64n):.3g} [{card}]")

    # -- (o) trace and diagonal of an implicit Gram -----------------------
    def path_o():
        no, ko, budget = PHASE9["o"]
        Go = randn(no, ko) / math.sqrt(ko)
        Gc = Go.cpu()
        fro2 = (Go.double() ** 2).sum().item()
        st_o = rt.RNGState.from_key(seed + 24)
        for name, fn, expect in (
                ("xtrace", la.xtrace, {"K3": 1}),
                ("xdiag", la.xdiag, {"K3": 1}),
                ("hutchpp", la.hutchpp, {"K3": 2})):
            def call(g=Go, device=dev, fn=fn):
                return fn(lambda x: g @ (g.T @ x), no, budget, st_o,
                          device=device)
            out, _ = drive(f"(o) {name}, implicit Gram {no}x{ko}, budget "
                           f"{budget}", call, expect)
            cpu = call(Gc, "cpu")
            err = rel(out[0].cpu(), cpu[0])
            check(err <= TRACE_CPU_TOL, f"(o) {name}: card vs CPU {err}")
            extra = ""
            if name == "xtrace":
                est, se = out[0].item(), out[1].item()
                check(abs(est - fro2) <= 5 * se,
                      f"(o) xtrace {est} vs {fro2}, stderr {se}")
                extra = (f"; estimate {est:.6g} vs ||G||_F^2 {fro2:.6g}, "
                         f"|diff| {abs(est - fro2) / se:.2f} stderr (<= 5)")
            ms = timed(f"(o) {name}", call)
            print(f"(o) {name}: the card vs the same call on the CPU "
                  f"{err:.3g} "
                  f"<= {TRACE_CPU_TOL}{extra}; {ms:.3f} ms [{card}]")
            breakdown(f"(o) {name}", call, card)
        # test_tpu_hardware.py:447-475's controlled spectrum, with its bounds
        n_c = 1024
        uc = torch.linalg.qr(randn(n_c, n_c, dtype=torch.float64)).Q
        lam_c = 2.0 ** (-torch.arange(n_c, device=dev,
                                      dtype=torch.float64) / 8)
        a64 = (uc * lam_c) @ uc.T
        ac = a64.float()
        (est, se, _), _ = drive("(o) xtrace, controlled spectrum n=1024",
                                lambda: la.xtrace(ac, n_c, 96,
                                                  rt.RNGState.from_key(37)),
                                {"K3": 1})
        want_tr = lam_c.sum().item()
        check(abs(est.item() - want_tr) < max(6 * se.item(), 5e-3 * want_tr),
              f"(o) controlled xtrace {est.item()} vs {want_tr}")
        (dc, _), _ = drive("(o) xdiag, controlled spectrum n=1024",
                           lambda: la.xdiag(ac, n_c, 96,
                                            rt.RNGState.from_key(38)),
                           {"K3": 1})
        d_err = rel(dc, torch.diagonal(a64))
        check(d_err < 0.08, f"(o) controlled xdiag {d_err}")
        print(f"(o) controlled spectrum (test_tpu_hardware.py:447-475): "
              f"xtrace {est.item():.6g} vs {want_tr:.6g} (|diff| "
              f"{abs(est.item() - want_tr):.3g}"
              f" < max(6 stderr, 5e-3 tr) = "
              f"{max(6 * se.item(), 5e-3 * want_tr):.3g}); xdiag "
              f"{d_err:.3g} < 0.08")

    # -- (p) leverage scores and sample_lsq -------------------------------
    def path_p():
        mp, np_, sp = PHASE9["p"]
        Ap = randn(mp, np_)
        bp = randn(mp)
        st_p = rt.RNGState.from_key(seed + 25)
        (scores, _), _ = drive(f"(p) leverage_scores {mp}x{np_}, saso",
                               lambda: la.leverage_scores(Ap, st_p),
                               {"K4": 1, "K7": 1})
        routes("(p)", {"sparse_saso_kernel": 1})
        A64 = Ap.double()
        q64, r64 = torch.linalg.qr(A64)
        exact = (q64 * q64).sum(dim=1)
        ratio = scores.double() / exact
        lo, hi, med = ratio.min().item(), ratio.max().item(), \
            ratio.median().item()
        check(LEV_RATIO[0] <= lo and hi <= LEV_RATIO[1],
              f"(p) score ratios {lo}, {hi}")
        (s8, _), _ = drive("(p) leverage_scores, embed_factor 8",
                           lambda: la.leverage_scores(Ap, st_p,
                                                      embed_factor=8),
                           {"K4": 1, "K7": 1})
        ratio8 = s8.double() / exact
        lo8, hi8, med8 = ratio8.min().item(), ratio8.max().item(), \
            ratio8.median().item()
        check(LEV_RATIO[0] <= lo8 and hi8 <= LEV_RATIO[1]
              and LEV_MEDIAN[0] <= med8 <= LEV_MEDIAN[1],
              f"(p) embed_factor 8: score ratios {lo8}, {hi8}, median {med8}")
        x_opt = torch.linalg.solve_triangular(
            r64, (q64.T @ bp.double())[:, None], upper=True)[:, 0]
        r_opt = (A64 @ x_opt - bp.double()).norm().item()
        del q64, r64
        ms = timed("(p) leverage_scores", lambda: la.leverage_scores(Ap, st_p))
        bias = [d_ / (d_ - np_ - 1) for d_ in (4 * np_, 8 * np_)]
        print(f"(p) leverage scores / exact (float64 QR): embed_factor 4 (the "
              f"bench's) min {lo:.3f}, max {hi:.3f} in {LEV_RATIO}, median "
              f"{med:.3f} (the estimate's bias d/(d-n-1) {bias[0]:.3f}); "
              f"embed_factor 8 min {lo8:.3f}, max {hi8:.3f}, median "
              f"{med8:.3f} "
              f"in {LEV_MEDIAN} (bias {bias[1]:.3f}); {ms:.3f} ms [{card}]")
        breakdown("(p) leverage_scores", lambda: la.leverage_scores(Ap, st_p),
                  card)
        (xs, _), _ = drive(f"(p) sample_lsq, s={sp}",
                           lambda: la.sample_lsq(Ap, bp, sp, st_p),
                           {"K4": 1, "K7": 1})
        ratio = (A64 @ xs.double() - bp.double()).norm().item() / r_opt
        check(ratio <= LSQ_SLACK, f"(p) sample_lsq residual ratio {ratio}")
        ms = timed("(p) sample_lsq", lambda: la.sample_lsq(Ap, bp, sp, st_p),
                   lambda: torch.linalg.lstsq(Ap, bp[:, None]),
                   "float32 torch.linalg.lstsq of the whole system")
        print(f"(p) sample_lsq: residual / float64 least-squares optimum "
              f"{ratio:.4f} <= {LSQ_SLACK}; {ms:.3f} ms [{card}]")
        breakdown("(p) sample_lsq", lambda: la.sample_lsq(Ap, bp, sp, st_p),
                  card)

    # -- (q) approximate matrix multiplication ----------------------------
    def path_q():
        mq, nq, pq, sq = PHASE9["q"]
        Aq, Bq = randn(mq, nq), randn(nq, pq)
        st_q = rt.RNGState.from_key(seed + 26)
        (est, _), _ = drive(f"(q) amm {mq}x{nq} @ {nq}x{pq}, s={sq}",
                            lambda: la.amm(Aq, Bq, sq, st_q), {})
        exact = Aq.double() @ Bq.double()
        err = (est.double() - exact).norm().item()
        bnd = AMM_SLACK * (Aq.double().norm() * Bq.double().norm()).item() \
            / math.sqrt(sq)
        check(err <= bnd, f"(q) ||est - AB||_F {err} > {bnd}")
        del exact
        ms = timed("(q) amm", lambda: la.amm(Aq, Bq, sq, st_q),
                   lambda: torch.matmul(Aq, Bq),
                   "float32 torch.matmul of the whole product")
        print(f"(q) amm: ||est - AB||_F {err:.6g} <= 3 ||A||_F ||B||_F / "
              f"sqrt(s) = {bnd:.6g} (ratio {err / bnd * AMM_SLACK:.3f} of the "
              f"expected error); {ms:.3f} ms [{card}]")
        breakdown("(q) amm", lambda: la.amm(Aq, Bq, sq, st_q), card)

    # -- (r) random Fourier features --------------------------------------
    def path_r():
        nr, dr, feat = PHASE9["r"]
        xr = randn(nr, dr)
        st_r = rt.RNGState.from_key(seed + 27)
        (z, _), _ = drive(f"(r) random_fourier_features {nr}x{dr} -> {feat}",
                          lambda: la.random_fourier_features(xr, feat, 1.0,
                                                             st_r),
                          {"K2": 1, "K3": 1})
        routes("(r)", {"left_colmajor_fused": 1})
        W = rt.DenseSkOp(rt.DenseDist(feat, dr), st_r)
        phases = rt.DenseSkOp(rt.DenseDist(1, feat, rt.DenseDistName.Uniform),
                              W.next_state).materialize(device=dev)[0]
        b_ph = (phases / math.sqrt(3.0) * 0.5 + 0.5) * (2.0 * math.pi)
        zmax = math.sqrt(2.0 / feat)
        # the projection by K2's plain version: the operator in the fused
        # kernels' transform, both operands rounded to bf16, a float32
        # product; and by the float32 materialised W (the staged fill)
        proj_k2 = fs.fused_sketch_colmajor_reference(W, xr.T).T
        w_mat = W.materialize(device=dev)
        err_k2 = abs_err(z, zmax * torch.cos(proj_k2 + b_ph)) / zmax
        err_32 = abs_err(z, zmax * torch.cos(xr @ w_mat.T + b_ph)) / zmax
        check(err_k2 <= RFF_TOL, f"(r) vs K2's plain projection {err_k2}")
        bw = math.sqrt(dr)
        x1 = xr[:1024]
        z1, _ = la.random_fourier_features(x1, feat, bw, st_r)
        kern = torch.exp(-torch.cdist(x1.double(), x1.double()) ** 2
                         / (2 * bw * bw))
        k_err = (z1.double() @ z1.double().T - kern).abs().max().item()
        check(k_err <= RFF_KERNEL / math.sqrt(feat),
              f"(r) kernel approximation {k_err}")
        ms = timed("(r) random_fourier_features, bandwidth 1",
                   lambda: la.random_fourier_features(xr, feat, 1.0, st_r),
                   lambda: zmax * torch.cos(xr @ w_mat.T + b_ph),
                   "the float32 formula on the materialised W")
        print(f"(r) z vs sqrt(2/D) cos(x W^T + b) with K2's plain projection "
              f"(bf16 operands) {err_k2:.3g} <= {RFF_TOL}, with the float32 "
              f"x and W {err_32:.3g} (the route's operand rounding; both / "
              f"sqrt(2/D)); z z^T vs the RBF kernel at bw = sqrt({dr}) on "
              f"{len(x1)} points {k_err:.4f} <= 5/sqrt(D) = "
              f"{RFF_KERNEL / math.sqrt(feat):.4f} (kernel mean "
              f"{kern.mean().item():.3f}); {ms:.3f} ms [{card}]")
        breakdown("(r) random_fourier_features",
                  lambda: la.random_fourier_features(xr, feat, 1.0, st_r),
                  card)

    # -- (s) Krylov SVD, ID / CUR and the spectral norm on (i)'s matrix ---
    def path_s():
        ms_, ns, rank = PHASE9["s"]
        As, sig = planted(randn, ms_, ns, rank)
        tail = (sig[rank:].double() ** 2).sum().sqrt().item()
        st_s = rt.RNGState.from_key(seed + 28)
        (u, s, vt), _ = drive(f"(s) rsvd_krylov {ms_}x{ns}, rank {rank}, "
                              "depth 2",
                              lambda: la.rsvd_krylov(As, rank, st_s),
                              {"K3": 1})
        e_k = ((s - sig[:rank]).abs().max() / sig[0]).item()
        check(e_k <= KRYLOV_TOL, f"(s) rsvd_krylov {e_k}")
        ms = timed("(s) rsvd_krylov", lambda: la.rsvd_krylov(As, rank, st_s),
                   lambda: la.rsvd(As, rank, st_s), "(i)'s linalg.rsvd")
        print(f"(s) rsvd_krylov: top-{rank} vs the planted singular values "
              f"{e_k:.3g} <= {KRYLOV_TOL} (max abs err / s_1); {ms:.3f} ms "
              f"[{card}]")
        breakdown("(s) rsvd_krylov", lambda: la.rsvd_krylov(As, rank, st_s),
                  card)
        # the SVD under the Krylov basis: cuSOLVER's default float32 SVD
        # against qb.safe_svd (Householder QR, then the small factor's SVD
        # in float64), on the first Krylov block
        y = As @ rt.DenseSkOp(rt.DenseDist(ns, rank + 2),
                              st_s).materialize(device=dev)
        eye_k = eye(rank + 2)
        orth = {}
        for name, svd in (("torch.linalg.svd", torch.linalg.svd),
                          ("safe_svd", qb.safe_svd)):
            u_, s_, vt_ = svd(y, full_matrices=False)
            orth[name] = ((u_.T @ u_ - eye_k).abs().max().item(),
                          ((u_ * s_) @ vt_ - y).abs().max().item()
                          / y.abs().max().item())
        check(max(orth["safe_svd"]) <= SVD_TOL, f"(s) safe_svd {orth}")
        print(f"(s) the SVD of the first Krylov block ({ms_}x{rank + 2}): "
              + ", ".join(f"{k} max |U^T U - I| {o:.3g}, reconstruction "
                          f"{r:.3g} of max |y|" for k, (o, r) in orth.items())
              + f" (safe_svd <= {SVD_TOL})")
        (j, z_id), _ = drive(f"(s) column_id, k={rank}",
                             lambda: la.column_id(As, rank, st_s), {"K3": 1})
        jt = torch.as_tensor(j, device=dev)
        r_id = (As - As[:, jt] @ z_id).norm().item() / tail
        (i_, j2, u_c), _ = drive(f"(s) cur, k={rank}",
                                 lambda: la.cur(As, rank, st_s), {"K3": 2})
        c_ = As[:, torch.as_tensor(j2, device=dev)]
        r_ = As[torch.as_tensor(i_, device=dev), :]
        r_cur = (As - c_ @ u_c @ r_).norm().item() / tail
        check(r_id <= ID_SLACK and r_cur <= ID_SLACK,
              f"(s) ID {r_id}, CUR {r_cur} times ||A - A_k||_F")
        id_ms = time_ms(lambda: la.column_id(As, rank, st_s))
        cur_ms = timed("(s) cur", lambda: la.cur(As, rank, st_s))
        print(f"(s) ||A - A[:, J] Z||_F / ||A - A_{rank}||_F {r_id:.3f}, "
              f"||A - C U R||_F / ||A - A_{rank}||_F {r_cur:.3f} (<= "
              f"{ID_SLACK}); column_id {id_ms:.3f} ms, cur {cur_ms:.3f} ms "
              f"[{card}]")
        breakdown("(s) cur", lambda: la.cur(As, rank, st_s), card)
        (sn, _), _ = drive("(s) spectral_norm, tol 1e-2",
                           lambda: la.spectral_norm(As, st_s), {"K3": 1})
        e_sn = abs(sn.item() - sig[0].item()) / sig[0].item()
        check(e_sn <= SPEC_TOL, f"(s) spectral_norm {e_sn}")
        ms = timed("(s) spectral_norm", lambda: la.spectral_norm(As, st_s))
        print(f"(s) spectral_norm ({la.required_power_iters(ns, 1e-6, 1e-2)} "
              f"power steps on A^T A) vs s_1 {e_sn:.3g} <= {SPEC_TOL}; "
              f"{ms:.3f} ms [{card}]")
        breakdown("(s) spectral_norm", lambda: la.spectral_norm(As, st_s),
                  card)

    # -- (t) sGMRES and sketched eigenpairs -------------------------------
    def path_t():
        nt, basis, kt, ebasis = PHASE9["t"]
        At = randn(nt, nt) / math.sqrt(nt) + 4 * eye(nt)
        bt = randn(nt)
        st_t = rt.RNGState.from_key(seed + 29)
        (x, res, _), _ = drive(f"(t) sgmres n={nt}, basis {basis}, saso",
                               lambda: la.sgmres(At, bt, st_t, basis=basis),
                               {"K4": 3, "K7": 3})
        routes("(t) sgmres", {"sparse_saso_kernel": 3})
        true = ((At.double() @ x.double() - bt.double()).norm()
                / bt.double().norm()).item()
        check(true <= SGMRES_TOL, f"(t) sgmres true residual {true}")
        ms = timed("(t) sgmres", lambda: la.sgmres(At, bt, st_t, basis=basis),
                   lambda: torch.linalg.solve(At, bt),
                   "float32 torch.linalg.solve")
        print(f"(t) sgmres: true residual {true:.3g} <= {SGMRES_TOL}, "
              f"sketched "
              f"residual {res.item():.3g} (K4 rounds the basis image to bf16; "
              f"test_tpu_hardware.py:364-383 bounds it at 1e-3); {ms:.3f} ms "
              f"[{card}]")
        breakdown("(t) sgmres", lambda: la.sgmres(At, bt, st_t, basis=basis),
                  card)
        g_ = randn(nt, nt)
        Ag = (g_ + g_.T) / math.sqrt(2 * nt)
        del g_, At
        drive(f"(t) sketched_eigs sym, GOE n={nt}, k={kt}, basis {ebasis}",
              lambda: la.sketched_eigs(Ag, kt, st_t, basis=ebasis, sym=True),
              {"K3": 1})
        ms = timed("(t) sketched_eigs(sym=True), GOE",
                   lambda: la.sketched_eigs(Ag, kt, st_t, basis=ebasis,
                                            sym=True),
                   lambda: torch.linalg.eigvalsh(Ag),
                   "float32 torch.linalg.eigvalsh")
        breakdown("(t) sketched_eigs sym", lambda: la.sketched_eigs(
            Ag, kt, st_t, basis=ebasis, sym=True), card)
        del Ag
        # 16 planted, well separated top eigenvalues 20 -> 5 over a bulk in
        # [-1, 1]
        ut = torch.linalg.qr(randn(nt, nt)).Q
        lam_t = torch.cat([torch.linspace(20, 5, kt, device=dev),
                           torch.linspace(1, -1, nt - kt, device=dev)])
        Ap_t = (ut * lam_t) @ ut.T
        Ap_t = 0.5 * (Ap_t + Ap_t.T)
        del ut
        t0 = time.perf_counter()
        ref = top_abs(torch.linalg.eigvalsh(Ap_t.double()), kt)
        ref_s = time.perf_counter() - t0
        for sym, expect in ((True, {"K3": 1}),
                            (False, {"K3": 1, "K7": 2})):
            (th, _, _, _), _ = drive(
                f"(t) sketched_eigs sym={sym}, planted, k={kt}",
                lambda: la.sketched_eigs(Ap_t, kt, st_t, basis=ebasis,
                                         sym=sym),
                expect)
            th = th.real if th.is_complex() else th
            err = ((top_abs(th.double(), kt) - ref).abs().max()
                   / ref.abs().max()).item()
            check(err <= RITZ_TOL, f"(t) sketched_eigs sym={sym}: {err}")
            ms = timed(f"(t) sketched_eigs(sym={sym}), planted",
                       lambda: la.sketched_eigs(Ap_t, kt, st_t, basis=ebasis,
                                                sym=sym))
            print(f"(t) sketched_eigs(sym={sym}): the {kt} Ritz values vs "
                  f"float64 eigvalsh ({ref_s:.1f} s) {err:.3g} <= {RITZ_TOL}; "
                  f"{ms:.3f} ms [{card}]")
            if not sym:
                breakdown("(t) sketched_eigs nonsym", lambda: la.sketched_eigs(
                    Ap_t, kt, st_t, basis=ebasis), card)
        # why the nonsymmetric pencil's sketches are precise: the same
        # pencil with S Q and S A Q through sketch_general (K4, which rounds
        # Q and AQ to bf16 apart) against rgs._precise_sketch
        v0 = rt.DenseSkOp(rt.DenseDist(1, nt), st_t).materialize(
            device=dev)[0]
        q_t, aq_t = sg._truncated_arnoldi(lambda v: Ap_t @ v, v0, ebasis, 4)
        S_t = make_embedding("saso", 2 * ebasis + 8, nt, st_t)
        pencil = {}
        for name, sk in (("K4", lambda x: rt.sketch_general(S_t, x)),
                         ("precise", lambda x: rgs._precise_sketch(
                             S_t, x, 1.0))):
            # the whitening of sketched_eigs: S Q = U diag(s) V^T, its
            # singular values clipped at eps m s_0
            u_, s_, vt_ = qb.safe_svd(sk(q_t))
            cut = torch.finfo(torch.float32).eps * ebasis * s_[0]
            s_inv = torch.where(s_ > cut, 1.0 / torch.maximum(s_, cut), 0.0)
            w_ = np.linalg.eigvals((u_.T @ sk(aq_t) @ (vt_.T * s_inv))
                                   .double().cpu().numpy())
            w_ = np.sort(w_[np.argsort(-np.abs(w_))[:kt]].real)
            pencil[name] = (np.abs(w_ - ref.cpu().numpy()).max()
                            / ref.abs().max().item())
        check(pencil["precise"] <= RITZ_TOL, f"(t) pencil {pencil}")
        print(f"(t) the sketched pencil's {kt} Ritz values vs float64 "
              f"eigvalsh: sketches through K4 {pencil['K4']:.3g}, through "
              f"rgs._precise_sketch {pencil['precise']:.3g} <= {RITZ_TOL}")

    # -- (u) randomized Gram-Schmidt QR -----------------------------------
    def path_u():
        mu_, ku, bu = PHASE9["u"]
        Au = randn(mu_, ku)
        st_u = rt.RNGState.from_key(seed + 30)
        (q, r, _), got = drive(f"(u) rgs_qr {mu_}x{ku}, block {bu}",
                               lambda: la.rgs_qr(Au, st_u, block=bu),
                               {"K3": 1})
        check(got["K1"] == got["K2"] == got["K4"] == 0,
              f"(u) a bf16-operand kernel ran inside rgs_qr: {got}")
        rec = rel(q @ r, Au)
        check(rec <= RGS_REC_TOL and torch.equal(r, torch.triu(r)),
              f"(u) rgs_qr reconstruction {rec}")
        ms = timed("(u) rgs_qr", lambda: la.rgs_qr(Au, st_u, block=bu),
                   lambda: la.cholqr(Au), "linalg.cholqr (CholQR2)")
        print(f"(u) rgs_qr: K1 {got['K1']}, K2 {got['K2']}, K4 {got['K4']} "
              f"launches inside it; ||QR - A|| / ||A|| {rec:.3g} <= "
              f"{RGS_REC_TOL}, R upper triangular; {ms:.3f} ms [{card}]")
        breakdown("(u) rgs_qr", lambda: la.rgs_qr(Au, st_u, block=bu), card)
        del Au, q, r
        # test_tpu_hardware.py:508-534's cond 3e7 case, with its bounds
        mc, kc = 8192, 128
        uc = torch.linalg.qr(randn(mc, kc, dtype=torch.float64)).Q
        vc = torch.linalg.qr(randn(kc, kc, dtype=torch.float64)).Q
        sc = 3e7 ** (-torch.arange(kc, device=dev, dtype=torch.float64)
                     / (kc - 1))
        ac = ((uc * sc) @ vc.T).float()
        (q, r, _), got = drive("(u) rgs_qr, cond 3e7, 8192x128, block 64",
                               lambda: la.rgs_qr(ac, rt.RNGState.from_key(41),
                                                 block=64), {"K3": 1})
        rec = rel(q @ r, ac)
        orth = torch.linalg.matrix_norm(q.double().T @ q.double()
                                        - eye(kc, torch.float64), 2).item()
        check(rec < RGS_HW[0] and orth < RGS_HW[1]
              and torch.equal(r, torch.triu(r)),
              f"(u) cond 3e7: reconstruction {rec}, orthogonality {orth}")
        print(f"(u) cond 3e7 (test_tpu_hardware.py:508-534): reconstruction "
              f"{rec:.3g} < {RGS_HW[0]}, ||Q^T Q - I||_2 {orth:.3g} < "
              f"{RGS_HW[1]}; K1 {got['K1']}, K2 {got['K2']}, K4 {got['K4']}")

    # -- (v) the randomized eigensolvers ----------------------------------
    def path_v():
        nv, kv = PHASE9["v"]
        g_ = randn(nv, nv)
        Av = (g_ + g_.T) / math.sqrt(2 * nv)
        h_ = randn(nv, 64) / 8.0
        Bv = h_ @ h_.T + eye(nv)
        st_v = rt.RNGState.from_key(seed + 31)
        (w, xv), _ = drive(f"(v) rand_geigh n={nv}, k={kv}, the bench's "
                           "pencil",
                           lambda: la.rand_geigh(Av, Bv, kv, st_v), {"K3": 1})
        check(bool(torch.isfinite(w).all() and torch.isfinite(xv).all()),
              "(v) rand_geigh on the bench's pencil: non-finite output")
        ms = timed("(v) rand_geigh, the bench's pencil",
                   lambda: la.rand_geigh(Av, Bv, kv, st_v))
        breakdown("(v) rand_geigh", lambda: la.rand_geigh(Av, Bv, kv, st_v),
                  card)
        del g_, Av, h_, Bv
        # test_tpu_hardware.py:420-445's construction at this width: B = g g^T
        # / n + I, A = L (U diag(theta) U^T) L^T with theta planted
        g64 = randn(nv, nv, dtype=torch.float64)
        b64 = g64 @ g64.T / nv + eye(nv, torch.float64)
        del g64
        ell = torch.linalg.cholesky(b64)
        uv = torch.linalg.qr(randn(nv, kv, dtype=torch.float64)).Q
        theta = torch.linspace(5.0, -3.0, kv, device=dev, dtype=torch.float64)
        a32 = (ell @ ((uv * theta) @ uv.T) @ ell.T).float()
        b32 = b64.float()
        del b64, ell, uv
        t0 = time.perf_counter()
        l32 = torch.linalg.cholesky(b32.double())
        c64 = torch.linalg.solve_triangular(
            l32,
            torch.linalg.solve_triangular(l32, a32.double(), upper=False).T,
            upper=False)
        ref_g = top_abs(torch.linalg.eigvalsh(0.5 * (c64 + c64.T)), kv)
        ref_a = top_abs(torch.linalg.eigvalsh(a32.double()), kv)
        ref_s = time.perf_counter() - t0
        del l32, c64
        for name, fn, ref in (
                ("rand_geigh", lambda: la.rand_geigh(a32, b32, kv, st_v),
                 ref_g),
                ("rand_eigh", lambda: la.rand_eigh(a32, kv, st_v), ref_a)):
            (w, _), _ = drive(f"(v) {name}, planted, n={nv}, k={kv}", fn,
                              {"K3": 1})
            err = ((torch.sort(w.double())[0] - ref).abs().max()
                   / ref.abs().max()).item()
            check(err <= RITZ_TOL, f"(v) {name} planted: {err}")
            ms = timed(f"(v) {name}, planted", fn)
            print(f"(v) {name}: the top {kv} vs float64 eigvalsh "
                  f"({ref_s:.1f} s for both references) {err:.3g} <= "
                  f"{RITZ_TOL}; {ms:.3f} ms [{card}]")

    for path in (path_m, path_m_right, path_n, path_o, path_p, path_q,
                 path_r, path_s, path_t, path_u, path_v):
        path()
        torch.cuda.empty_cache()
    return k6


def tt_svd_oracle(x, ranks):
    """Deterministic TT-SVD (Oseledets 2011) in float64 numpy, the
    quasi-optimality baseline (tests/test_tt.py's oracle)."""
    x = np.asarray(x, np.float64)
    shape = x.shape
    p = len(shape)
    ranks = (ranks,) * (p - 1) if isinstance(ranks, int) else tuple(ranks)
    cores = []
    carry = x.reshape(1, -1)
    r_prev = 1
    for k in range(p - 1):
        mat = carry.reshape(r_prev * shape[k], -1)
        u, s, vt = np.linalg.svd(mat, full_matrices=False)
        r = min(ranks[k], len(s))
        cores.append(u[:, :r].reshape(r_prev, shape[k], r))
        carry = s[:r, None] * vt[:r, :]
        r_prev = r
    cores.append(carry.reshape(r_prev, shape[-1], 1))
    out = cores[0]
    for g in cores[1:]:
        out = np.einsum("a...b,bic->a...ic", out, g)
    return out[0, ..., 0]


def st_hosvd_oracle(x, ranks):
    """Deterministic ST-HOSVD in float64 numpy (tests/test_tucker.py's
    oracle)."""
    x = np.asarray(x, np.float64)
    p = x.ndim
    ranks = (ranks,) * p if isinstance(ranks, int) else tuple(ranks)
    cur = x.copy()
    fac = []
    for k in range(p):
        mat = np.moveaxis(cur, k, 0).reshape(cur.shape[k], -1)
        u = np.linalg.svd(mat, full_matrices=False)[0]
        r = min(ranks[k], u.shape[1])
        uk = u[:, :r]
        fac.append(uk)
        cur = np.moveaxis((uk.T @ mat).reshape(
            (r,) + cur.shape[:k] + cur.shape[k + 1:]), 0, k)
    rec = cur
    for k, u in enumerate(fac):
        rec = np.moveaxis(np.tensordot(u, rec, axes=(1, k)), 0, k)
    return rec


def rank_one_sum(rng, shape, terms, decay=0.5):
    """sum_t decay^t a_t o b_t o c_t ... in float64 numpy (the hardware
    tests' decaying-spectrum tensors)."""
    y = np.zeros(shape, np.float64)
    for t in range(terms):
        vs = [rng.standard_normal(sz) for sz in shape]
        out = vs[0]
        for v in vs[1:]:
            out = np.multiply.outer(out, v)
        y += (decay ** t) * out
    return y


def tt_matvec_plain(cores, xd):
    """A TT-matrix (its cores) applied to the dense tensor ``xd`` one mode
    at a time, never forming the matrix: after mode k the carry holds
    (o_1..o_k, R_k, i_(k+1)..i_p)."""
    p = len(cores)
    outs, ins = "abcdefghij"[:p], "klmnopqrst"[:p]
    t = xd[None]
    for k, g in enumerate(cores):
        t = torch.einsum(f"{outs[:k]}Y{ins[k:]},Y{outs[k]}{ins[k]}Z->"
                         f"{outs[:k + 1]}Z{ins[k + 1:]}", t, g)
    return t[..., 0]


def measure_err(theta, vecs, w64, v64):
    """How far the Gauss quadratures of a batch of tridiagonals (nodes
    ``theta``, eigenvectors ``vecs``) lie from float64 numpy's (``w64``,
    ``v64``): (max node error / max |node|, max error of the weights
    e1^T v squared, how many nodes were merged). Nodes within TINY_EIGH_TOL
    max |node| of a neighbour are numerically one, and only their summed
    weight is defined, so weights are compared summed over such runs."""
    th = theta.double().cpu().numpy()
    tau = (vecs[:, 0, :].double() ** 2).cpu().numpy()
    tau64 = v64[:, 0, :] ** 2
    scale = np.abs(w64).max()
    node_err = float(np.abs(th - w64).max() / scale)
    weight_err, merged = 0.0, 0
    for p in range(w64.shape[0]):
        run = np.concatenate([[0], np.cumsum(np.diff(w64[p])
                                             > TINY_EIGH_TOL * scale)])
        merged += len(run) - 1 - int(run[-1])
        weight_err = max(weight_err, float(np.abs(
            np.bincount(run, tau[p]) - np.bincount(run, tau64[p])).max()))
    return node_err, weight_err, merged


def tier45_paths(rt, dev, drive, card, seed):
    """Phase 10: linalg groups 4-5 at the benchmarks' shapes, paths (w) to
    (z), each against its check, with its launch counts, K3's blocks held
    bit for bit against the plain fill, its time (CUDA events, median of 5
    after a warm-up) beside the library call's where there is one, one
    profiled call, and the sharp checks of test_tpu_hardware.py with their
    bounds. The data are made on the card from ``seed``."""
    import contextlib
    import math
    from randblas_tpu_torch import dense as tdense
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch.linalg import quadrature as quad
    from randblas_tpu_torch.linalg import streaming as stm
    from randblas_tpu_torch.linalg import tt as ttmod
    from randblas_tpu_torch.ops import fused_sketch as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    print("phase 10: linalg groups 4-5, paths (w)-(z), with PyTorch's "
          "default TF32 setting (allow_tf32 False; path (i) switched it on "
          f"for cholqr alone) [{card}]")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev, dtype=dtype)

    def on_card(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    def rel(x, ref):
        """max |x - ref| / max |ref|, in float64."""
        x, ref = x.double(), ref.double()
        return ((x - ref).abs().max() / ref.abs().max()).item()

    def fro_rel(x, ref):
        x, ref = x.double(), ref.double()
        return ((x - ref).norm() / ref.norm()).item()

    def timed(label, fn, lib=None, lib_name="", reps=5):
        ms = time_ms(fn, reps=reps)
        lib_ms = None if lib is None else time_ms(lib, reps=reps)
        lib_txt = "" if lib is None else f"; {lib_name} {lib_ms:.3f} ms"
        print(f"time {label}: {ms:.3f} ms{lib_txt} [{card}]")
        return ms

    @contextlib.contextmanager
    def k3_recorded():
        """Every block the lazy fill route hands K3 while the block runs:
        its arguments and its output."""
        calls, orig = [], fs._fill

        def spy(dist, state, rows, cols, ro, co, device, transform, scale):
            out = orig(dist, state, rows, cols, ro, co, device, transform,
                       scale)
            calls.append((dist, state, rows, cols, ro, co, out))
            return out

        fs._fill = spy
        try:
            yield calls
        finally:
            fs._fill = orig

    def rdrive(label, fn, expect):
        """``drive`` (launch counts), then each K3 block of the run against
        the plain fill of the same block, bit for bit."""
        with k3_recorded() as calls:
            out, got = drive(label, fn, expect)
        blocks = []
        for dist, state, rows, cols, ro, co, vals in calls:
            got_blk = tdense._cast_and_scale(vals, dist, torch.float32)
            want = tdense.fill_dense_submat_reference(
                dist, state, rows, cols, ro, co, torch.float32, dev)
            check(torch.equal(got_blk, want), f"{label}: K3's ({rows}, "
                  f"{cols}) block of DenseDist({dist.n_rows}, {dist.n_cols})"
                  f" at ({ro}, {co}) is not the plain fill's")
            blocks.append(f"{rows}x{cols}@({ro},{co}) of "
                          f"{dist.n_rows}x{dist.n_cols} {dist.family.name}")
        if blocks:
            print(f"{label}: K3 bit for bit the plain fill on its "
                  f"{len(blocks)} blocks: {'; '.join(sorted(set(blocks)))}")
        return out, got

    # -- (w) one-pass SVD, StreamingSketch, Frequent Directions -----------
    def path_w():
        mw, nw, rw = PHASE10["w"]
        A, sig = planted(randn, mw, nw, rw)
        st_w = rt.RNGState.from_key(seed + 41)
        (u, s, vt, _), _ = rdrive(
            f"(w) single_pass_svd {mw}x{nw}, rank {rw}",
            lambda: la.single_pass_svd(A, rw, st_w), {"K3": 2})
        approx = (u * s) @ vt
        opt = sig[rw:].double().norm().item()
        err = (A.double() - approx.double()).norm().item()
        k_w, l_w = stm._sketch_dims(mw, nw, rw, 8, 2.0)
        # TYUC17 thm 4.3 at rho = rank: E||A - A_hat||_F^2 <= (1 + f(k, l))
        # (1 + f(rank, k)) ||A - A_rank||_F^2, f(s, t) = s / (t - s - 1)
        factor = math.sqrt((1 + k_w / (l_w - k_w - 1))
                           * (1 + rw / (k_w - rw - 1)))
        check(err <= factor * opt, f"(w) single_pass_svd: ||A - USV^T||_F "
              f"{err} vs {factor} x the optimum {opt}")
        A64 = A.double()
        (u64, s64, vt64, _), _ = rdrive(
            "(w) single_pass_svd in float64, the same operators",
            lambda: la.single_pass_svd(A64, rw, st_w, dtype=torch.float64),
            {"K3": 2})
        d_s = ((s.double() - s64).abs().max() / s64[0]).item()
        d_usv = (((u64 * s64) @ vt64 - approx.double()).abs().max()
                 / s64[0]).item()
        check(d_s <= RSVD_TOL and d_usv <= RSVD_TOL,
              f"(w) single_pass_svd float32 vs float64: {d_s}, {d_usv}")
        print(f"(w) single_pass_svd: ||A - U S V^T||_F {err:.4g} = "
              f"{err / opt:.3f} x the optimal ||A - A_{rw}||_F {opt:.4g} "
              f"(TYUC17's expected factor at k = {k_w}, l = {l_w}: "
              f"{factor:.3f}); against the same call in float64 on the same "
              f"operators: singular values {d_s:.3g}, U S V^T max abs "
              f"{d_usv:.3g}, / s_1 (<= {RSVD_TOL})")
        del A64, u64, s64, vt64
        chunks = 8
        bounds_ = [mw * i // chunks for i in range(chunks + 1)]

        def stream():
            sk = la.StreamingSketch(mw, nw, rw, st_w)
            for lo, hi in zip(bounds_[:-1], bounds_[1:]):
                sk.update(lo, A[lo:hi])
            return sk.finalize()

        (su, ss, svt), _ = rdrive(
            f"(w) StreamingSketch {mw}x{nw} in {chunks} row chunks",
            stream, {"K3": chunks + 2})
        ds = ((ss - s).abs().max() / s[0]).item()
        drec = ((((su * ss) @ svt) - approx).abs().max() / s[0]).item()
        check(ds <= STREAM_TOL and drec <= STREAM_TOL,
              f"(w) StreamingSketch vs single_pass_svd: s {ds}, U S V^T "
              f"{drec}")
        print(f"(w) StreamingSketch vs single_pass_svd: singular values "
              f"{ds:.3g}, U S V^T max abs {drec:.3g}, / s_1 (<= "
              f"{STREAM_TOL})")
        del su, ss, svt, approx, u, s, vt
        sp_ms = timed("(w) single_pass_svd",
                      lambda: la.single_pass_svd(A, rw, st_w))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.linalg.svd(A, full_matrices=False)
        torch.cuda.synchronize()
        svd_ms = (time.perf_counter() - t0) * 1e3
        st_ms = timed("(w) StreamingSketch, 8 chunks", stream)
        print(f"(w) single_pass_svd {sp_ms:.3f} ms, StreamingSketch "
              f"{st_ms:.3f} ms; float32 torch.linalg.svd of the matrix "
              f"{svd_ms:.1f} ms (one call, host clock) [{card}]")
        breakdown("(w) single_pass_svd",
                  lambda: la.single_pass_svd(A, rw, st_w), card)
        del A
        # test_tpu_hardware.py:389-417, with its bounds
        rng = np.random.default_rng(17)
        m_h, n_h, r_h = 2048, 512, 16
        uh, _ = np.linalg.qr(rng.normal(size=(m_h, r_h)))
        vh, _ = np.linalg.qr(rng.normal(size=(n_h, r_h)))
        s_true = np.linspace(10.0, 1.0, r_h)
        a_np = ((uh * s_true) @ vh.T).astype(np.float32)
        a_h = on_card(a_np + 1e-4 * rng.normal(size=(m_h, n_h)).astype(
            np.float32))
        (uu, ss, vv, _), _ = rdrive(
            "(w) single_pass_svd, test_tpu_hardware.py's rank-16 case",
            lambda: la.single_pass_svd(a_h, r_h, rt.RNGState.from_key(35),
                                       oversample=8), {"K3": 2})
        s_rel = float(np.max(np.abs(ss.cpu().numpy() - s_true) / s_true))
        rec = float(np.linalg.norm(a_np - ((uu * ss) @ vv).cpu().numpy())
                    / np.linalg.norm(a_np))
        check(s_rel <= SPSVD_HW[0] and rec < SPSVD_HW[1],
              f"(w) hardware case: s {s_rel}, reconstruction {rec}")
        print(f"(w) test_tpu_hardware.py:389-417: s vs planted {s_rel:.3g} "
              f"<= {SPSVD_HW[0]}, reconstruction {rec:.4g} < {SPSVD_HW[1]} "
              f"(the CPU oracle's floor is 8.587e-3)")

        mf, nf, ell, chunk = PHASE10["fd"]
        Af = randn(mf, nf)

        def fd_update():
            fd = la.FrequentDirections(nf, ell)
            for i in range(0, mf, chunk):
                fd.update(Af[i:i + chunk])
            return fd.sketch(), fd.shrink_mass

        def fd_ingest():
            fd = la.FrequentDirections(nf, ell)
            fd.ingest(Af)
            return fd.sketch(), fd.shrink_mass

        outs, stream_ms = [], []
        for label, fn in ((f"(w) FrequentDirections.update {mf}x{nf}, ell "
                           f"{ell}, chunks of {chunk}", fd_update),
                          ("(w) FrequentDirections.ingest", fd_ingest),
                          ("(w) fd_pass", lambda: la.fd_pass(Af, ell))):
            t0 = time.perf_counter()
            outs.append(rdrive(label, fn, {})[0])
            stream_ms.append((time.perf_counter() - t0) * 1e3)
        (bu, mu), (bi, mi), (bp, mp) = outs
        check(torch.equal(bu, bi) and torch.equal(mu, mi)
              and torch.equal(bp, bi) and torch.equal(mp, mi),
              "(w) FD: update, ingest and fd_pass differ")
        a64 = Af.double()
        gram = a64.T @ a64
        fro2 = torch.trace(gram).item()
        b64 = bu.double()
        gram_err = torch.linalg.eigvalsh(gram - b64.T @ b64).abs().max(
        ).item()
        mass = mu.item()
        check(gram_err <= mass * FD_HW[0] + FD_HW[1] * fro2
              and mass <= FD_HW[0] * fro2 / ell,
              f"(w) FD certificate: {gram_err}, {mass}, {fro2 / ell}")
        print(f"(w) FD: update, ingest and fd_pass bit for bit equal; "
              f"||A^T A - B^T B||_2 {gram_err:.6g} <= shrink_mass "
              f"{mass:.6g} <= ||A||_F^2 / ell {fro2 / ell:.6g}")
        del a64, gram, b64
        gram_ms = time_ms(lambda: Af.T @ Af)
        buf = Af[:2 * ell].contiguous()
        g_ = buf @ buf.T
        g64 = g_.double()
        sh_ms = time_ms(lambda: stm._fd_shrink(buf, ell))
        eigh_ms = time_ms(lambda: torch.linalg.eigh(g64))
        eigh32_ms = time_ms(lambda: torch.linalg.eigh(g_))
        w64 = torch.linalg.eigvalsh(g64)
        e32 = ((torch.linalg.eigvalsh(g_).double() - w64).abs().max()
               / w64.abs().max()).item()
        n_sh = mf // ell - 1
        print(f"time (w) FD, one stream each (host clock, the first call): "
              f"update {stream_ms[0]:.1f} ms, ingest {stream_ms[1]:.1f} ms, "
              f"fd_pass {stream_ms[2]:.1f} ms; {n_sh} shrinks a stream, one "
              f"shrink {sh_ms:.3f} ms (of it the {2 * ell}x{2 * ell} float64 "
              f"eigh {eigh_ms:.3f} ms; a float32 eigh of the same Gram "
              f"{eigh32_ms:.3f} ms, its eigenvalues {e32:.3g} of the largest "
              f"from float64's), {n_sh} x one shrink = {n_sh * sh_ms:.1f} ms;"
              f" float32 A^T A (the exact Gram) {gram_ms:.3f} ms [{card}]")
        breakdown("(w) FrequentDirections.ingest", fd_ingest, card)
        del Af
        # test_tpu_hardware.py:588-620, with its bounds
        rng = np.random.default_rng(23)
        m_h, n_h, ell_h = 2048, 256, 64
        a_hw = rng.standard_normal((m_h, n_h)) * 2.0 ** (
            -np.arange(n_h) / 16.0)
        a_c = on_card(a_hw.astype(np.float32))

        def fd_hw():
            fd = la.FrequentDirections(n_h, ell_h)
            for i in range(0, m_h, 160):
                fd.update(a_c[i:i + 160])
            return fd.sketch(), fd.shrink_mass

        (bh, mh), _ = rdrive("(w) FrequentDirections, test_tpu_hardware.py's"
                             " case", fd_hw, {})
        bh = bh.cpu().double().numpy()
        mass = mh.item()
        gram_err = np.linalg.norm(a_hw.T @ a_hw - bh.T @ bh, 2)
        fro2 = np.linalg.norm(a_hw, "fro") ** 2
        check(gram_err <= mass * FD_HW[0] + FD_HW[1] * fro2
              and mass <= FD_HW[0] * fro2 / ell_h
              and mass < FD_HW[2] * fro2 / ell_h,
              f"(w) FD hardware case: {gram_err}, {mass}, {fro2 / ell_h}")
        print(f"(w) test_tpu_hardware.py:588-620: ||A^T A - B^T B||_2 "
              f"{gram_err:.5g} <= mass {mass:.5g} (x {FD_HW[0]} + "
              f"{FD_HW[1]} ||A||_F^2) and mass < {FD_HW[2]} ||A||_F^2 / ell "
              f"= {FD_HW[2] * fro2 / ell_h:.5g}")

    # -- (x) Lanczos quadrature and spectral densities --------------------
    def path_x():
        nx, kx, px = PHASE10["x"]
        G = randn(nx, kx) / math.sqrt(kx)
        lam = torch.linalg.eigvalsh(G.double().T @ G.double())
        lmin, lmax = lam[0].item(), lam[-1].item()

        def gram_mv(x):
            return G @ (G.T @ x)

        def shifted_mv(x):
            return x + G @ (G.T @ x)

        st_x = rt.RNGState.from_key(seed + 43)
        print(f"(x) G {nx}x{kx}: G^T G's eigenvalues {lmin:.4g} to "
              f"{lmax:.4g} (float64), {nx - kx} zeros in G G^T")
        # the batched tiny eigh: Lanczos tridiagonals of this Gram on the
        # card, decomposed by the port's helper and by float64 numpy
        v0, _ = la.rademacher_probes(nx, px, st_x, device=dev)
        for steps in (30, 60):
            al, be, _, _ = quad._block_lanczos_tridiag(gram_mv, v0, steps)
            theta, vecs = quad._tridiag_eigh(al, be)
            raw_t, raw_v = torch.linalg.eigh(
                torch.diag_embed(al) + torch.diag_embed(be, 1)
                + torch.diag_embed(be, -1))
            a64, b64 = al.double(), be.double()
            w64, v64 = np.linalg.eigh(
                (torch.diag_embed(a64) + torch.diag_embed(b64, 1)
                 + torch.diag_embed(b64, -1)).cpu().numpy())
            tau64 = v64[:, 0, :] ** 2
            errs = [measure_err(th, vv, w64, v64)
                    for th, vv in ((theta, vecs), (raw_t, raw_v))]
            print(f"(x) tiny eigh, {px} tridiagonals of {steps}: the port's "
                  f"nodes {errs[0][0]:.3g} (/ max |node|) and weights "
                  f"{errs[0][1]:.3g} from float64 numpy; float32 "
                  f"torch.linalg.eigh on the card {errs[1][0]:.3g} and "
                  f"{errs[1][1]:.3g} (tolerance {TINY_EIGH_TOL}; weights "
                  f"summed over the {errs[0][2]} nodes within "
                  f"{TINY_EIGH_TOL} max |node| of a neighbour)")
            check(max(errs[0][:2]) <= TINY_EIGH_TOL,
                  f"(x) tiny eigh at {steps} steps: {errs[0]}")
        del v0
        (grid, dens, _), _ = rdrive(
            f"(x) spectral_density n={nx}, {px} probes x 60 steps",
            lambda: la.spectral_density(gram_mv, st_x, probes=px, steps=60,
                                        n=nx), {"K3": 1})
        total = torch.trapezoid(dens.double(), grid.double()).item()
        hi_mass = torch.trapezoid(torch.where(grid > lmin / 2, dens, 0.0)
                                  .double(), grid.double()).item()
        check(abs(total - nx) <= DOS_TOTAL_TOL * nx
              and abs(hi_mass - kx) <= COUNT_TOL * kx,
              f"(x) spectral_density: total {total}, cluster {hi_mass}")
        (gk, dk, _), _ = rdrive(
            f"(x) kpm_density n={nx}, {px} probes, degree 128",
            lambda: la.kpm_density(gram_mv, st_x, probes=px, degree=128,
                                   bounds=(-0.5, 1.1 * lmax), n=nx),
            {"K3": 1})
        totk = torch.trapezoid(dk.double(), gk.double()).item()
        hik = torch.trapezoid(torch.where(gk > lmin / 2, dk, 0.0).double(),
                              gk.double()).item()
        check(abs(totk - nx) <= DOS_TOTAL_TOL * nx
              and abs(hik - kx) <= COUNT_TOL * kx,
              f"(x) kpm_density: total {totk}, cluster {hik}")
        print(f"(x) densities (counting normalization): SLQ total {total:.1f}"
              f", mass above {lmin / 2:.3g} {hi_mass:.2f}; KPM total "
              f"{totk:.1f}, mass above {lmin / 2:.3g} {hik:.2f} (n {nx}, "
              f"{kx} nonzero eigenvalues; bounds {DOS_TOTAL_TOL} and "
              f"{COUNT_TOL})")
        (cnt, _), _ = rdrive(
            "(x) eig_count over [lmin / 2, 2 lmax]",
            lambda: la.eig_count(gram_mv, lmin / 2, 2 * lmax, st_x,
                                 probes=px, steps=60, n=nx), {"K3": 1})
        check(abs(cnt.item() - kx) <= COUNT_TOL * kx, f"(x) eig_count {cnt}")
        exact_ld = torch.log1p(lam).sum().item()
        (ld, _), _ = rdrive(
            f"(x) logdet(I + G G^T), {px} probes x 30 steps",
            lambda: la.logdet(shifted_mv, st_x, probes=px, steps=30, n=nx),
            {"K3": 1})
        check(abs(ld.item() - exact_ld) <= LOGDET_TOL * exact_ld,
              f"(x) logdet {ld.item()} vs {exact_ld}")
        B = randn(nx, 8)
        fx, _ = rdrive(
            "(x) lanczos_fn_apply sqrt(I + G G^T) B, 8 columns, 30 steps",
            lambda: la.lanczos_fn_apply(shifted_mv, torch.sqrt, B, steps=30,
                                        n=nx), {})
        ug, sg, _ = torch.linalg.svd(G.double(), full_matrices=False)
        want = B.double() + ug @ ((torch.sqrt(1 + sg ** 2) - 1)[:, None]
                                  * (ug.T @ B.double()))
        fn_err = rel(fx, want)
        check(fn_err <= FN_TOL, f"(x) lanczos_fn_apply: {fn_err}")
        print(f"(x) eig_count {cnt.item():.3f} vs {kx} (<= {COUNT_TOL} "
              f"relative); logdet {ld.item():.6g} vs float64 log det(I + "
              f"G^T G) {exact_ld:.6g} (<= {LOGDET_TOL}); lanczos_fn_apply "
              f"vs the float64 formula through G's thin SVD {fn_err:.3g} "
              f"(<= {FN_TOL})")
        del ug, want
        timed("(x) spectral_density, 60 steps",
              lambda: la.spectral_density(gram_mv, st_x, probes=px, steps=60,
                                          n=nx))
        timed("(x) kpm_density, degree 128",
              lambda: la.kpm_density(gram_mv, st_x, probes=px, degree=128,
                                     bounds=(-0.5, 1.1 * lmax), n=nx))
        timed("(x) eig_count, 60 steps",
              lambda: la.eig_count(gram_mv, lmin / 2, 2 * lmax, st_x,
                                   probes=px, steps=60, n=nx))
        dense = torch.eye(nx, device=dev) + G @ G.T
        timed("(x) logdet, 30 steps",
              lambda: la.logdet(shifted_mv, st_x, probes=px, steps=30, n=nx),
              lambda: torch.linalg.slogdet(dense),
              "float32 torch.linalg.slogdet of the dense I + G G^T")
        del dense
        timed("(x) lanczos_fn_apply, 30 steps",
              lambda: la.lanczos_fn_apply(shifted_mv, torch.sqrt, B,
                                          steps=30, n=nx))
        for label, fn in (
                ("(x) spectral_density", lambda: la.spectral_density(
                    gram_mv, st_x, probes=px, steps=60, n=nx)),
                ("(x) kpm_density", lambda: la.kpm_density(
                    gram_mv, st_x, probes=px, degree=128,
                    bounds=(-0.5, 1.1 * lmax), n=nx))):
            breakdown(label, fn, card)
        del G, B
        # test_tpu_hardware.py:537-585's clustered spectrum, with its bounds
        rng = np.random.default_rng(22)
        n_h = 1024
        counts_h = {-2.0: 200, 0.5: 500, 3.0: 324}
        lam_h = np.concatenate([c + 0.02 * rng.standard_normal(k)
                                for c, k in counts_h.items()])
        uh, _ = np.linalg.qr(rng.standard_normal((n_h, n_h)))
        a_h = on_card(((uh * lam_h) @ uh.T).astype(np.float32))
        masses = []
        for name, fn in (
                ("spectral_density", lambda: la.spectral_density(
                    a_h, rt.RNGState.from_key(50), probes=16, steps=80)),
                ("kpm_density", lambda: la.kpm_density(
                    a_h, rt.RNGState.from_key(52), degree=256, probes=16,
                    npts=801, bounds=(float(lam_h.min()) - 0.3,
                                      float(lam_h.max()) + 0.3)))):
            (g_h, d_h, _), _ = rdrive(f"(x) {name}, test_tpu_hardware.py's "
                                      "clustered spectrum", fn, {"K3": 1})
            g_h = g_h.double().cpu().numpy()
            d_h = d_h.double().cpu().numpy()
            check(np.all(np.isfinite(d_h)) and np.all(d_h > -1e-6),
                  f"(x) {name}: non-finite or negative density")
            tot = np.trapezoid(d_h, g_h)
            check(abs(tot - n_h) / n_h < DOS_TOTAL_TOL,
                  f"(x) {name}: total {tot}")
            for c, k in counts_h.items():
                mask = (g_h >= c - 1.0) & (g_h <= c + 1.0)
                mass = np.trapezoid(np.where(mask, d_h, 0.0), g_h)
                check(abs(mass - k) / k < COUNT_TOL,
                      f"(x) {name}: cluster {c} mass {mass} vs {k}")
                masses.append(f"{mass:.1f}")
        (c_h, _), _ = rdrive(
            "(x) eig_count, test_tpu_hardware.py's middle cluster",
            lambda: la.eig_count(a_h, -0.5, 1.5, rt.RNGState.from_key(51),
                                 probes=16, steps=80), {"K3": 1})
        check(abs(c_h.item() - 500) / 500 < COUNT_TOL,
              f"(x) hardware eig_count {c_h.item()}")
        print(f"(x) test_tpu_hardware.py:537-585: cluster masses (SLQ, then "
              f"KPM) {', '.join(masses)} vs 200, 500, 324; eig_count "
              f"{c_h.item():.2f} vs 500 (each within {COUNT_TOL})")

    # -- (y) block Kaczmarz and block Gauss-Seidel ------------------------
    def path_y():
        my, ny, blk, steps = PHASE10["y"]
        Ay = randn(my, ny)
        xt = randn(ny)
        by = Ay @ xt
        Ac, bc = Ay.cpu(), by.cpu()
        st_y = rt.RNGState.from_key(seed + 45)
        runs = (("block_kaczmarz", la.block_kaczmarz, {}, {}),
                ("block_gauss_seidel shuffle", la.block_gauss_seidel,
                 {"sampling": "shuffle"}, {"K3": 1}),
                ("block_gauss_seidel colnorm", la.block_gauss_seidel,
                 {"sampling": "colnorm"}, {}))
        for name, fn, kw, expect in runs:
            def call(a=Ay, b=by, fn=fn, kw=kw):
                return fn(a, b, st_y, block=blk, steps=steps, **kw)

            (x, _), _ = rdrive(f"(y) {name} {my}x{ny}, block {blk}, {steps} "
                               "steps", call, expect)
            t0 = time.perf_counter()
            x_cpu, _ = call(Ac, bc)
            cpu_s = time.perf_counter() - t0
            err_cpu = rel(x.cpu(), x_cpu)
            err = fro_rel(x, xt)
            check(err_cpu <= KACZ_CPU_TOL and bool(torch.isfinite(x).all()),
                  f"(y) {name}: card vs CPU {err_cpu}")
            ms = timed(f"(y) {name}", call,
                       lambda: torch.linalg.lstsq(Ay, by[:, None]),
                       "float32 torch.linalg.lstsq")
            print(f"(y) {name}: the card's x vs the port's CPU run "
                  f"({cpu_s:.1f} s, host clock) {err_cpu:.3g} <= "
                  f"{KACZ_CPU_TOL}; ||x - x_true|| / ||x_true|| {err:.3g} "
                  f"after {steps} steps; {ms:.3f} ms [{card}]")
            breakdown(f"(y) {name}", call, card)
        del Ay, Ac
        # test_tpu_hardware.py:478-505, with its bounds
        rng = np.random.default_rng(20)
        m_h, n_h = 4096, 256
        a_np = rng.standard_normal((m_h, n_h)).astype(np.float32)
        xt_h = rng.standard_normal(n_h).astype(np.float32)
        a_h = on_card(a_np)
        b_h = a_h @ on_card(xt_h)
        (xk, _), _ = rdrive(
            "(y) block_kaczmarz, test_tpu_hardware.py's case",
            lambda: la.block_kaczmarz(a_h, b_h, rt.RNGState.from_key(39),
                                      block=256, steps=30), {})
        e1 = float(np.linalg.norm(xk.cpu().numpy() - xt_h)
                   / np.linalg.norm(xt_h))
        bn = b_h + on_card(rng.standard_normal(m_h).astype(np.float32))
        xls = np.linalg.lstsq(a_np.astype(np.float64),
                              bn.cpu().double().numpy(), rcond=None)[0]
        (xg, _), _ = rdrive(
            "(y) block_gauss_seidel, test_tpu_hardware.py's case",
            lambda: la.block_gauss_seidel(a_h, bn, rt.RNGState.from_key(40),
                                          block=128, steps=60), {"K3": 1})
        e2 = float(np.linalg.norm(xg.cpu().numpy() - xls)
                   / np.linalg.norm(xls))
        check(e1 < KACZ_HW[0] and e2 < KACZ_HW[1],
              f"(y) hardware case: {e1}, {e2}")
        print(f"(y) test_tpu_hardware.py:478-505: Kaczmarz {e1:.3g} < "
              f"{KACZ_HW[0]}, Gauss-Seidel vs float64 lstsq {e2:.3g} < "
              f"{KACZ_HW[1]}")

    # -- (z) TT and Tucker -------------------------------------------------
    def path_z():
        nz, pz = PHASE10["z"]
        shape = (nz,) * pz
        st_z = rt.RNGState.from_key(seed + 47)
        x, st1 = la.tt_gaussian(shape, 64, st_z)
        s2 = la.tt_add(x, x)
        (r, _), _ = rdrive(
            f"(z) tt_round {shape} ranks 128 -> 64, oversample 8",
            lambda: la.tt_round(s2, 64, st1, oversample=8), {"K3": pz})
        xf = x.full()
        err_r = fro_rel(r.full(), 2 * xf)
        check(r.ranks == (1,) + (64,) * (pz - 1) + (1,)
              and err_r <= TT_EXACT_TOL, f"(z) tt_round: {r.ranks}, {err_r}")
        dense = randn(*shape)
        (tt, _), _ = rdrive(f"(z) tt_from_dense {shape}, rank 64",
                            lambda: la.tt_from_dense(dense, 64, st1),
                            {"K3": pz - 1})
        e_tt = fro_rel(tt.full(), dense)
        (core, facs, _), _ = rdrive(
            f"(z) tucker_from_dense {shape}, rank 32",
            lambda: la.tucker_from_dense(dense, 32, st1), {"K3": pz})
        e_tk = fro_rel(la.tucker_full(core, facs), dense)
        orth = max((f.T @ f - torch.eye(f.shape[1], device=dev)).abs().max()
                   .item() for f in facs)
        check(e_tt <= 1.0 and e_tk <= 1.0 and orth <= 1e-4,
              f"(z) from_dense: {e_tt}, {e_tk}, {orth}")
        print(f"(z) tt_round of 2x back to rank 64 vs 2x {err_r:.3g} (<= "
              f"{TT_EXACT_TOL}); a Gaussian 64^4 tensor's relative error "
              f"at TT rank 64 {e_tt:.4f}, at Tucker rank 32 {e_tk:.4f} (a "
              f"projection: <= 1), Tucker factors' max |U^T U - I| "
              f"{orth:.3g}")
        xs_tt, st2 = la.tt_gaussian(shape, 16, st1)
        xs = xs_tt.full()
        del xs_tt
        (sp, _), _ = rdrive(f"(z) tt_single_pass {shape}, rank 16",
                            lambda: la.tt_single_pass(xs, 16, st2),
                            {"K3": 2 * pz})

        def stream_of():
            ts_ = la.TTStream(shape, 16, st2)
            for w in (0.1, 0.2, 0.3, 0.4):
                ts_.update(w * xs)
            return ts_

        def stream():
            return stream_of().recover()

        tso, _ = rdrive("(z) TTStream, 4 additive updates", stream_of,
                        {"K3": 2 * pz})
        ss = tso.recover()
        # the stream holds the same linear sketches Psi_k as one pass over
        # the sum; the recoveries Phi^+ Psi then differ by their rounding
        # times cond(Phi_k)
        psis = ttmod._stta_sketch(xs, tso._r_tt, tso._l_tt, torch.float32)
        d_psi = max(rel(a, b) for a, b in zip(tso._psis, psis))
        kappa = max(torch.linalg.cond(torch.einsum(
            "ljb,ajb->la", psi, tso._r_tt.cores[k])).item()
            for k, psi in enumerate(psis[1:], 1))
        d_ss = rel(ss.full(), sp.full())
        e_sp = fro_rel(sp.full(), xs)
        e_ss = fro_rel(ss.full(), xs)
        check(d_psi <= TT_STREAM_TOL and max(e_sp, e_ss) <= TT_EXACT_TOL,
              f"(z) STTA: sketches {d_psi}, recoveries {e_sp}, {e_ss}")
        mat, _ = la.tt_matrix_gaussian(shape, shape, 8, st2)
        y, _ = rdrive("(z) tt_matvec, a rank-8 TT-matrix on the rounded "
                      "tensor", lambda: la.tt_matvec(mat, r), {})
        y_ref = tt_matvec_plain(mat.cores, r.full())
        e_mv = rel(y.full(), y_ref)
        check(y.ranks == (1,) + (8 * 64,) * (pz - 1) + (1,)
              and e_mv <= TT_MATVEC_TOL, f"(z) tt_matvec: {y.ranks}, {e_mv}")
        del y_ref
        print(f"(z) TTStream vs tt_single_pass: the sketches Psi_k "
              f"{d_psi:.3g} (<= {TT_STREAM_TOL}), the recovered tensors "
              f"{d_ss:.3g} (max cond(Phi_k) {kappa:.4g}); the rank-16 tensor "
              f"recovered to {e_sp:.3g} and {e_ss:.3g} (<= {TT_EXACT_TOL}); "
              f"tt_matvec (ranks {y.ranks[1]}) vs the mode-by-mode "
              f"contraction {e_mv:.3g} (<= {TT_MATVEC_TOL})")
        del y
        for label, fn in (
                ("tt_round 128 -> 64", lambda: la.tt_round(s2, 64, st1,
                                                            oversample=8)),
                ("tt_from_dense rank 64",
                 lambda: la.tt_from_dense(dense, 64, st1)),
                ("tucker_from_dense rank 32",
                 lambda: la.tucker_from_dense(dense, 32, st1)),
                ("tt_single_pass rank 16",
                 lambda: la.tt_single_pass(xs, 16, st2)),
                ("TTStream, 4 updates", stream),
                ("tt_matvec rank 8", lambda: la.tt_matvec(mat, r))):
            timed(f"(z) {label}", fn)
            breakdown(f"(z) {label}", fn, card)
        del x, s2, r, dense, xs, xf
        # test_tpu_hardware.py:798-870, with its bounds
        x_h, _ = la.tt_gaussian((8, 9, 7, 6), (3, 4, 2),
                                rt.RNGState.from_key(1))
        d_h = x_h.full().double()
        (t2, _), _ = rdrive(
            "(z) tt_from_dense, test_tpu_hardware.py's exact case",
            lambda: la.tt_from_dense(d_h.float(), (3, 4, 2),
                                     rt.RNGState.from_key(2)), {"K3": 3})
        e1 = fro_rel(t2.full(), d_h)
        s_h = la.tt_add(x_h, la.tt_scale(x_h, 2.0))
        (r_h, _), _ = rdrive(
            "(z) tt_round, test_tpu_hardware.py's add-then-round case",
            lambda: la.tt_round(s_h, (3, 4, 2), rt.RNGState.from_key(3)),
            {"K3": 4})
        e2 = fro_rel(r_h.full(), 3 * d_h)
        y_np = rank_one_sum(np.random.default_rng(8), (9, 10, 11), 8)
        ty, _ = la.tt_from_dense(on_card(y_np.astype(np.float32)), 8,
                                 rt.RNGState.from_key(12), power_iters=2)
        ry, _ = la.tt_round(ty, 3, rt.RNGState.from_key(13), oversample=4)
        got = np.linalg.norm(ry.full().double().cpu().numpy() - y_np)
        base = np.linalg.norm(tt_svd_oracle(y_np, 3) - y_np)
        check(e1 < TT_HW and e2 < TT_HW
              and got < 3 * base + 5e-2 * np.linalg.norm(y_np),
              f"(z) TT hardware case: {e1}, {e2}, {got} vs {base}")
        y_np = rank_one_sum(np.random.default_rng(2), (12, 13, 14), 10)
        (cc, ff, _), _ = rdrive(
            "(z) tucker_from_dense, test_tpu_hardware.py's case",
            lambda: la.tucker_from_dense(on_card(y_np.astype(np.float32)), 4,
                                         rt.RNGState.from_key(2),
                                         power_iters=2), {"K3": 3})
        got_tk = np.linalg.norm(la.tucker_full(cc, ff).double().cpu().numpy()
                                - y_np)
        base_tk = np.linalg.norm(st_hosvd_oracle(y_np, 4) - y_np)
        orth_h = max((u.T @ u - torch.eye(u.shape[1], device=dev)).abs()
                     .max().item() for u in ff)
        check(got_tk < 2 * base_tk + 5e-2 * np.linalg.norm(y_np)
              and orth_h <= ORTH_HW,
              f"(z) Tucker hardware case: {got_tk} vs {base_tk}, {orth_h}")
        print(f"(z) test_tpu_hardware.py:798-870: exact recovery {e1:.3g} "
              f"and 3x after add-then-round {e2:.3g} (< {TT_HW}); rounding "
              f"error {got:.4g} < 3 x the float64 TT-SVD's {base:.4g} + "
              f"5e-2 ||y||; Tucker {got_tk:.4g} < 2 x ST-HOSVD's "
              f"{base_tk:.4g} + 5e-2 ||y||, max |U^T U - I| {orth_h:.3g} <= "
              f"{ORTH_HW}")

    for path in (path_w, path_x, path_y, path_z):
        t0 = time.perf_counter()
        path()
        torch.cuda.empty_cache()
        print(f"phase 10, {path.__name__}: {time.perf_counter() - t0:.1f} s "
              "(host clock, checks and timings included)")


def distributed_paths(rt, dev, drive, card, seed):
    """Phase 11: the distributed layer (randblas_tpu_torch.parallel) on the
    card, paths (M1)-(M14) numbered as the JAX package's dryrun_multichip.
    Through a real NCCL process group of one rank and a 1 x 1 mesh, the
    public entry points with DTensor inputs: (M1) distributed_sketch at the
    main shape and its backward pass, (M8) distributed_rsvd, (M9)
    distributed_krylov_rangefinder, (M13) distributed_fd and (M14)
    ihs_lsq(mesh=). NCCL takes one rank a card, so the 1 x 4, 4 x 1 and
    2 x 2 meshes are emulated: every shard body runs on the card in turn,
    at full width, and the partials are added in rank order ((M1)-(M7),
    (M13) in four shards). Each path: its launch counts, its error against
    its bound, CUDA-event times (median of 5; one run for FD) beside the
    single-device call's, and one profiled call. The data are made on the
    card from ``seed``."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import parallel as par
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.linalg import distributed as ldist
    from randblas_tpu_torch.ops import fused_sketch as fs
    from randblas_tpu_torch.parallel import distributed as pd

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed + 40)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def timed(label, fn, single=None, single_name="", reps=5):
        ms = time_ms(fn, reps=reps)
        one = None if single is None else time_ms(single, reps=reps)
        txt = "" if single is None else f"; {single_name} {one:.3f} ms"
        print(f"time {label}: {ms:.3f} ms{txt} [{card}]")

    def emulate(label, run, expect, want, tol):
        """``run(shape)``, every shard of a mesh in turn, on each mesh of
        MESHES11, against ``want``; ``expect(shape)``: its launches;
        ``tol``: a bound, or a function of the shape."""
        for shape in MESHES11:
            name = f"({label}) {shape[0]}x{shape[1]} mesh, emulated"
            out, _ = drive(name, lambda: run(shape), expect(shape))
            err = rel_err(out, want)
            bound = tol(shape) if callable(tol) else tol
            check(out.shape == want.shape and err <= bound,
                  f"{name}: {tuple(out.shape)}, normalised {err}")
            ms = time_ms(lambda: run(shape))
            print(f"{name}: normalised {err:.3g} <= {bound} against the "
                  f"single-device call; {ms:.3f} ms [{card}]")
        breakdown(f"({label}) 2x2 mesh, emulated", lambda: run((2, 2)), card)

    def shards(shape):
        return {"K1": shape[0] * shape[1]}

    def summed(body, extents, total, block, dim=0):
        """run(shape): each model row's partials added over 'data' in rank
        order, the rows stacked along ``dim``; ``block(off, ext)``: the
        shard's block of the data along the contraction."""
        def run(shape):
            m_per = extents(shape)[1]
            out = []
            for mi in range(shape[0]):
                acc = None
                for di in range(shape[1]):
                    off, ext = pd.shard_span(total, m_per, di)
                    part = body(block(off, ext), (mi, di), shape)
                    acc = part if acc is None else acc + part
                out.append(acc)
            return torch.cat(out, dim=dim)
        return run

    def tiled(S_c, A_c):
        """run(shape) of the column layout: each shard's output block."""
        n = A_c.shape[1]

        def run(shape):
            n_per = pd.cols_extents(S_c, n, shape)[1]
            return torch.cat([torch.cat([
                pd.cols_shard(S_c, A_c[:, off:off + ext], (mi, di), shape, n)
                for di in range(shape[1])
                for off, ext in [pd.shard_span(n, n_per, di)]], dim=1)
                for mi in range(shape[0])])
        return run

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    par.initialize_multihost(f"localhost:{port}", num_processes=1,
                             process_id=0)
    try:
        mesh = par.make_sketch_mesh(1, 1)
        backend = dist.get_backend(mesh.get_group("data"))
        check("nccl" in str(backend), f"the mesh's group is {backend}")
        print(f"phase 11: the distributed layer, paths (M1)-(M14); process "
              f"group {backend}, world size {dist.get_world_size()}, mesh "
              f"{tuple(mesh.mesh.shape)} on {mesh.device_type} [{card}]")
        rows_data = [Replicate(), Shard(0)]

        # -- (M1) distributed_sketch at the main shape -------------------
        S = rt.DenseSkOp(rt.DenseDist(D, M), rt.RNGState.from_key(seed + 41))
        A = randn(M, N)
        A_dt = distribute_tensor(A, mesh, rows_data)
        B, _ = drive("(M1) distributed_sketch, 1x1 NCCL mesh",
                     lambda: par.distributed_sketch(S, A_dt, mesh),
                     {"K1": 1})
        check(isinstance(B, DTensor) and tuple(B.placements)
              == (Shard(0), Replicate()) and B.shape == (D, N),
              f"(M1) {type(B).__name__} {tuple(B.shape)}")
        B1 = rt.sketch_general(S, A)
        torch.cuda.synchronize()
        check(torch.equal(B.to_local(), B1),
              f"(M1) the 1x1 mesh's K1 call is sketch_general's, but "
              f"differs by {rel_err(B.to_local(), B1)}")
        print("(M1) 1x1 NCCL mesh against sketch_general: bitwise (the "
              "same K1 call)")
        a_leaf = distribute_tensor(A, mesh, rows_data).requires_grad_(True)
        G = randn(D, N)

        def backward():
            a_leaf.grad = None
            par.distributed_sketch(S, a_leaf, mesh).to_local().backward(G)
            return a_leaf.grad

        g, _ = drive("(M1) distributed_sketch forward + backward, 1x1 NCCL "
                     "mesh", backward, {"K1": 1, "K2": 1})
        a1 = A.clone().requires_grad_(True)
        rt.sketch_general(S, a1).backward(G)
        g_err = rel_err(g.to_local(), a1.grad)
        check(g_err <= K1_REL_TOL, f"(M1) gradient {g_err}")
        print(f"(M1) the gradient (K2) against sketch_general's: normalised "
              f"{g_err:.3g} <= {K1_REL_TOL}")
        timed("(M1) distributed_sketch, 1x1 NCCL mesh",
              lambda: par.distributed_sketch(S, A_dt, mesh),
              lambda: rt.sketch_general(S, A), "sketch_general")
        timed("(M1) forward + backward, 1x1 NCCL mesh", backward,
              lambda: rt.sketch_general(S, a1).backward(G),
              "sketch_general's", reps=3)
        breakdown("(M1) distributed_sketch, 1x1 NCCL mesh",
                  lambda: par.distributed_sketch(S, A_dt, mesh), card)
        del a_leaf, a1, g, G, B

        # (M1) emulated: K1 a shard; each tile from K3 bitwise the slice
        # of one full K3 fill
        full = fs.fill_block(S, D, M, device=dev, transform="boxmul")
        for shape in MESHES11:
            d_per, m_per = pd.left_extents(S, shape)
            for mi in range(shape[0]):
                for di in range(shape[1]):
                    ro, rows = pd.shard_span(D, d_per, mi)
                    co, cols = pd.shard_span(M, m_per, di)
                    tile = fs.fill_block(S, rows, cols, ro, co, device=dev,
                                         transform="boxmul")
                    check(torch.equal(tile, full[ro:ro + rows,
                                                 co:co + cols]),
                          f"(M1) {shape} tile ({mi}, {di}) is not the slice "
                          "of the full K3 fill")
        labels = ", ".join(f"{a}x{b}" for a, b in MESHES11)
        print(f"(M1) each shard tile of the {labels} meshes from K3 is "
              "bitwise the slice of one full K3 fill")
        del full
        emulate("M1", summed(lambda a, c, sh: pd.left_shard(S, a, c, sh),
                             lambda sh: pd.left_extents(S, sh), M,
                             lambda off, ext: A[off:off + ext]),
                shards, B1, K1_REL_TOL)

        # (M2) right sketch at run_all.py config 2: K1 on each transposed
        # tile
        S2 = rt.DenseSkOp(rt.DenseDist(C2, D2, rt.DenseDistName.Uniform),
                          rt.RNGState.from_key(seed + 42))
        A2 = randn(R2, C2)
        emulate("M2", summed(lambda a, c, sh: pd.right_shard(S2, a, c, sh),
                             lambda sh: pd.right_extents(S2, sh), C2,
                             lambda off, ext: A2[:, off:off + ext], dim=1),
                shards, rt.sketch_general(S2, A2, side="right"), K1_REL_TOL)
        timed("(M2) the single-device right sketch (K1)",
              lambda: rt.sketch_general(S2, A2, side="right"))
        del A2

        # (M3) the SASO sketch at config 3: K4 a shard
        S3 = rt.SparseSkOp(rt.SparseDist(D3, M3, vec_nnz=K3_NNZ),
                           rt.RNGState.from_key(seed + 43)).filled(dev)
        A3 = randn(M3, N3)
        emulate("M3", summed(lambda a, c, sh: pd.sparse_shard(S3, a, c, sh),
                             lambda sh: pd.sparse_extents(S3, sh), M3,
                             lambda off, ext: A3[off:off + ext]),
                lambda sh: {"K4": sh[0] * sh[1]}, rt.sketch_general(S3, A3),
                K4_REL_TOL)
        timed("(M3) the single-device SASO sketch (K4)",
              lambda: rt.sketch_general(S3, A3))
        del A3

        # (M4) the column layout at the main shape: no sum; each shard
        # generates the whole operator, through K1 where the gate takes
        # the shard's tile (not 1 x 4's 1024 columns: the staged route)
        def m4_k1(shape):
            d4, n4 = pd.cols_extents(S, N, shape)
            return skge.fused_profitable(d4, M, n4, torch.float32)

        emulate("M4", tiled(S, A),
                lambda sh: {"K1" if m4_k1(sh) else "K3": sh[0] * sh[1]}, B1,
                lambda sh: K1_REL_TOL if m4_k1(sh) else STAGED_REL_TOL)
        timed("(M1), (M4) the single-device sketch (K1)",
              lambda: rt.sketch_general(S, A))

        # (M5) sparse data at config 4's COO shape: K3 a shard
        rng = np.random.default_rng(seed + 44)
        coo = rt.COOMatrix.from_arrays(
            R4, C4, rng.integers(0, R4, NNZ4), rng.integers(0, C4, NNZ4),
            rng.normal(size=NNZ4).astype(np.float32), device=dev)
        S5 = rt.DenseSkOp(rt.DenseDist(D4, R4),
                          rt.RNGState.from_key(seed + 45))
        emulate("M5", summed(lambda _, c, sh: pd.sparse_data_shard(
                    S5, coo, c, sh), lambda sh: pd.left_extents(S5, sh), R4,
                    lambda off, ext: None),
                lambda sh: {"K3": sh[0] * sh[1]}, rt.sketch_sparse(S5, coo),
                COO_REL_TOL)
        timed("(M5) the single-device COO sketch (K3)",
              lambda: rt.sketch_sparse(S5, coo))
        del coo

        # (M6) pad-and-shard: on 1x4 the counter-aligned shards of 16252
        # rows clip at the parent's 65000
        d6, m6, n6 = PAD11
        S6 = rt.DenseSkOp(rt.DenseDist(d6, m6),
                          rt.RNGState.from_key(seed + 46))
        A6 = randn(m6, n6)
        emulate("M6", summed(lambda a, c, sh: pd.left_shard(S6, a, c, sh),
                             lambda sh: pd.left_extents(S6, sh), m6,
                             lambda off, ext: A6[off:off + ext]),
                shards, rt.sketch_general(S6, A6), K1_REL_TOL)
        timed("(M6) the single-device sketch (K1; A's row stride of 4093 "
              "floats is no TMA stride)", lambda: rt.sketch_general(S6, A6))
        del A6

        # (M7) SRHT over the column layout at (h)'s shape: no kernel
        S7 = rt.TrigSkOp(rt.TrigDist(D, M), rt.RNGState.from_key(seed + 47))
        emulate("M7", tiled(S7, A), lambda sh: {}, rt.sketch_general(S7, A),
                SRHT_REL_TOL)
        timed("(M7) the single-device SRHT sketch",
              lambda: rt.sketch_general(S7, A))
        del A, A_dt, B1

        # -- (M8) distributed_rsvd on (i)'s planted matrix ---------------
        m8, n8, rank = PHASE8["i"]
        A8, sig = planted(randn, m8, n8, rank)
        A8_dt = distribute_tensor(A8, mesh, rows_data)
        st8 = rt.RNGState.from_key(seed + 48)
        (u, s8, vt), _ = drive("(M8) distributed_rsvd, 1x1 NCCL mesh",
                               lambda: la.distributed_rsvd(A8_dt, rank, st8,
                                                           mesh), {"K3": 1})
        check(isinstance(u, DTensor) and u.shape == (m8, rank)
              and vt.shape == (rank, n8), "(M8) factors")
        e8 = ((s8 - sig[:rank]).abs().max() / sig[0]).item()
        e_ref = ((la.rsvd(A8, rank, st8)[1] - sig[:rank]).abs().max()
                 / sig[0]).item()
        check(e8 <= RSVD_TOL, f"(M8) {e8}")
        print(f"(M8) distributed_rsvd: top-{rank} vs the planted singular "
              f"values {e8:.3g} <= {RSVD_TOL} (linalg.rsvd on the same "
              f"matrix {e_ref:.3g}; max abs err / s_1)")
        timed("(M8) distributed_rsvd, 1x1 NCCL mesh",
              lambda: la.distributed_rsvd(A8_dt, rank, st8, mesh),
              lambda: la.rsvd(A8, rank, st8), "linalg.rsvd")
        breakdown("(M8) distributed_rsvd",
                  lambda: la.distributed_rsvd(A8_dt, rank, st8, mesh), card)
        del u, vt

        # -- (M9) distributed_krylov_rangefinder on (s)'s matrix ---------
        st9 = rt.RNGState.from_key(seed + 49)
        Q9, _ = drive(f"(M9) distributed_krylov_rangefinder, block {rank}, "
                      "depth 2, 1x1 NCCL mesh",
                      lambda: la.distributed_krylov_rangefinder(
                          A8_dt, rank, st9, mesh), {"K3": 1})
        q9 = Q9.to_local()
        tail = (sig[rank:].double() ** 2).sum().sqrt().item()
        res9 = (A8 - q9 @ (q9.T @ A8)).double().norm().item()
        orth9 = (q9.T @ q9 - torch.eye(q9.shape[1], device=dev)).abs().max(
            ).item()
        check(res9 <= KRYLOV11_SLACK * tail and orth9 <= KRYLOV11_ORTH,
              f"(M9) residual {res9} (tail {tail}), orthogonality {orth9}")
        print(f"(M9) basis width {q9.shape[1]}, ||A - Q Q^T A||_F {res9:.5g} "
              f"<= {KRYLOV11_SLACK} x the rank-{rank} tail {tail:.5g}, max "
              f"|Q^T Q - I| {orth9:.3g} <= {KRYLOV11_ORTH}")
        timed("(M9) distributed_krylov_rangefinder, 1x1 NCCL mesh",
              lambda: la.distributed_krylov_rangefinder(A8_dt, rank, st9,
                                                        mesh),
              lambda: la.krylov_rangefinder(A8, rank, st9),
              "linalg.krylov_rangefinder")
        breakdown("(M9) distributed_krylov_rangefinder",
                  lambda: la.distributed_krylov_rangefinder(A8_dt, rank, st9,
                                                            mesh), card)
        del A8, A8_dt, Q9, q9

        # -- (M13) Frequent Directions over four emulated 'data' shards --
        m13, n13, ell, _ = PHASE10["fd"]
        A13 = randn(m13, n13)
        per = pd._shard_extent(m13, 4)

        def fd_four():
            parts = [ldist.fd_shard(A13[i * per:(i + 1) * per], ell, per)
                     for i in range(4)]
            return ldist.fd_merge(torch.cat([b for b, _ in parts]),
                                  torch.stack([w for _, w in parts]), n13,
                                  ell, torch.float32)

        g13 = A13.double().T @ A13.double()
        g_norm = torch.linalg.matrix_norm(g13, 2).item()
        fro2 = (A13.double() ** 2).sum().item()
        for label, fn in (("4 emulated 'data' shards", fd_four),
                          ("the 1x1 NCCL mesh",
                           lambda: la.distributed_fd(A13, ell, mesh))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fd, _ = drive(f"(M13) distributed_fd, {label}", fn, {})
            fd_ms = (time.perf_counter() - t0) * 1e3
            b13 = fd.sketch().double()
            err13 = torch.linalg.matrix_norm(g13 - b13.T @ b13, 2).item()
            mass = float(fd.shrink_mass)
            check(err13 <= mass * 1.01 + 1e-3 * g_norm
                  and mass <= fro2 / ell * 1.01,
                  f"(M13) {label}: ||G - B^T B|| {err13}, mass {mass}")
            print(f"(M13) {label}: ||A^T A - B^T B||_2 {err13:.6g} <= the "
                  f"certificate {mass:.6g} (x 1.01 + 1e-3 ||A^T A||_2), "
                  f"which is <= ||A||_F^2 / ell = {fro2 / ell:.6g}; "
                  f"{fd_ms:.1f} ms, one run (host clock) [{card}]")
        del A13, g13, fd, b13

        # -- (M14) ihs_lsq(mesh=) at (j)'s shape, 'gaussian' -------------
        m14, n14, d14 = PHASE8["j"]
        A14 = randn(m14, n14) * torch.logspace(0, -3, n14, device=dev)
        b14 = A14 @ randn(n14) + 1e-3 * randn(m14)
        A14_dt = distribute_tensor(A14, mesh, rows_data)
        b14_dt = distribute_tensor(b14, mesh, rows_data)
        st14 = rt.RNGState.from_key(seed + 50)

        def ihs_mesh():
            return la.ihs_lsq(A14_dt, b14_dt, st14, d=d14,
                              operator="gaussian", mesh=mesh)

        (x14, _), _ = drive("(M14) ihs_lsq(mesh=), 'gaussian', 1x1 NCCL "
                            "mesh", ihs_mesh, {"K1": 1})
        x_ref, _ = la.ihs_lsq(A14, b14, st14, d=d14, operator="gaussian")
        x64 = torch.linalg.lstsq(A14.double(),
                                 b14.double()[:, None]).solution[:, 0]
        e14 = rel_err(x14, x_ref)
        check(e14 <= IHS11_TOL, f"(M14) against the unsharded run: {e14}")
        print(f"(M14) ihs_lsq on the mesh against the unsharded run: "
              f"normalised {e14:.3g} <= {IHS11_TOL} (bitwise "
              f"{torch.equal(x14, x_ref)}); ||x - x64|| / ||x64|| "
              f"{((x14.double() - x64).norm() / x64.norm()).item():.3g}")
        timed("(M14) ihs_lsq(mesh=), 1x1 NCCL mesh", ihs_mesh,
              lambda: la.ihs_lsq(A14, b14, st14, d=d14, operator="gaussian"),
              "ihs_lsq")
        breakdown("(M14) ihs_lsq(mesh=)", ihs_mesh, card)
        del A14, b14, A14_dt, b14_dt
        torch.cuda.empty_cache()
        print(f"phase 11: {time.perf_counter() - t_phase:.1f} s (host clock, "
              "checks and timings included)")
        sharded_input_paths(rt, dev, drive, card, seed, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def sharded_input_paths(rt, dev, drive, card, seed, mesh):
    """Phase 12: the solver tier and the tensor sketches on sharded inputs
    (DTensors on phase 11's 1 x 1 NCCL mesh), paths numbered as the JAX
    package's dryrun_multichip cases 10-12 and the tensor sketches after
    them: (M10) sgmres on a row-sharded A at (t)'s shape, (M11)
    block_kaczmarz on a row-sharded system and (M12) block_gauss_seidel
    ('shuffle' and 'colnorm') on a column-sharded one at (y)'s, (M15)
    tensor_sketch and (M16) kfjlt_sketch of column-sharded factors at (l)'s.
    Each path: its launch counts, its result against the unsharded call on
    the same card (rtol 1e-4 and atol 1e-5 for the solvers, as the
    dryrun's, with sgmres's true residual below 1e-4; the tensor sketches
    bitwise) and the same next_state, and its time by
    ``profiling.time_op`` (CUDA events, median of 4 after a warm-up) beside
    the unsharded call's. The data are made on the card from ``seed``."""
    import math

    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import profiling

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 60)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rows(x):
        return distribute_tensor(x, mesh, [Replicate(), Shard(0)])

    def cols(x):
        return distribute_tensor(x, mesh, [Replicate(), Shard(1)])

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def ends(out):
        """(result, next_state) of a call that returns more between them."""
        return out[0], out[-1]

    def time_ms(fn, ops, flops):
        """profiling.time_op of ``fn``: one call a step, the carry a
        function of its first output's first entry."""
        t = profiling.time_op(
            lambda i, c, *_: c + local(fn()[0]).reshape(-1)[0] * 0, *ops,
            flops=flops)
        return t.seconds * 1e3, t.gflops

    print(f"phase 12: the solver tier and the tensor sketches on sharded "
          f"inputs, paths (M10)-(M16), on the 1x1 NCCL mesh [{card}]")

    def path(label, sharded, plain, ops, expect, flops, exact=False):
        """Drive ``sharded`` with the counts at 0, hold its output and
        next_state against ``plain``'s, time both, and profile one call of
        each (busy time, idle share). ``flops``: the path's products, for
        the GFLOP/s beside its time."""
        (got, nxt), _ = drive(label, lambda: ends(sharded()), expect)
        want, nxt_want = ends(plain())
        torch.cuda.synchronize()
        check(isinstance(got, DTensor), f"{label}: {type(got).__name__}")
        got = local(got)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label}: {tuple(got.shape)}")
        check(nxt.to_dict() == nxt_want.to_dict(),
              f"{label}: next_state differs from the unsharded call's")
        same = torch.equal(got, want)
        err = abs_err(got, want)
        # is the unsharded call itself bitwise repeatable on the card?
        again = torch.equal(ends(plain())[0], want)
        if exact:
            check(same, f"{label}: not bitwise the unsharded call ({err})")
        else:
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-5),
                  f"{label}: max abs err {err} against the unsharded call")
        ms, gf = time_ms(sharded, ops, flops)
        ms1, gf1 = time_ms(plain, ops, flops)
        print(f"{label}: against the unsharded call bitwise {same}, max abs "
              f"err {err:.3g} ({'bitwise' if exact else 'rtol 1e-4, atol '
              '1e-5'}); the unsharded call twice bitwise {again}; "
              f"next_state equal; profiling.time_op {ms:.3f} ms "
              f"({gf:.1f} GFLOP/s), unsharded {ms1:.3f} ms ({gf1:.1f}) "
              f"[{card}]")
        breakdown(f"{label.split(' ')[0]} sharded", sharded, card)
        breakdown(f"{label.split(' ')[0]} unsharded", plain, card)
        return got

    # -- (M10) sgmres on a row-sharded A at (t)'s shape -------------------
    nt, basis, _, _ = PHASE9["t"]
    At = randn(nt, nt) / math.sqrt(nt) + 4 * torch.eye(nt, device=dev)
    bt = randn(nt)
    At_dt = rows(At)
    st = rt.RNGState.from_key(seed + 61)
    x = path(f"(M10) sgmres n={nt}, basis {basis}, row-sharded A",
             lambda: la.sgmres(At_dt, bt, st, basis=basis),
             lambda: la.sgmres(At, bt, st, basis=basis), (At, bt),
             {"K4": 3, "K7": 3}, 2.0 * nt * nt * (basis + 1))
    true = ((At.double() @ x.double() - bt.double()).norm()
            / bt.double().norm()).item()
    check(true <= SGMRES_TOL, f"(M10) true residual {true}")
    print(f"(M10) true relative residual {true:.3g} <= {SGMRES_TOL}")
    del At, At_dt

    # -- (M11), (M12) Kaczmarz and Gauss-Seidel at (y)'s shape ------------
    my, ny, blk, steps = PHASE10["y"]
    Ay = randn(my, ny)
    by = Ay @ randn(ny)
    Ay_rows, by_rows, Ay_cols = rows(Ay), rows(by), cols(Ay)
    st = rt.RNGState.from_key(seed + 62)
    path(f"(M11) block_kaczmarz {my}x{ny}, block {blk}, {steps} steps, "
         "row-sharded A and b",
         lambda: la.block_kaczmarz(Ay_rows, by_rows, st, block=blk,
                                   steps=steps),
         lambda: la.block_kaczmarz(Ay, by, st, block=blk, steps=steps),
         (Ay, by), {}, steps * (2.0 * blk * blk * ny + 4.0 * blk * ny))
    nblocks = -(-ny // blk)
    for sampling, expect, grams in (("shuffle", {"K3": 1}, nblocks),
                                    ("colnorm", {}, steps)):
        path(f"(M12) block_gauss_seidel '{sampling}' {my}x{ny}, block {blk}, "
             f"{steps} steps, column-sharded A",
             lambda: la.block_gauss_seidel(Ay_cols, by, st, block=blk,
                                           steps=steps, sampling=sampling),
             lambda: la.block_gauss_seidel(Ay, by, st, block=blk,
                                           steps=steps, sampling=sampling),
             (Ay, by), expect,
             grams * 2.0 * blk * blk * my + steps * 4.0 * blk * my)
    del Ay, by, Ay_rows, by_rows, Ay_cols
    torch.cuda.empty_cache()

    # -- (M15), (M16) the tensor sketches at (l)'s shape ------------------
    ml, nl, dl = PHASE8["l"]
    F1, F2 = randn(ml, nl), randn(ml, nl)
    F_cols = [cols(F1), cols(F2)]
    st = rt.RNGState.from_key(seed + 63)
    for label, fn, expect in (("(M15) tensor_sketch", rt.tensor_sketch,
                               {"K4": 2, "K7": 2}),
                              ("(M16) kfjlt_sketch", rt.kfjlt_sketch, {})):
        path(f"{label} of two {ml}x{nl} factors to d = {dl}, "
             "column-sharded", lambda: fn(F_cols, dl, st),
             lambda: fn([F1, F2], dl, st), (F1, F2), expect,
             2.0 * 2 * ml * nl, exact=True)
    del F1, F2, F_cols
    torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s (host clock, "
          "checks and timings included)")


def gate_paths(rt, dev, drive, card, main_call):
    """Phase 13: the H100 dispatch gates (gate_sweep.py; PERF.md "H100
    gates"). At the grid points nearest each side of each boundary, the
    route "auto" takes (launch counts, routes) is the gate's decision, the
    result is within the bound of the route it stands in for (the forced
    other route), and both routes are timed. Then the main path once more
    (K1 1), and config 4b plus one full row through ``left_spmm`` on the
    COO route (no table built) against the plain product."""
    import importlib
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.ops import coo_apply, hadamard
    spmm = importlib.import_module("randblas_tpu_torch.sparse_data.spmm")
    t_phase = time.perf_counter()
    print("phase 13: the H100 gates, the route under \"auto\" on each side "
          "of each boundary against the forced other route")
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def point(name, call, expect, routes, forced, tol, decided):
        """``call`` under "auto" launches ``expect`` and takes ``routes``
        (None: no route count), as the gate ``decided``; under ``forced``
        it takes the other route; both within ``tol`` and timed."""
        got, _ = drive(f"(13) {name}", call, expect)
        if routes is not None:
            check(dict(skge.route_counts) == routes,
                  f"(13) {name}: routes {dict(skge.route_counts)}")
        with rt.flags(**forced):
            want = call()
        err = rel_err(got, want)
        check(err <= tol, f"(13) {name}: vs the forced route {err}")
        auto_ms = time_ms(call)
        with rt.flags(**forced):
            forced_ms = time_ms(call)
        print(f"(13) {name}: gate {decided}; auto {auto_ms:.3f} ms, forced "
              f"{forced} {forced_ms:.3f} ms; normalised difference "
              f"{err:.3g} <= {tol} [{card}]")

    def dense(name, dims, data, kw, kernel, route, dtype=torch.float32,
              major="Long"):
        S = rt.DenseSkOp(rt.DenseDist(*dims, rt.DenseDistName.Gaussian,
                                      rt.MajorAxis[major]),
                         rt.RNGState.from_key(130))
        side_right = kw.get("side") == "right"
        rows, cont = (dims[1], dims[0]) if (side_right or "op_s" in kw) \
            else dims
        n = data.shape[0] if side_right else data.shape[1]
        take = skge.fused_profitable(rows, cont, n, dtype)
        check(take == (kernel is not None), f"(13) {name}: the gate says "
              f"{take}")
        expect = {kernel: 1} if kernel else {"K3": 1}
        staged = "right_staged" if side_right else "left_staged"
        point(name, lambda: rt.sketch_general(S, data, **kw), expect,
              {route if kernel else staged: 1},
              {"use_fused": not kernel}, STAGED_REL_TOL,
              f"fused_profitable({rows}, {cont}, {n}, {str(dtype)[6:]}) = "
              f"{take}")

    # K1 / K2: each rule of fused_profitable from both sides
    A = randn(65536, 2048)
    dense("K1 n=1024, 2048 rows (cluster 4)", (2048, 65536),
          A[:, :1024].contiguous(), {}, "K1", "left_fused")
    dense("K1 n=1024, 1024 rows (cluster 4)", (1024, 65536),
          A[:, :1024].contiguous(), {}, None, None)
    dense("K1 2^31 operations", (64, 8192), A[:8192].contiguous(), {}, None,
          None)
    dense("K1 past 2^31 operations", (64, 65536), A, {}, "K1", "left_fused")
    dense("K1 n=256, 16384 rows (cluster 1)", (16384, 8192),
          A[:8192, :256].contiguous(), {}, "K1", "left_fused", major="Short")
    dense("K1 n=64, 16384 rows", (16384, 8192), A[:8192, :64].contiguous(),
          {}, None, None, major="Short")
    dense("K2 n=512, 8192 rows (cluster 2)", (8192, 1024),
          A[:1024, :512].contiguous(), {}, "K2", "left_colmajor_fused")
    dense("K2 n=512, 2048 rows (cluster 2)", (2048, 1024),
          A[:1024, :512].contiguous(), {}, None, None)
    Y = A[:32768]
    dense("left-Trans, n=2048", (32768, 1024), Y.contiguous(), {"op_s": "T"},
          "K1", "left_trans_fused")
    dense("left-Trans, n=1024", (32768, 1024), Y[:, :1024].contiguous(),
          {"op_s": "T"}, None, None)
    dense("right, 2048 data rows", (32768, 1024), Y.T.contiguous(),
          {"side": "right"}, "K1", "right_fused")
    dense("right, 1024 data rows", (32768, 1024),
          Y[:, :1024].T.contiguous(), {"side": "right"}, None, None)
    del A, Y
    A = randn(65536, 4096)
    dense("bf16 data at the main shape", (1024, 65536),
          A.to(torch.bfloat16), {}, None, None, dtype=torch.bfloat16)
    B, _ = drive("(13) the main path once more", main_call(A), {"K1": 1})
    check(skge.route_counts == {"left_fused": 1},
          f"(13) main path routes {dict(skge.route_counts)}")
    del A, B
    torch.cuda.empty_cache()

    # K4: d = 4096, m = 262144 at n = 16 (fixed-nnz) and 128 (K4)
    A = randn(262144, 128)
    S = rt.SparseSkOp(rt.SparseDist(4096, 262144, 8),
                      rt.RNGState.from_key(131)).filled(dev)
    for n, kernel in ((16, False), (128, True)):
        check(skge.saso_profitable(4096, 262144, n) == kernel,
              f"(13) K4 gate at n={n}")
        An = A[:, :n].contiguous()
        point(f"K4 d=4096 m=262144 n={n}", lambda: rt.sketch_general(S, An),
              {"K4": 1} if kernel else {},
              {"sparse_saso_kernel" if kernel else "sparse_fixed_nnz": 1},
              {"use_saso_kernel": not kernel}, STAGED_REL_TOL,
              f"saso_profitable(4096, 262144, {n}) = {kernel}")
    del A, S, An
    torch.cuda.empty_cache()

    # K5: config 4b with a heavy row 0 of 24 entries in each 128-column
    # block (bw 32) at n = 8 (K5) and 1 (COO), and with one full row (bw
    # 136: COO, no table built)
    rng = np.random.default_rng(3)
    r4, c4 = rng.integers(0, R4, NNZ4), rng.integers(0, C4, NNZ4)
    v4 = rng.normal(size=NNZ4).astype(np.float32)
    run = np.concatenate([np.arange(b, min(b + 24, C4))
                          for b in range(0, C4, 128)])
    coo = rt.COOMatrix.from_arrays(
        R4, C4, np.concatenate([r4, np.zeros_like(run)]),
        np.concatenate([c4, run]),
        np.concatenate([v4, rng.normal(size=run.size).astype(np.float32)]),
        device=dev)
    B = randn(C4, 512)
    for n, kernel in ((8, True), (1, False)):
        check(spmm.blocked_ell_profitable(n, 32) == kernel,
              f"(13) K5 gate at n={n}")
        Bn = B[:, :n].contiguous()
        point(f"K5 config 4b, bw 32, n={n}", lambda: rt.left_spmm(coo, Bn),
              {"K5": 1} if kernel else {}, None,
              {"auto_blocked_ell": not kernel}, STAGED_REL_TOL,
              f"blocked_ell_profitable({n}, bw 32) = {kernel}")
    check(coo._bell_bw == 32, f"(13) bw {coo._bell_bw}, expected 32")
    heavy = rt.COOMatrix.from_arrays(
        R4, C4, np.concatenate([r4, np.full(C4, 7)]),
        np.concatenate([c4, np.arange(C4)]),
        np.concatenate([v4, rng.normal(size=C4).astype(np.float32)]),
        device=dev)
    t0 = time.perf_counter()
    declined = spmm._blocked_ell_or_none(heavy, B) is None
    gate_s = time.perf_counter() - t0
    check(declined and heavy._bell_bw == 136
          and getattr(heavy, "_bell_cache", None) is None,
          f"(13) heavy row: bw {heavy._bell_bw}, declined {declined}")
    got, _ = drive("(13) config 4b plus one full row, left_spmm",
                   lambda: rt.left_spmm(heavy, B), {})
    check(getattr(heavy, "_bell_cache", None) is None,
          "(13) heavy row: a table was built")
    dense_h = heavy.to_dense()
    err = rel_err(got, dense_h @ B)
    check(err <= HEAVY_ROW_TOL, f"(13) heavy row vs the plain product: {err}")
    err64 = rel_err(got, dense_h.double() @ B.double())
    check(err64 <= COO_REL_TOL, f"(13) heavy row vs float64: {err64}")
    coo_ms = time_ms(lambda: rt.left_spmm(heavy, B))
    t0 = time.perf_counter()
    with rt.flags(auto_blocked_ell=True):
        rt.left_spmm(heavy, B)
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        k5_ms = time_ms(lambda: rt.left_spmm(heavy, B))
    bell = heavy._bell_cache
    print(f"(13) config 4b plus one full row (bw {heavy._bell_bw}): the gate "
          f"declined in {gate_s:.3f} s, no table built; the COO route "
          f"{coo_ms:.3f} ms, vs the plain float32 product {err:.3g} <= "
          f"{HEAVY_ROW_TOL}, vs float64 {err64:.3g} <= {COO_REL_TOL}; "
          f"forced K5: conversion {conv_s:.2f} s, tables "
          f"{(bell.local_cols.numel() + bell.vals.numel()) * 4 / 2**30:.2f} "
          f"GiB, {k5_ms:.3f} ms a call [{card}]")
    del coo, heavy, bell, B, dense_h, got
    torch.cuda.empty_cache()

    # the COO model: 2^20 entries on n = 16 at d = 512 (densify) and 4096
    # (gather), m = 65536
    real = {f: getattr(coo_apply, f) for f in ("coo_left_apply",
                                               "coo_left_apply_dense")}
    calls = []

    def counted(f):
        def run(*args, **kwargs):
            calls.append(f)
            return real[f](*args, **kwargs)
        return run
    B = randn(65536, 16)
    for d, dense_route in ((512, True), (4096, False)):
        r = torch.randint(0, d, (1 << 20,), generator=gen, device=dev)
        c = torch.randint(0, 65536, (1 << 20,), generator=gen, device=dev)
        v = randn(1 << 20)
        check(coo_apply.densify_wins(1 << 20, 16, d, 65536, True)
              == dense_route, f"(13) COO model at d={d}")
        for f in real:
            setattr(coo_apply, f, counted(f))
        try:
            calls.clear()
            got = coo_apply.coo_left_apply_auto(r, c, v, B, d, 65536)
        finally:
            for f, fn in real.items():
                setattr(coo_apply, f, fn)
        taken = "coo_left_apply_dense" if dense_route else "coo_left_apply"
        check(calls == [taken], f"(13) COO model at d={d}: {calls}")
        other = real["coo_left_apply" if dense_route
                     else "coo_left_apply_dense"]
        err = rel_err(got, other(r, c, v, B, d, 65536))
        check(err <= COO_REL_TOL, f"(13) COO routes at d={d}: {err}")
        auto_ms = time_ms(lambda: coo_apply.coo_left_apply_auto(
            r, c, v, B, d, 65536))
        other_ms = time_ms(lambda: other(r, c, v, B, d, 65536))
        print(f"(13) COO model d={d} m=65536 nnz=2^20 n=16: {taken} "
              f"{auto_ms:.3f} ms, the other {other_ms:.3f} ms; normalised "
              f"difference {err:.3g} <= {COO_REL_TOL} [{card}]")
    del B, r, c, v, got
    torch.cuda.empty_cache()

    # the SRHT's stage cap: m = 2^16, n = 4096
    from randblas_tpu_torch import trig
    A = randn(65536, 4096)
    S = rt.TrigSkOp(rt.TrigDist(1024, 65536), rt.RNGState.from_key(132))
    caps = []
    real_h = trig.hadamard_transform

    def spy(x, max_factor=512):
        caps.append(max_factor)
        return real_h(x, max_factor)
    trig.hadamard_transform = spy
    try:
        got, _ = drive("(13) SRHT sketch at m=2^16", lambda: rt.sketch_general(
            S, A), {})
    finally:
        trig.hadamard_transform = real_h
    check(caps == [hadamard.SRHT_CUDA_MAX_FACTOR],
          f"(13) SRHT caps {caps}")
    cap_ms = time_ms(lambda: rt.sketch_general(S, A))
    saved = hadamard.SRHT_CUDA_MAX_FACTOR
    hadamard.SRHT_CUDA_MAX_FACTOR = 512
    try:
        want = rt.sketch_general(S, A)
        old_ms = time_ms(lambda: rt.sketch_general(S, A))
    finally:
        hadamard.SRHT_CUDA_MAX_FACTOR = saved
    err = rel_err(got, want)
    check(err <= SRHT_REL_TOL, f"(13) SRHT cap {saved} vs 512: {err}")
    print(f"(13) SRHT 1024x65536 @ 65536x4096: cap {saved} {cap_ms:.3f} ms, "
          f"cap 512 {old_ms:.3f} ms; normalised difference {err:.3g} <= "
          f"{SRHT_REL_TOL} [{card}]")
    del A, S, got, want
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s (host clock, "
          "checks and timings included)")


def tls_x64(ab):
    """The classical TLS solution of [A b] in float64: the eigenvector of
    the smallest eigenvalue of its Gram matrix."""
    ab = ab.double()
    v = torch.linalg.eigh(ab.T @ ab)[1][:, 0]
    return -v[:-1] / v[-1]


def rank1_rmt(m, n, p, theta=25.0):
    """The spiked-matrix prediction (Benaych-Georges and Nadakuditi 2012)
    for theta u v^T plus an m x n noise of iid entries of variance p:
    (sigma_1, |cos(u)|, |cos(v)|, the noise's bulk edge)."""
    import math
    s, g = math.sqrt(p * m), n / m
    b2 = (theta / s) ** 2
    return (s * math.sqrt((1 + b2) * (g + b2) / b2),
            math.sqrt(1 - (g + b2) / (b2 * (b2 + 1))),
            math.sqrt(1 - g * (1 + b2) / (b2 * (b2 + g))),
            s * (1 + math.sqrt(g)))


def application_paths(dev, drive, card, expect):
    """Phase 14: the eleven applications of examples_torch/ through their
    run(), at the JAX examples' default sizes, then (A1), (A2), (A6) and
    (A10) at APP_SCALED. Each under ``drive`` with the launches of
    ``expect`` (keyed by case), its result against its ground truth (a
    planted structure, a float64 reference or its certificate), its time
    (the example's profiling.time_op) and the idle share of one profiled
    call of the example's timed call."""
    import importlib
    import socket

    import torch.distributed as dist
    from randblas_tpu_torch import RNGState
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import parallel as par
    ex = {name: importlib.import_module(f"examples_torch.{name}") for name in (
        "total_least_squares", "low_rank_svd", "qrcp_low_rank",
        "svd_matrixmarket", "sketch_precondition_lsq", "kernel_ridge",
        "spectrum_exploration", "cp_als_tensor_sketch", "tt_compression",
        "distributed_sketching", "multihost_cpu_demo")}
    t_phase = time.perf_counter()
    print(f"phase 14: the applications of examples_torch/ [{card}]")

    def case(key, label, fn):
        t0 = time.perf_counter()
        r, _ = drive(f"({key}) {label}", fn, expect[key])
        torch.cuda.synchronize()
        print(f"({key}) {label}: {time.perf_counter() - t0:.2f} s host "
              "clock, set-up and checks included")
        return r

    def report(key, what, ok, text):
        check(ok, f"({key}) {what}: {text}")
        print(f"({key}) {what}: {text} [{card}]")

    def profiled(key, fn):
        breakdown(f"({key}) timed call", fn, card, warm=False)

    def rel2(got, want):
        """||got - want|| / ||want||, float64 2-norms."""
        return float(torch.linalg.norm(got.double() - want.double())
                     / torch.linalg.norm(want.double()))

    # -- (A1) total least squares ------------------------------------------
    tls = ex["total_least_squares"]
    for key, (m, n) in (("A1", (10000, 500)), ("A1s", APP_SCALED["A1"])):
        r = case(key, f"total_least_squares m={m} n={n} d={2 * (n + 1)}",
                 lambda: tls.run(m, n, device=dev))
        x64 = tls_x64(r["ab"])
        e64 = rel2(r["x"]["classical"], x64)
        report(key, "classical x vs the float64 TLS solution", e64 <=
               APP_TLS_X64, f"{e64:.3g} <= {APP_TLS_X64}")
        for name, err in r["err"].items():
            bound = 1.0 if name == "classical" else APP_TLS_ERR
            report(key, f"{name}: ||x - x_true|| / ||x_true||", err <= bound,
                   f"{err:.4g} <= {bound}; {r['seconds'][name] * 1e3:.3f} "
                   "ms (profiling.time_op)")
        profiled(key, r["call"])
        del r, x64
        torch.cuda.empty_cache()

    # -- (A2) rank-1 spike plus sparse noise --------------------------------
    lr = ex["low_rank_svd"]
    r = case("A2", "low_rank_svd 2000x1500 k=8", lambda: lr.run(device=dev))
    err, cos = APP_RANK1
    report("A2", "sigma_1 vs 25, |cos(u)|, |cos(v)|",
           r["sigma1_rel_err"] <= err and min(r["cos_u"], r["cos_v"]) >= cos,
           f"{r['sigma1_rel_err']:.3g} <= {err}; {r['cos_u']:.6f}, "
           f"{r['cos_v']:.6f} >= {cos}; nnz {r['nnz']}; "
           f"{r['seconds'] * 1e3:.3f} ms")
    profiled("A2", r["call"])
    m, n, p = APP_SCALED["A2"]
    r = case("A2s", f"low_rank_svd {m}x{n} p={p} k=8, COO built on the card",
             lambda: lr.run(m, n, p, device=dev))
    sig, cu, cv, edge = rank1_rmt(m, n, p)
    print(f"(A2s) nnz {r['nnz']}; the example's k=8, 2 power iterations: "
          f"sigma {[round(x, 4) for x in r['s'][:3].tolist()]}, |cos(u)| "
          f"{r['cos_u']:.4f}, |cos(v)| {r['cos_v']:.4f}, "
          f"{r['seconds'] * 1e3:.3f} ms; random-matrix prediction sigma_1 "
          f"{sig:.4f}, |cos(u)| {cu:.4f}, |cos(v)| {cv:.4f}, noise bulk edge "
          f"{edge:.4f} [{card}]")
    profiled("A2s", r["call"])

    def resolved():
        q, b = la.qb_decompose(r["a"], 8, RNGState.from_key(3),
                               power_iters=APP_RMT_ITERS)
        return la.qb_to_svd(q, b)

    (u, s_, vt), _ = drive(f"(A2s) the same QB with {APP_RMT_ITERS} power "
                           "iterations", resolved, expect["A2s_resolved"])
    s1 = float(s_[0])
    cos_u = abs(float(u[:, 0] @ torch.from_numpy(r["u"]).to(dev)))
    cos_v = abs(float(vt[0] @ torch.from_numpy(r["v"]).to(dev)))
    err, tol = APP_RMT
    report("A2s", f"{APP_RMT_ITERS} power iterations vs the prediction",
           abs(s1 / sig - 1) <= err and abs(cos_u - cu) <= tol
           and abs(cos_v - cv) <= tol
           and float(r["s"][0]) <= s1 * (1 + 1e-5),
           f"sigma_1 {s1:.4f} ({abs(s1 / sig - 1):.3g} <= {err}), |cos(u)| "
           f"{cos_u:.4f}, |cos(v)| {cos_v:.4f} (within {tol}); the "
           "example's sigma_1 a lower bound")
    del r, u, s_, vt
    torch.cuda.empty_cache()

    # -- (A3) QRCP -----------------------------------------------------------
    r = case("A3", "qrcp_low_rank 3000x1200 k=16",
             lambda: ex["qrcp_low_rank"].run(device=dev))
    piv = r["piv"][:8].tolist()
    report("A3", "rank-16 error, leading pivots",
           r["rel"] <= APP_QRCP_ERR and piv == APP_QRCP_PIVOTS
           and all(rel <= APP_QRCP_ERR for rel, _ in r["study"].values()),
           f"{r['rel']:.4g} <= {APP_QRCP_ERR}; pivots {piv}; study "
           f"{ {k: round(v[0], 6) for k, v in r['study'].items()} }; "
           f"{r['seconds'] * 1e3:.3f} ms")
    profiled("A3", r["call"])

    # -- (A4) power-iteration SVD of a MatrixMarket file --------------------
    sm = ex["svd_matrixmarket"]
    r = case("A4", "svd_matrixmarket, the demo file, ELL, k=32, p=2",
             lambda: sm.run(device=dev))
    with open(r["path"], "rb") as f, open(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "data",
            "sparse_rank20.mtx"), "rb") as g:
        check(f.read() == g.read(), "(A4) the demo file differs from "
              "data/sparse_rank20.mtx")
    for stab, res in r["runs"].items():
        bound = (APP_SVD_SLACK * r["best"] if stab in ("qr", "sketch")
                 else APP_SVD_UNSTABLE)
        report("A4", f"stabilizer {stab}: rank-32 error", res["err"] <= bound,
               f"{res['err']:.4g} <= {bound:.4g} (exact {r['best']:.4g}); "
               f"{res['seconds'] * 1e3:.3f} ms")
    print("(A4) the demo file is data/sparse_rank20.mtx byte for byte "
          f"(nnz {r['nnz']} as ELL slots)")
    profiled("A4", r["runs"]["qr"]["call"])

    # -- (A5) sketch-and-precondition, float64 -----------------------------
    r = case("A5", "sketch_precondition_lsq 20000x400 cond 1e8 float64",
             lambda: ex["sketch_precondition_lsq"].run(device=dev))
    A, b = r["A"], r["b"]
    xs = torch.linalg.lstsq(A, b[:, None], driver="gels").solution[:, 0]
    res_ls = float(torch.linalg.norm(A @ xs - b))
    iters, x_tol, ihs_tol = APP_LSQ
    ex_, ei = rel2(r["x"], xs), rel2(r["x_ihs"], xs)
    report("A5", "CGLS iterations, x and IHS x vs float64 lstsq, residuals",
           r["x"].dtype == torch.float64 and r["iters"] <= iters
           and ex_ <= x_tol and ei <= ihs_tol
           and r["res"] <= res_ls * (1 + APP_LSQ_RES)
           and r["res_ihs"] <= res_ls * (1 + APP_LSQ_RES),
           f"{r['iters']} <= {iters} (plain CGLS {r['iters_plain']}, "
           f"residual {r['res_plain']:.4g}); {ex_:.3g} <= {x_tol}; "
           f"{ei:.3g} <= {ihs_tol}; residuals {r['res']:.10g}, "
           f"{r['res_ihs']:.10g} vs lstsq {res_ls:.10g}; "
           f"{r['seconds'] * 1e3:.3f} ms, IHS {r['seconds_ihs'] * 1e3:.3f} ms")
    profiled("A5", r["call"])
    del r, A, b, xs

    # -- (A6) kernel ridge ---------------------------------------------------
    kr = ex["kernel_ridge"]
    for key, n in (("A6", 3000), ("A6s", APP_SCALED["A6"])):
        r = case(key, f"kernel_ridge n={n} dim=4 d=200 (K built in row "
                 "blocks)", lambda: kr.run(n, device=dev))
        res, iters, rmse = APP_KRR
        report(key, "system residual, CG iterations, test RMSE",
               r["res_rel"] <= res and r["iters"] <= iters
               and r["rmse"] <= rmse,
               f"{r['res_rel']:.3g} <= {res}; {r['iters']} <= {iters}; "
               f"{r['rmse']:.4f} <= {rmse}; {r['seconds'] * 1e3:.3f} ms")
        profiled(key, r["call"])
        del r
        torch.cuda.empty_cache()

    # -- (A7) spectrum exploration ------------------------------------------
    r = case("A7", "spectrum_exploration n=2048",
             lambda: ex["spectrum_exploration"].run(device=dev))
    tot, cnt, ritz = APP_DOS
    top = np.sort(r["lam"])[-12:]
    w = np.sort(r["w"].cpu().numpy())[-12:]
    ritz_err = float(np.abs(w - top).max()) if r["k"] == 12 else float("inf")
    n = len(r["lam"])
    report("A7", "SLQ and KPM integrals, eig_count, Ritz values, FD",
           abs(r["slq_integral"] / n - 1) <= tot
           and abs(r["kpm_integral"] / n - 1) <= tot
           and abs(r["count"] - 12) <= cnt and ritz_err <= ritz
           and r["fd_true"] <= r["fd_cert"] <= r["fd_worst"],
           f"{r['slq_integral']:.2f}, {r['kpm_integral']:.2f} of {n}; "
           f"count {r['count']:.3f}; Ritz {ritz_err:.3g} <= {ritz}; FD "
           f"{r['fd_true']:.4f} <= {r['fd_cert']:.4f} <= "
           f"{r['fd_worst']:.4f}; SLQ {r['seconds'] * 1e3:.3f} ms")
    profiled("A7", r["call"])
    del r

    # -- (A8) CP-ALS with TensorSketch --------------------------------------
    r = case("A8", "cp_als_tensor_sketch 100x150x150 rank 5",
             lambda: ex["cp_als_tensor_sketch"].run(device=dev))
    f, t = r["fit"], r["seconds"]
    exact, ratio = APP_CP
    report("A8", "fits", f["exact"] >= exact and f["ts"] >= ratio * f["exact"]
           and f["kfjlt"] >= ratio * f["exact"],
           f"exact {f['exact']:.4f} ({t['exact'] * 1e3:.1f} ms), "
           f"TensorSketch d=4096 {f['ts']:.4f} ({t['ts'] * 1e3:.1f} ms), "
           f"KFJLT d=128 {f['kfjlt']:.4f} ({t['kfjlt'] * 1e3:.1f} ms), "
           f"TensorSketch d=128 {f['ts_small']:.4f}")
    profiled("A8", r["call"])

    # -- (A9) tensor train ---------------------------------------------------
    r = case("A9", "tt_compression n=48, 4 modes",
             lambda: ex["tt_compression"].run(device=dev))
    e8, er, en = APP_TT
    nrm = abs(r["tt_norm"] / r["dense_norm"] - 1)
    report("A9", "rank-8 error, rounding error, tt_norm",
           r["compress"][8][0] <= e8 and r["round_err"] <= er and nrm <= en,
           f"{r['compress'][8][0]:.3g} <= {e8}; {r['round_err']:.3g} <= "
           f"{er}; {nrm:.3g} <= {en}; errors "
           f"{ {k: f'{v[0]:.3g}' for k, v in r['compress'].items()} }; "
           f"rank-8 compression {r['compress'][8][2] * 1e3:.3f} ms")
    profiled("A9", r["call"])

    # -- (A10) distributed sketching on the 1 x 1 NCCL mesh -----------------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    par.initialize_multihost(f"localhost:{port}", num_processes=1,
                             process_id=0)
    try:
        ds = ex["distributed_sketching"]
        for key, (d, m, n) in (("A10", (32, 1024, 64)),
                               ("A10s", APP_SCALED["A10"])):
            r = case(key, f"distributed_sketching {d}x{m}@{m}x{n}, 1x1 "
                     "NCCL mesh", lambda: ds.run(d, m, n, device=dev))
            orth, sv = APP_DIST
            diff = r["meshes"]["1x1"]["max_abs_diff"]
            report(key, "the 1x1 mesh vs sketch_general, rangefinder, "
                   "distributed_rsvd", diff == 0 and r["orth_err"] <= orth
                   and r["sv_err"] <= sv,
                   f"max |diff| {diff} (bitwise); |Q^T Q - I| "
                   f"{r['orth_err']:.3g} <= {orth}; singular values "
                   f"{r['sv_err']:.3g} <= {sv}; {r['seconds'] * 1e3:.3f} ms "
                   f"(sketch_general {r['seconds_single'] * 1e3:.3f} ms)")
            profiled(key, r["call"])
            del r
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # -- (A11) the multi-host demo: two CPU processes over gloo -------------
    rc, outs = case("A11", "multihost_cpu_demo, two processes, gloo",
                    ex["multihost_cpu_demo"].run)
    report("A11", "both processes verified their blocks", rc == [0, 0]
           and all("verified" in text for text in outs), f"exit codes {rc}")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s (host clock, "
          "set-up, checks and profiles included)")


def card_tier(card):
    """Phase 15: the card tier (tests/test_torch_cuda_hardware.py) in a
    subprocess on this card, after the other phases; its counts and
    seconds, and a failure if any test failed, erred or skipped."""
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
         "no:cacheprovider", "tests/test_torch_cuda_hardware.py"],
        cwd=root, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    summary = (res.stdout.strip().splitlines() or [""])[-1]
    count = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?)", summary)}
    passed = count.get("passed", 0)
    bad = {k: v for k, v in count.items() if k != "passed"}
    print(f"phase 15: the card tier, tests/test_torch_cuda_hardware.py: "
          f"{passed} passed, {count.get('failed', 0)} failed, "
          f"{count.get('skipped', 0)} skipped, "
          f"{count.get('error', 0) + count.get('errors', 0)} errors; "
          f"{seconds:.1f} s (host clock, the subprocess's start included) "
          f"[{card}]")
    if res.returncode != 0 or bad or not passed:
        print(res.stdout[-6000:])
        print(res.stderr[-3000:])
    check(res.returncode == 0 and passed and not bad,
          f"the card tier: exit code {res.returncode}, {summary!r}")


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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(event_device_us(e) for e in kernels)
    k1_us = sum(event_device_us(e) for e in kernels
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
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the data of paths (h) to (z)")
    cli = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "nothing was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch import skge
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import ell_spmm as ell
    from randblas_tpu_torch.ops import fused_sketch as fs
    from randblas_tpu_torch.ops import saso_fill, x64_fill
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
                "K5": ell.blocked_ell_matmul, "K6": x64_fill.fill_block64,
                "K7": saso_fill.saso_fill}

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
    # K3's edges: 16-byte stores (cols % 4 == 0 in the natural orientation,
    # rows % 4 == 0 in the transposed one) or 4-byte ones, each shift, the
    # 4 x 256 tile of a block of fewer than 32 rows, row tiles past grid.y
    k3_cases = [
        ("uniform", op((D, M), "Uniform", 1), (1000, 3000, 7, 5)),
        ("gaussian", op((D, M), key=2), (1000, 3000, 7, 5)),
        ("unaligned co_s", op((D, M), key=3), (64, 4001, 0, 3)),
        ("colmajor natural", op((3000, 500), key=4), (2999, 400, 1, 7)),
        ("colmajor, rows and cols odd, shift 2", op((3000, 501), key=10),
         (2998, 397, 2, 3)),
        ("(g)'s colmajor block", op((C4, D4), key=6), (C4, D4, 0, 0)),
        ("fewer than 32 rows", op((8, 5000), key=7), (5, 4999, 3, 1)),
        ("colmajor, fewer than 32 natural rows", op((5000, 8), key=7),
         (4999, 5, 1, 3)),
        ("threefry", op((D, M), "Uniform", 5, "threefry4x32"),
         (100, 999, 3, 2)),
        ("threefry gaussian colmajor", op((3000, 500), key=11,
                                          rng="threefry4x32"),
         (2000, 300, 5, 9)),
        ("offset > 2^32 uniform", op((2 ** 15, 2 ** 20), "Uniform", 6),
         (8, 1000, far_ro, far_co)),
        ("offset > 2^32 gaussian", op((2 ** 15, 2 ** 20), key=6),
         (8, 1000, far_ro, far_co)),
        ("counter wrap uniform", op((D, M), "Uniform", state=wrap),
         (16, 4096, 0, 0)),
        ("counter wrap gaussian", op((D, M), state=wrap), (16, 4096, 0, 0)),
        ("row tiles past grid.y", op((300_000, 8), "Uniform", 8,
                                     major="Short"), (300_000, 8, 0, 0)),
        ("transposed row tiles past grid.y",
         op((4, 2_200_000), "Uniform", 9, major="Short"),
         (4, 2_200_000, 0, 0)),
    ]

    def k3_case(what, S, r, c, ro, co, transform):
        got = fs.fill_block(S, r, c, ro, co, device=dev, transform=transform)
        want = fs.fill_block_reference(S, r, c, ro, co, device=dev,
                                       transform=transform)
        torch.cuda.synchronize()
        what = f"K3 {what} {transform} ({r}x{c} at {ro},{co})"
        check(got.shape == want.shape and got.is_contiguous(),
              f"{what}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        err = (got - want).abs().max().item()
        if S.dist.family == rt.DenseDistName.Uniform or transform == "boxmul":
            check(torch.equal(got, want), f"{what}: not bitwise ({err})")
            print(f"{what}: bitwise equal")
        else:
            check(err <= GAUSS_ABS_TOL, f"{what}: max abs err {err}")
            print(f"{what}: max abs err {err:.3g} <= {GAUSS_ABS_TOL}"
                  f" (bitwise: {torch.equal(got, want)})")
        return got

    # both orientations: a ColMajor-natural block comes out in math
    # orientation (fill_block_T_kernel); its natural block is the block of
    # the transposed operator, which is RowMajor-natural (fill_block_kernel)
    for name, S, (r, c, ro, co) in k3_cases:
        colmajor = rt.dist_to_layout(S.dist) == rt.Layout.ColMajor
        for transform in fs.FILL_TRANSFORMS:
            got = k3_case(name, S, r, c, ro, co, transform)
            if colmajor:
                nat = k3_case(f"{name}, natural orientation", transposed(S),
                              c, r, co, ro, transform)
                check(torch.equal(nat.T, got), f"K3 {name} {transform}: the "
                      "natural block transposed is not the math block")
                print(f"K3 {name} {transform}: the natural block transposed "
                      "is the math block, bit for bit")
            del got

    # -- phase 3b: the lazy fill on the card (K3) against the plain fill --
    fill_cases = k3_cases + [
        ("colmajor wide+Short, unaligned", op((500, 3000), key=12,
                                              major="Short"),
         (497, 2990, 3, 7)),
        ("philox2x32: the plain fill", op((D, 4096), key=13,
                                          rng="philox2x32"),
         (100, 999, 3, 2)),
    ]
    for name, S, (r, c, ro, co) in fill_cases:
        args = (S.dist, S.seed_state, r, c, ro, co)
        kernel = fs.fill_block_supported(S.dist, torch.float32,
                                         S.seed_state.rng)
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            n0 = fs.fill_block.launches
            got = rt.fill_dense_submat(*args, dtype, dev)
            launched = fs.fill_block.launches - n0
            want = rt.dense.fill_dense_submat_reference(*args, dtype, dev)
            torch.cuda.synchronize()
            what = f"fill_dense_submat {name} {str(dtype)[6:]}"
            check(launched == int(kernel), f"{what}: K3 launched {launched}")
            check(got.dtype == dtype and got.is_contiguous()
                  and tuple(got.shape) == (r, c), f"{what}: {got.shape}")
            check(torch.equal(got, want), f"{what}: not bitwise, max abs "
                  f"err {abs_err(got, want)}")
        print(f"fill_dense_submat {name} ({r}x{c} at {ro},{co}): float32, "
              f"float64 and bf16 bitwise equal to the plain fill; K3 "
              f"{'once a call' if kernel else 'not launched'}")

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
              f"{plan.tn}, TK {plan.tk}, PK {plan.pk}, cluster "
              f"{plan.cluster}, grid {plan.grid + (plan.splits,)} "
              f"({plan.splits} splits of {plan.split_steps} steps, "
              f"{plan.panel_steps} panel steps), regeneration factor "
              f"{plan.regen}; cudaOccupancyMaxActiveClusters {active}")
        check(plan.regen <= 2, f"{label}: S generated {plan.regen} times")

    def staged_fill():
        with rt.flags(use_fused=False, use_kernel_fill=True):
            return rt.sketch_general(S, A, side="left")

    def staged():
        with rt.flags(use_fused=False):
            return rt.sketch_general(S, A, side="left")

    # off the main path: the staged route, which fills through K3 with the
    # staged fill's transform, or with the TPU kernel's under
    # use_kernel_fill, through the same entry point
    B_plain_fill, staged_launches = drive("staged route", staged,
                                          {"K1": 0, "K2": 0, "K3": 1})
    B_ref_fill = torch.matmul(
        rt.dense.fill_dense_submat_reference(S.dist, S.seed_state, D, M,
                                             device=dev), A)
    torch.cuda.synchronize()
    staged_err = rel_err(B_plain_fill, B_ref_fill)
    check(staged_err <= F32_REL_TOL, f"staged route: {staged_err}")
    print(f"staged route (K3, the staged fill's transform) vs the product of "
          f"the plain fill: normalised {staged_err:.3g} <= {F32_REL_TOL} "
          f"(bitwise: {torch.equal(B_plain_fill, B_ref_fill)})")
    del B_plain_fill, B_ref_fill
    B_staged, _ = drive(
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
        # forced: at these edge shapes (narrow n, bf16) "auto" takes the
        # staged route (phase 13), and the case holds the kernel
        n_before = counters[kname].launches
        with rt.flags(use_fused=True):
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
        (f"m < PK (m={fs.PK - 32})", A[:fs.PK - 32, :300],
         dict(rows_s=200)),
        (f"m = 7 TK = {7 * fs.TK} (the last panel step half used)",
         A[:7 * fs.TK, :300], dict(rows_s=200)),
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

    # a square dist transposes to itself: its backward pass is staged (the
    # forward forced onto K2: at n = 512 "auto" takes the staged route)
    S_sq = op((2048, 2048), key=9)            # square+Long: ColMajor
    A_sq = A[:2048, :512].clone().requires_grad_(True)
    G_sq = G[:, :512].repeat(2, 1).contiguous()

    def square_backward():
        with rt.flags(use_fused=True):
            rt.sketch_general(S_sq, A_sq).backward(G_sq)
    drive("square dist forward (K2) and staged backward (K3 fill)",
          square_backward, {"K1": 0, "K2": 1, "K3": 1})
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

    # K3 as the staged route runs it: the staged fill's transform at D x M
    k3_plain_ms = time_ms(lambda: fs.fill_block_reference(
        S, D, M, device=dev, transform="boxmul"), reps=3)
    k3_got = fs.fill_block(S, D, M, device=dev, transform="boxmul")
    k3_want = fs.fill_block_reference(S, D, M, device=dev, transform="boxmul")
    k3_err = abs_err(k3_got, k3_want)
    check(torch.equal(k3_got, k3_want), f"K3 main-shape fill: {k3_err}")
    del k3_got, k3_want

    f32 = 4
    k1_bound = bound(flops, (M * N + D * N) * f32)
    k2_bound = bound(flops, (D * N + M * N) * f32)
    k3_bound = bound(0.0, D * M * f32)
    for name, ms, lib, work in (
            ("main path sketch_general (K1 route)", main_ms, k1_lib_ms, 1),
            ("K1 fused_sketch wrapper", k1_ms, k1_lib_ms, 1),
            ("K1 plain (fill + bf16 round + fp32 matmul)", plain_ms, None, 1),
            ("staged route (K3 fill + fp32 matmul)", staged_ms, None, 1),
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
    print(f"time K3's plain version {D}x{M}, boxmul: {k3_plain_ms:.3f} ms "
          f"[{card}]")
    k3_first = k3_times(rt, fs, dev, card, [
        (f"{D}x{M} Gaussian", S, D, M),
        (f"{D}x{M} Uniform", op((D, M), "Uniform", 1), D, M),
        (f"(f)'s {D4}x{R4} Gaussian", op((D4, R4), key=5), D4, R4),
        (f"(g)'s ColMajor {C4}x{D4} Gaussian, math orientation",
         op((C4, D4), key=6), C4, D4)])
    print(f"bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), K3 {k3_bound[0]:.4f} ms "
          f"({k3_bound[1]}), at {PEAK_BF16 / 1e12:.0f} TFLOP/s bf16 and "
          f"{PEAK_BYTES / 1e12:.2f} TB/s")
    profile_main(rt, S, A, card)

    del A, G, A2, S_c
    torch.cuda.empty_cache()
    sparse_kernels, k7 = sparse_paths(rt, dev, drive, card)
    torch.cuda.empty_cache()
    linalg_paths(rt, dev, drive, card, cli.seed)
    torch.cuda.empty_cache()
    k6 = solver_paths(rt, dev, drive, card, cli.seed)
    torch.cuda.empty_cache()
    tier45_paths(rt, dev, drive, card, cli.seed)
    torch.cuda.empty_cache()
    distributed_paths(rt, dev, drive, card, cli.seed)
    torch.cuda.empty_cache()
    gate_paths(rt, dev, drive, card,
               lambda A: lambda: rt.sketch_general(S, A, side="left"))
    torch.cuda.empty_cache()
    application_paths(dev, drive, card, APP_LAUNCHES)
    card_tier(card)
    # launches: K1 on the main path, K2 on its backward pass (a), K3 on the
    # staged route, whose fill the K3 entry's numbers time
    k3_ms, k3_seq_ms, k3_dev_ms = k3_first["boxmul"]
    kernels = [
        entry("K1", "fused_sketch_kernel", "fused_sketch", 127,
              main_launches["K1"], k1_abs, k1_ms, plain_ms, k1_bound,
              k1_lib_ms),
        entry("K2", "fused_sketch_T_kernel", "fused_sketch", 366,
              grad_launches["K2"], k2_abs, k2_ms, k2_plain_ms, k2_bound,
              k2_lib_ms),
        entry("K3", "fill_block_kernel", "fused_sketch", 446,
              staged_launches["K3"], k3_err, k3_ms, k3_plain_ms, k3_bound,
              None, device_ms=k3_dev_ms, seq_ms=k3_seq_ms),
    ] + sparse_kernels + [
        # K6 replaces the JAX package's host fill (no TPU kernel): its
        # launches, time and bound are (m)'s Gaussian fill, its T kernel's
        # (m')'s
        dict(entry("K6", "fill_block64_kernel", "x64_fill", 0,
                   k6.pop("launches"), k6.pop("err"), k6.pop("ms"),
                   k6.pop("plain_ms"), k6.pop("bound"), None, **k6),
             replaces="randblas_tpu/rng/x64.py:248"),
        # K7 replaces no Pallas kernel (the JAX package's fill is jnp under
        # vmap): its launches are (e)'s, its times and bound (e)'s fill's
        k7,
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
