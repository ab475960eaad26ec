#!/usr/bin/env python3
"""The distributed layer of the PyTorch/CUDA port (randblas_tpu_torch.parallel)
over real NCCL ranks, one per GPU, at full width.

Run from the repository root on a machine with two or more NVIDIA H100s:

    python3 dist_smoke.py [--trace-dir DIR]

It builds the kernels once, then starts one process per visible GPU with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT on a localhost port); each joins the NCCL group
through ``initialize_multihost()`` and, on every ('model', 'data') mesh of
the world (1 x W, W x 1 and, for W = 4, 2 x 2, and the host-contiguous
``make_multihost_sketch_mesh(model=2)``), runs the paths of
``chip_smoke.py``'s phase 11 through the public entry points with DTensor
inputs, numbered as the JAX package's dryrun_multichip:

- (M1) ``distributed_sketch`` at the main shape (1024 x 65536 . 65536 x
  4096), and its backward pass; (M2) ``distributed_sketch_right`` at
  run_all.py config 2; (M3) ``distributed_sparse_sketch`` at config 3;
  (M4) ``distributed_sketch_cols`` at the main shape (K1 a rank where
  ``skge.fused_profitable`` takes the rank's tile, else staged); (M5)
  ``distributed_sketch_sparse_data`` at config 4; (M6) pad-and-shard at
  d = 1000, m = 65000, n = 4093; (M7) the SRHT over columns;
- (M8) ``distributed_rsvd`` and (M9) ``distributed_krylov_rangefinder`` of
  a planted 32768 x 4096 matrix at rank 256, (M13) ``distributed_fd`` of
  65536 x 1024 at ell = 256, (M14) ``ihs_lsq(mesh=)`` at 131072 x 2048;
- chip_smoke.py's phase 12, the solver tier and the tensor sketches on
  sharded inputs: (M10) ``sgmres`` on a row-sharded 8192 x 8192 A (basis
  80), (M11) ``block_kaczmarz`` on a row-sharded 65536 x 1024 system and
  (M12) ``block_gauss_seidel`` ('shuffle' and 'colnorm') on a
  column-sharded one (block 512, 48 steps), (M15) ``tensor_sketch`` and
  (M16) ``kfjlt_sketch`` of two column-sharded 65536 x 64 factors to
  d = 1024. These shard over 'data' only: on a mesh whose 'data' axis has
  one rank each rank holds all of A, and the script says so and skips them.

(M1)'s backward pass also runs inside ``profiling.trace`` on rank 0: the
Chrome trace goes to ``--trace-dir`` (a temporary directory by default),
and the script prints the device time a call of the NCCL all-reduce
kernels beside that of K1, K2 and the rest (an all-reduce's time includes
its wait for the slowest rank).

Each path on each rank: the kernels it launched there (K1 to K5, counted
by their wrappers, set to 0 just before), its result against the
single-device call on the same data on the rank's own card (the bound of
chip_smoke.py's phase 11), and its CUDA-event time (median of 5; FD one
run) beside the single-device call's. Every rank checks; rank 0 prints.
The last line is {"ok": true, ...} when every rank passed. It imports
nothing of JAX.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

D, M, N = 1024, 65536, 4096          # the main path's shape
R2, C2, D2 = 16384, 16384, 1024      # run_all.py config 2
D3, M3, N3, K3_NNZ = 1024, 65536, 2048, 8   # run_all.py config 3
R4, C4, D4, NNZ4 = 20000, 10000, 512, 1_000_000   # run_all.py config 4
PAD = (1000, 65000, 4093)
RSVD = (32768, 4096, 256)            # (m, n, rank), planted
FD = (65536, 1024, 256)              # (m, n, ell)
IHS = (131072, 2048, 4096)           # (m, n, d)
SGMRES = (8192, 80)                  # (n, basis): chip_smoke.py's (t)
KACZ = (65536, 1024, 512, 48)        # (m, n, block, steps): its (y)
TS = (65536, 64, 1024)               # (m, n, d) of two factors: its (l)
SOLVER_TOL = 1e-4    # the solvers' x vs the unsharded run's, normalised
TS_TOL = 1e-6        # a tensor sketch of a rank's columns vs the full call:
                     # the same per-column arithmetic, but the FFTs and the
                     # Hadamard GEMMs are planned for another batch width
K1_REL_TOL = 1e-3    # bf16-operand kernels, sums in another order
STAGED_REL_TOL = 2e-2  # the float32 staged route vs K1's bf16 operands
K4_REL_TOL = 1e-5    # K4 against K4 on the same bf16-rounded data
F32_REL_TOL = 1e-4   # float32 sums of 20000 terms in another order
SRHT_REL_TOL = 2e-5
RSVD_TOL = 1e-4      # top-256 singular values, max abs err / s_1
IHS_TOL = 1e-4       # the mesh's x vs the unsharded run's
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"dist_smoke: {msg}")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def planted(gen, dev, m, n, rank):
    """(A, s): U diag(s) V^T with planted singular values (1 -> 0.1 over the
    top ``rank``, then 3e-3 -> 3e-5), as chip_smoke.py's ``planted``."""
    U = torch.linalg.qr(torch.randn(m, n, generator=gen, device=dev)).Q
    V = torch.linalg.qr(torch.randn(n, n, generator=gen, device=dev)).Q
    i = torch.arange(n, device=dev, dtype=torch.float64)
    sig = torch.where(i < rank, 10 ** (-i / rank),
                      3e-3 * 10 ** (-2 * (i - rank) / (n - rank))).float()
    return (U * sig) @ V.T, sig


def meshes(par, world):
    """(label, mesh) of the world's ('model', 'data') meshes."""
    shapes = [(1, world), (world, 1)] + ([(2, 2)] if world == 4 else [])
    out = [(f"{a}x{b}", par.make_sketch_mesh(a, b, device_type=DEVICE))
           for a, b in shapes]
    if world % 2 == 0:
        out.append(("multihost model=2", par.make_multihost_sketch_mesh(
            model=2, device_type=DEVICE)))
    return out


def rank_main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from kernel_variants import card_name, event_device_us, time_ms
    import randblas_tpu_torch as rt
    from randblas_tpu_torch import linalg as la
    from randblas_tpu_torch import parallel as par
    from randblas_tpu_torch import profiling, skge
    from randblas_tpu_torch.parallel import distributed as pd
    from randblas_tpu_torch.ops import ell_spmm, fused_sketch, saso_sketch

    par.initialize_multihost()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if DEVICE == "cuda" else torch.device(DEVICE))
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    counters = {"K1": fused_sketch.fused_sketch,
                "K2": fused_sketch.fused_sketch_colmajor,
                "K3": fused_sketch.fill_block, "K4": saso_sketch.saso_sketch,
                "K5": ell_spmm.blocked_ell_matmul}

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def same(x):
        """x as rank 0 made it (the data, broadcast)."""
        dist.broadcast(x, 0)
        return x

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return same(torch.randn(*shape, generator=gen, device=dev))

    def path(name, fn, expect, want=None, tol=None, reference=None, reps=5):
        """Run ``fn`` with the counts at 0, check its launches on this rank
        and its (full) result against ``want`` (if given), and time it
        beside ``reference``."""
        for c in counters.values():
            c.launches = 0
        dist.barrier()
        out = fn()
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        want_counts = {k: expect.get(k, 0) for k in counters}
        check(got == want_counts, f"rank {rank} {name}: launches {got}, "
              f"expected {want_counts}")
        err = None
        if want is not None:
            full = out.full_tensor() if isinstance(out, DTensor) else out
            err = rel_err(full, want)
            check(full.shape == want.shape and err <= tol,
                  f"rank {rank} {name}: {tuple(full.shape)}, normalised "
                  f"{err}")
        dist.barrier()
        ms = time_ms(fn, reps=reps)
        one = None if reference is None else time_ms(reference, reps=reps)
        txt = "" if err is None else f", normalised {err:.3g} <= {tol}"
        say(f"{name}: launches on rank 0 {got}{txt}; {ms:.3f} ms"
            + ("" if one is None else f", single-device {one:.3f} ms")
            + f" [{card}]")

    def traced_backward(label, grad, calls=3):
        """(M1)'s forward + backward in a profiling.trace window on rank 0
        (the others run the same calls untraced): device ms a call of the
        NCCL kernels (the all-reduces over 'data' and 'model'), of K1 and
        K2, and of the rest, against the window's wall ms a call."""
        grad()
        torch.cuda.synchronize()
        dist.barrier()
        trace_dir = (os.path.join(os.environ["DIST_SMOKE_TRACE_DIR"],
                                  label.replace(" ", "_").replace("=", ""))
                     if rank == 0 else None)
        t0 = time.perf_counter()
        with profiling.trace(trace_dir) as prof:
            for _ in range(calls):
                grad()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
        if prof is None:
            return
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        parts = {"NCCL": 0.0, "K1 and K2": 0.0, "other": 0.0}
        for e in kernels:
            key = ("NCCL" if "nccl" in e.key.lower() else "K1 and K2"
                   if "fused_sketch" in e.key else "other")
            parts[key] += event_device_us(e) / 1e3 / calls
        say(f"(M1) {label} forward + backward, rank 0's trace: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
            + f" device time a call; {wall:.3f} ms wall a call with the "
            f"profiler on; trace in {trace_dir} [{card}]")

    say(f"dist_smoke: {world} NCCL ranks, backend "
        f"{dist.get_backend()}, torch {torch.__version__} [{card}]")
    rows = [Replicate(), Shard(0)]
    cols = [Replicate(), Shard(1)]

    S = rt.DenseSkOp(rt.DenseDist(D, M), rt.RNGState.from_key(41))
    A = randn(M, N)
    B1 = rt.sketch_general(S, A)
    S2 = rt.DenseSkOp(rt.DenseDist(C2, D2, rt.DenseDistName.Uniform),
                      rt.RNGState.from_key(42))
    A2 = randn(R2, C2)
    B2 = rt.sketch_general(S2, A2, side="right")
    S3 = rt.SparseSkOp(rt.SparseDist(D3, M3, vec_nnz=K3_NNZ),
                       rt.RNGState.from_key(43)).filled(dev)
    A3 = randn(M3, N3)
    B3 = rt.sketch_general(S3, A3)
    rng = np.random.default_rng(44)
    coo = rt.COOMatrix.from_arrays(
        R4, C4, rng.integers(0, R4, NNZ4), rng.integers(0, C4, NNZ4),
        rng.normal(size=NNZ4).astype(np.float32), device=dev)
    S5 = rt.DenseSkOp(rt.DenseDist(D4, R4), rt.RNGState.from_key(45))
    B5 = rt.sketch_sparse(S5, coo)
    S6 = rt.DenseSkOp(rt.DenseDist(*PAD[:2]), rt.RNGState.from_key(46))
    A6 = randn(PAD[1], PAD[2])
    B6 = rt.sketch_general(S6, A6)
    S7 = rt.TrigSkOp(rt.TrigDist(D, M), rt.RNGState.from_key(47))
    B7 = rt.sketch_general(S7, A)
    G = randn(D, N)
    a1 = A.clone().requires_grad_(True)
    rt.sketch_general(S, a1).backward(G)
    g1 = a1.grad
    del a1

    for label, mesh in meshes(par, world):
        model, data = mesh.size(0), mesh.size(1)
        say(f"-- mesh {label}: ({model}, {data}), ranks "
            f"{mesh.mesh.tolist()}")
        A_dt = distribute_tensor(A, mesh, rows)
        path(f"(M1) {label} distributed_sketch",
             lambda: par.distributed_sketch(S, A_dt, mesh), {"K1": 1}, B1,
             K1_REL_TOL, lambda: rt.sketch_general(S, A))
        leaf = distribute_tensor(A, mesh, rows).requires_grad_(True)

        def grad():
            leaf.grad = None
            (par.distributed_sketch(S, leaf, mesh) * distribute_tensor(
                G, mesh, [Shard(0), Replicate()])).sum().backward()
            return leaf.grad

        path(f"(M1) {label} forward + backward", grad, {"K1": 1, "K2": 1},
             g1, K1_REL_TOL, reps=3)
        traced_backward(label, grad)
        del leaf
        A2_dt = distribute_tensor(A2, mesh, cols)
        path(f"(M2) {label} distributed_sketch_right",
             lambda: par.distributed_sketch_right(S2, A2_dt, mesh),
             {"K1": 1}, B2, K1_REL_TOL,
             lambda: rt.sketch_general(S2, A2, side="right"))
        A3_dt = distribute_tensor(A3, mesh, rows)
        path(f"(M3) {label} distributed_sparse_sketch",
             lambda: par.distributed_sparse_sketch(S3, A3_dt, mesh),
             {"K4": 1}, B3, K4_REL_TOL, lambda: rt.sketch_general(S3, A3))
        A4_dt = distribute_tensor(A, mesh, cols)
        # a rank's (D / model) x M tile on N / data columns: K1 where the
        # gate takes it (not at 1 x 4's 1024 columns, a cluster of 4)
        d4, n4 = pd.cols_extents(S, N, (model, data))
        k1 = skge.fused_profitable(d4, M, n4, torch.float32)
        path(f"(M4) {label} distributed_sketch_cols",
             lambda: par.distributed_sketch_cols(S, A4_dt, mesh),
             {"K1": 1} if k1 else {"K3": 1}, B1,
             K1_REL_TOL if k1 else STAGED_REL_TOL)
        path(f"(M5) {label} distributed_sketch_sparse_data",
             lambda: par.distributed_sketch_sparse_data(S5, coo, mesh),
             {"K3": 1}, B5, F32_REL_TOL, lambda: rt.sketch_sparse(S5, coo))
        path(f"(M6) {label} pad-and-shard, plain A",
             lambda: par.distributed_sketch(S6, A6, mesh), {"K1": 1}, B6,
             K1_REL_TOL, lambda: rt.sketch_general(S6, A6))
        path(f"(M7) {label} SRHT, distributed_sketch_cols",
             lambda: par.distributed_sketch_cols(S7, A4_dt, mesh), {}, B7,
             SRHT_REL_TOL, lambda: rt.sketch_general(S7, A))
        del A_dt, A2_dt, A3_dt, A4_dt

    del A, A2, A3, A6, coo, B1, B2, B3, B5, B6, B7, G, g1
    torch.cuda.empty_cache()
    m8, n8, rank8 = RSVD
    A8, sig = planted(gen, dev, m8, n8, rank8)
    A8 = same(A8)
    sig = same(sig)
    m13, n13, ell = FD
    A13 = randn(m13, n13)
    g13 = A13.double().T @ A13.double()
    m14, n14, d14 = IHS
    A14 = same(randn(m14, n14) * torch.logspace(0, -3, n14, device=dev))
    b14 = same(A14 @ randn(n14) + 1e-3 * randn(m14))
    st = rt.RNGState.from_key(48)
    x_ref, _ = la.ihs_lsq(A14, b14, st, d=d14, operator="gaussian")
    for label, mesh in meshes(par, world):
        if mesh.size(1) == 1:
            continue      # the linalg tier shards rows over 'data' only
        A8_dt = distribute_tensor(A8, mesh, rows)
        path(f"(M8) {label} distributed_rsvd", lambda: la.distributed_rsvd(
            A8_dt, rank8, st, mesh)[1], {"K3": 1}, sig[:rank8], RSVD_TOL,
            lambda: la.rsvd(A8, rank8, st))
        q9 = la.distributed_krylov_rangefinder(A8_dt, rank8, st,
                                               mesh).full_tensor()
        tail = (sig[rank8:].double() ** 2).sum().sqrt().item()
        res9 = (A8 - q9 @ (q9.T @ A8)).double().norm().item()
        check(res9 <= 1.05 * tail, f"rank {rank} (M9) {label}: {res9}")
        path(f"(M9) {label} distributed_krylov_rangefinder",
             lambda: la.distributed_krylov_rangefinder(A8_dt, rank8, st,
                                                       mesh), {"K3": 1},
             reference=lambda: la.krylov_rangefinder(A8, rank8, st))
        say(f"(M9) {label}: basis width {q9.shape[1]}, ||A - QQ^T A||_F "
            f"{res9:.5g} <= 1.05 x the rank-{rank8} tail {tail:.5g}")
        del A8_dt, q9
        A13_dt = distribute_tensor(A13, mesh, rows)
        dist.barrier()
        t0 = time.perf_counter()
        fd = la.distributed_fd(A13_dt, ell, mesh)
        torch.cuda.synchronize()
        fd_ms = (time.perf_counter() - t0) * 1e3
        b13 = fd.sketch().double()
        err13 = torch.linalg.matrix_norm(g13 - b13.T @ b13, 2).item()
        mass = float(fd.shrink_mass)
        check(err13 <= mass * 1.01 + 1e-3 * torch.linalg.matrix_norm(
            g13, 2).item(), f"rank {rank} (M13) {label}: {err13} > {mass}")
        say(f"(M13) {label} distributed_fd: ||A^T A - B^T B||_2 "
            f"{err13:.6g} <= the certificate {mass:.6g}; {fd_ms:.1f} ms, "
            f"one run [{card}]")
        del A13_dt, fd
        A14_dt = distribute_tensor(A14, mesh, rows)
        b14_dt = distribute_tensor(b14, mesh, rows)
        path(f"(M14) {label} ihs_lsq(mesh=)", lambda: la.ihs_lsq(
            A14_dt, b14_dt, st, d=d14, operator="gaussian", mesh=mesh)[0],
            {"K1": 1}, x_ref, IHS_TOL,
            lambda: la.ihs_lsq(A14, b14, st, d=d14, operator="gaussian"))
        del A14_dt, b14_dt

    del A8, A13, g13, A14, b14
    torch.cuda.empty_cache()
    n10, basis = SGMRES
    A10 = same(randn(n10, n10) / n10 ** 0.5
               + 4 * torch.eye(n10, device=dev))
    b10 = randn(n10)
    st10 = rt.RNGState.from_key(61)
    x10 = la.sgmres(A10, b10, st10, basis=basis)[0]
    m11, n11, blk, steps = KACZ
    A11 = randn(m11, n11)
    b11 = same(A11 @ randn(n11))
    st11 = rt.RNGState.from_key(62)
    x11 = la.block_kaczmarz(A11, b11, st11, block=blk, steps=steps)[0]
    x12 = {s_: la.block_gauss_seidel(A11, b11, st11, block=blk, steps=steps,
                                     sampling=s_)[0]
           for s_ in ("shuffle", "colnorm")}
    m15, n15, d15 = TS
    F = [randn(m15, n15), randn(m15, n15)]
    st15 = rt.RNGState.from_key(63)
    ts = rt.tensor_sketch(F, d15, st15)[0]
    kf = rt.kfjlt_sketch(F, d15, st15)[0]
    for label, mesh in meshes(par, world):
        if mesh.size(1) == 1:
            say(f"(M10)-(M16) {label}: not sharded on this layout ('data' "
                "has one rank, so each rank would hold all of A); skipped")
            continue
        A10_dt = distribute_tensor(A10, mesh, rows)
        path(f"(M10) {label} sgmres, row-sharded A",
             lambda: la.sgmres(A10_dt, b10, st10, basis=basis)[0],
             {"K4": 3}, x10, SOLVER_TOL,
             lambda: la.sgmres(A10, b10, st10, basis=basis))
        A11_rows = distribute_tensor(A11, mesh, rows)
        b11_rows = distribute_tensor(b11, mesh, rows)
        path(f"(M11) {label} block_kaczmarz, row-sharded A and b",
             lambda: la.block_kaczmarz(A11_rows, b11_rows, st11, block=blk,
                                       steps=steps)[0], {}, x11, SOLVER_TOL,
             lambda: la.block_kaczmarz(A11, b11, st11, block=blk,
                                       steps=steps))
        del A11_rows, b11_rows
        A11_cols = distribute_tensor(A11, mesh, cols)
        for s_, expect in (("shuffle", {"K3": 1}), ("colnorm", {})):
            path(f"(M12) {label} block_gauss_seidel '{s_}', column-sharded "
                 "A", lambda: la.block_gauss_seidel(
                     A11_cols, b11, st11, block=blk, steps=steps,
                     sampling=s_)[0], expect, x12[s_], SOLVER_TOL,
                 lambda: la.block_gauss_seidel(A11, b11, st11, block=blk,
                                               steps=steps, sampling=s_))
        del A10_dt, A11_cols
        F_cols = [distribute_tensor(f, mesh, cols) for f in F]
        path(f"(M15) {label} tensor_sketch, column-sharded factors",
             lambda: rt.tensor_sketch(F_cols, d15, st15)[0], {"K4": 2}, ts,
             TS_TOL, lambda: rt.tensor_sketch(F, d15, st15))
        path(f"(M16) {label} kfjlt_sketch, column-sharded factors",
             lambda: rt.kfjlt_sketch(F_cols, d15, st15)[0], {}, kf, TS_TOL,
             lambda: rt.kfjlt_sketch(F, d15, st15))
        del F_cols

    dist.barrier()
    dist.destroy_process_group()


def main():
    import argparse
    import tempfile
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trace-dir", default=None,
                        help="where rank 0 writes the Chrome traces of "
                        "(M1)'s backward pass (default: a new temporary "
                        "directory)")
    cli = parser.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.exit("dist_smoke: needs two or more CUDA devices; nothing was "
                 "run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from randblas_tpu_torch.ops import _build
    _build.load()                    # once, before the ranks share it
    world = torch.cuda.device_count()
    trace_dir = os.path.abspath(cli.trace_dir or tempfile.mkdtemp(
        prefix="dist_smoke_traces"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        # two "hosts" of world / 2 ranks, for the multi-host mesh
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   DIST_SMOKE_TRACE_DIR=trace_dir,
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world // 2),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, __file__, "--rank"],
                                      env=env))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=800))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    check(codes == [0] * world, f"rank exit codes {codes}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": world}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--rank"]:
        rank_main()
    else:
        main()
