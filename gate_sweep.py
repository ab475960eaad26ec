#!/usr/bin/env python3
"""Both sides of every "auto" route choice of the PyTorch/CUDA port, timed on
the card (the port's counterpart of ``benchmarks/gate_sweep.py``).

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 gate_sweep.py [--out FILE] [G1 G2 ...]
    python3 gate_sweep.py --compare RUN1.jsonl RUN2.jsonl   # no card needed

Each grid point runs both sides through the production entries, each side
forced by its flag, and is timed by ``randblas_tpu_torch.profiling.time_op``
(CUDA events, one warm-up call, the median of 5); every timed call uses an
operator of its own seed. The grids:

- G1, K1 against the staged route (K3 fill + float32 ``torch.matmul``):
  ``sketch_general`` of a wide Gaussian ``DenseDist(d, m)`` on A (m, n)
  under ``use_fused=True`` / ``False``.
- G2, K2 against staged: a tall ColMajor-natural ``DenseDist(d, m)``.
- G3, the left-Trans and right routes against staged: the operator/data
  size ratio 2 rows cols / A.size from 1/16 to 8 at m = 32768, n = 2048
  (the right route, A (n, m) @ S (m, d), and the left-Trans adjoint
  S^T Y of the same tall S: both K1), and short contractions c in {512,
  1024, 1536} (the left-Trans adjoint of a wide S (c, 32768), through K2;
  the right route A (32768, c) @ S (c, 256), through K1), and path (b)'s
  adjoint as an anchor.
- G4, K4 against the fixed-nnz route: ``sketch_general`` of a filled wide
  SASO ``SparseDist(d, m, k)`` on A (m, n) under ``use_saso_kernel=True`` /
  ``False``; the Fisher-Yates fills are made before the timing.
- G5, K5 against the COO route: ``left_spmm`` of run_all.py config 4b's
  20000 x 10000 COO data (nnz uniform entries; and 1e6 of them plus one
  heavy row that sets the BlockedELL's slot width bw) under
  ``auto_blocked_ell=True`` (the cached conversion: the steady state) /
  ``False``; the conversion's host seconds apart.
- G6, the COO traffic model: ``coo_left_apply`` (gather + ``index_add_``)
  against ``coo_left_apply_dense`` (densify + matmul; panels past
  ``_DENSE_BUDGET``), random (d, m) COO data with nnz entries on B (m, n).
- G7, the SRHT's Hadamard stage cap: ``sketch_general`` of a
  ``TrigSkOp(TrigDist(1024, m))`` on A (m, n) with
  ``ops.hadamard.SRHT_CUDA_MAX_FACTOR`` set to each cap.
- G1N, G2N, G1B, G2B, G3N, G4N, past those grids: K1 and K2 at narrow n
  (1 to 2048 columns, where the launch plan's clusters of fewer than 8
  CTAs leave the contraction uncut), K1 and K2 on bf16 data (whose staged
  route is a bf16 matmul), the right and left-Trans routes at narrow n,
  and K4 on 1 and 4 columns.
- F, the two K3 transforms (``fill_block``, "boxmul" and "boxmul_i32") at
  the staged route's, path (f)'s and path (g)'s blocks.

Every grid point prints one JSON line (``gate``, shape, each side's ms, the
ratio alternative / kernel: above 1 the kernel is faster), also written to
``--out``; then, per gate, the boundary the run shows. A ratio within
1.00 +- 0.05 is a tie, and a tie keeps the kernel. ``--compare`` reads two
runs' files and keeps a decision for the alternative only where both runs
agree on it. Data is made on the card from ``--seed``. It imports nothing of
JAX. The card's name and power limit are the first and the last line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from kernel_variants import card_name

TIE = 0.05        # |ratio - 1| <= TIE is a tie, which keeps the kernel
REPS = 5          # timed calls a side, after one warm-up

G1 = dict(d=(64, 128, 256, 512, 1024, 2048),
          m=(256, 512, 1024, 2048, 4096, 16384, 65536), n=(256, 4096))
G2 = dict(d=(2048, 8192, 65536), m=(128, 256, 512, 1024, 2048, 4096),
          n=(512, 4096))
G3 = dict(m=32768, n=2048, ratios=(1 / 16, 1 / 8, 1 / 4, 1 / 2, 1, 2, 4, 8),
          contractions=(512, 1024, 1536), right_d=256)
G4 = dict(d=(128, 512, 1024, 4096), m=(1024, 4096, 16384, 65536, 262144),
          n=(16, 128, 2048), k=8, k_more=(2, 16), n_more=2048)
G5 = dict(shape=(20000, 10000),
          nnz=(1 << 12, 1 << 15, 1 << 18, 1 << 19, 10 ** 6),
          n=(1, 8, 32, 128, 512, 2048), bw=(16, 32, 64, 136),
          heavy_nnz=10 ** 6)
G6 = dict(d=(64, 512, 4096), m=(4096, 65536), nnz=(1 << 12, 1 << 16, 1 << 20),
          n=(1, 16, 64, 512, 2048))
G7 = dict(caps=(64, 128, 256, 512, 1024, 2048), m=(1 << 12, 1 << 16, 1 << 20),
          n=(64, 4096), d=1024)
# past the grids above: K1 and K2 at narrow n (where clusters of fewer than 8
# CTAs leave the contraction uncut), bf16 data, and K4 on vectors
G1N = dict(d=(64, 512, 2048, 8192, 16384), m=(1024, 8192, 65536),
           n=(1, 16, 64, 256, 512, 1024, 2048))
G2N = dict(d=(2048, 8192, 32768, 65536), m=(256, 1024, 4096),
           n=(1, 16, 64, 256, 512, 1024, 2048))
G3N = dict(n=(1, 64, 256, 1024))
G1B = dict(d=(256, 1024, 4096), m=(4096, 65536), n=(256, 4096))
G2B = dict(d=(8192, 65536), m=(1024, 4096), n=(512, 4096))
G4N = dict(d=(128, 1024, 4096), m=(4096, 65536, 131072, 262144), n=(1, 4),
           k=8, k_more=(), n_more=4)
FILL = dict(blocks=(("staged", 1024, 65536, "Long"), ("(f)", 512, 20000, "Long"),
                    ("(g)", 10000, 512, "Long")))


def ms(call, device):
    """Median ms of ``call(i)`` (i = 0 warms up, then 1..REPS) by
    ``profiling.time_op``."""
    from randblas_tpu_torch.profiling import time_op

    def fn(i, carry, _anchor):
        return call(i)
    anchor = torch.zeros((), device=device)
    return time_op(fn, anchor, flops=0.0, iters_large=REPS).seconds * 1e3


def natural_dist(rt, d, m, layout):
    """A Gaussian DenseDist(d, m) whose natural layout is ``layout``."""
    for major in (rt.MajorAxis.Long, rt.MajorAxis.Short):
        dist = rt.DenseDist(d, m, rt.DenseDistName.Gaussian, major)
        if rt.dist_to_layout(dist) == rt.Layout[layout]:
            return dist
    raise ValueError(f"no {layout} DenseDist({d}, {m})")


def classify(ratio):
    """'kernel', 'alt' or 'tie' for ratio = alt ms / kernel ms."""
    if ratio > 1 + TIE:
        return "kernel"
    if ratio < 1 - TIE:
        return "alt"
    return "tie"


class Sweep:
    def __init__(self, rt, device, seed, out):
        self.rt, self.dev, self.seed, self.out = rt, device, seed, out
        self.records = []

    def emit(self, rec):
        if "kernel_ms" in rec:
            rec["ratio"] = rec["alt_ms"] / rec["kernel_ms"]
            rec["winner"] = classify(rec["ratio"])
        self.records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")
            self.out.flush()

    def randn(self, *shape, seed=0):
        g = torch.Generator(device=self.dev).manual_seed(self.seed * 1000 + seed)
        return torch.randn(*shape, generator=g, device=self.dev)

    def pair(self, kernel, alt, route_k, route_a):
        """(kernel ms, alt ms); each side's route checked once."""
        from randblas_tpu_torch import skge
        out = []
        for call, route in ((kernel, route_k), (alt, route_a)):
            if route is not None:
                skge.route_counts.clear()
                call(0)
                got = dict(skge.route_counts)
                if got != {route: 1}:
                    raise RuntimeError(f"took {got}, expected {route}")
            out.append(ms(call, self.dev))
        return out

    def dense_pair(self, dist, data, route, alt, **kw):
        """(kernel ms, staged ms) of ``sketch_general(S, data, **kw)`` by a
        DenseSkOp(dist) of its own seed a call, under use_fused=True and
        False."""
        rt = self.rt

        def side(fused):
            def call(i):
                S = rt.DenseSkOp(dist, rt.RNGState.from_key(i))
                with rt.flags(use_fused=fused):
                    return rt.sketch_general(S, data, **kw)
            return call
        return self.pair(side(True), side(False), route, alt)

    # -- G1, G2: left K1 / K2 against the staged route ----------------------
    def dense_left(self, gate, grid, layout, route, dtype=torch.float32):
        """A Gaussian DenseDist(d, m) of the natural ``layout`` at each
        point (the major axis chosen to give it), on ``dtype`` data."""
        rt = self.rt
        big = self.randn(max(grid["m"]), max(grid["n"]), seed=1)
        for n in grid["n"]:
            for m in grid["m"]:
                A = big[:m, :n].to(dtype).contiguous()
                for d in grid["d"]:
                    dist = natural_dist(rt, d, m, layout)
                    k, a = self.dense_pair(dist, A, route, "left_staged")
                    self.emit({"gate": gate, "d": d, "m": m, "n": n,
                               "dtype": str(dtype)[6:],
                               "major": dist.major_axis.name,
                               "kernel": route, "alt": "left_staged",
                               "kernel_ms": k, "alt_ms": a})
                del A
        del big

    # -- G3: left-Trans and right routes -----------------------------------
    def trans_right(self):
        rt, g = self.rt, G3
        m, n = g["m"], g["n"]
        Y = self.randn(m, n, seed=2)       # left-Trans data (m, n)
        At = self.randn(n, m, seed=3)      # right data (n, m)

        def both(label, dist, data, route, alt, **kw):
            k, a = self.dense_pair(dist, data, route, alt, **kw)
            rows, cols = dist.n_rows, dist.n_cols
            self.emit({"gate": "G3", "case": label, "rows": rows,
                       "cols": cols, "data": list(data.shape),
                       "size_ratio": 2 * rows * cols / data.numel(),
                       "kernel": route, "alt": alt, "kernel_ms": k,
                       "alt_ms": a})

        for r in g["ratios"]:
            d = int(round(r * n / 2))
            tall = rt.DenseDist(m, d)
            both("right", tall, At, "right_fused", "right_staged",
                 side="right")
            both("left_trans", tall, Y, "left_trans_fused", "left_staged",
                 op_s="T")
        for c in g["contractions"]:
            wide = rt.DenseDist(c, m)
            both("left_trans_short", wide, Y[:c].contiguous(),
                 "left_trans_fused", "left_staged", op_s="T")
            both("right_short", rt.DenseDist(c, g["right_d"]),
                 Y[:, :c].contiguous(), "right_fused", "right_staged",
                 side="right")
        del Y, At
        # path (b)'s adjoint: S (1024, 65536), Y (1024, 4096)
        Yb = self.randn(1024, 4096, seed=4)
        both("left_trans_b", rt.DenseDist(1024, 65536), Yb,
             "left_trans_fused", "left_staged", op_s="T")
        del Yb

    def trans_right_narrow(self):
        """G3N: the right route on A (n, m) and the left-Trans adjoint on
        Y (m, n), both by a tall DenseDist(m, 1024), at narrow n."""
        rt, m, d = self.rt, G3["m"], 1024
        tall = rt.DenseDist(m, d)
        big = self.randn(m, max(G3N["n"]), seed=9)
        for n in G3N["n"]:
            Y = big[:, :n].contiguous()
            At = Y.T.contiguous()
            for label, data, route, alt, kw in (
                    ("right", At, "right_fused", "right_staged",
                     dict(side="right")),
                    ("left_trans", Y, "left_trans_fused", "left_staged",
                     dict(op_s="T"))):
                k, a = self.dense_pair(tall, data, route, alt, **kw)
                self.emit({"gate": "G3N", "case": label, "rows": m,
                           "cols": d, "n": n, "kernel": route, "alt": alt,
                           "kernel_ms": k, "alt_ms": a})
        del big

    # -- G4: K4 against the fixed-nnz route ---------------------------------
    def saso(self, gate="G4", g=G4):
        rt = self.rt
        big = self.randn(max(g["m"]), max(max(g["n"]), g["n_more"]), seed=5)
        points = [(d, m, n, g["k"]) for n in g["n"] for m in g["m"]
                  for d in g["d"]]
        points += [(d, m, g["n_more"], k) for k in g["k_more"]
                   for m in g["m"] for d in g["d"]]
        last = None
        for d, m, n, k in points:
            if d >= m:      # a wide SASO only
                continue
            if (m, n) != last:
                A = big[:m, :n].contiguous()
                last = (m, n)
            dist = rt.SparseDist(d, m, k, rt.MajorAxis.Short)
            ops = [rt.SparseSkOp(dist, rt.RNGState.from_key(i)).filled(self.dev)
                   for i in range(REPS + 1)]

            def side(flag):
                def call(i):
                    with rt.flags(use_saso_kernel=flag):
                        return rt.sketch_general(ops[i], A)
                return call
            kms, ams = self.pair(side(True), side(False),
                                 "sparse_saso_kernel", "sparse_fixed_nnz")
            self.emit({"gate": gate, "d": d, "m": m, "n": n, "k": k,
                       "kernel": "sparse_saso_kernel",
                       "alt": "sparse_fixed_nnz", "kernel_ms": kms,
                       "alt_ms": ams})
            del ops
        del big

    # -- G5: K5 against the COO route ----------------------------------------
    def coo_data(self, rows_n, cols_n, nnz, seed, heavy_bw=0):
        """config 4b's COO data: nnz uniform entries, and with heavy_bw a
        heavy row 0 holding heavy_bw - 8 entries in each 128-column block
        (a full row at heavy_bw 136)."""
        rng = np.random.default_rng(self.seed * 1000 + seed)
        r = rng.integers(0, rows_n, nnz)
        c = rng.integers(0, cols_n, nnz)
        if heavy_bw:
            per = heavy_bw - 8
            hc = np.concatenate([np.arange(b, min(b + per, cols_n))
                                 for b in range(0, cols_n, 128)])
            r = np.concatenate([r, np.zeros_like(hc)])
            c = np.concatenate([c, hc])
        v = rng.standard_normal(len(r)).astype(np.float32)
        return self.rt.COOMatrix.from_arrays(rows_n, cols_n, r, c, v,
                                             device=self.dev)

    def ell(self):
        rt, g = self.rt, G5
        from randblas_tpu_torch.ops import ell_spmm
        from randblas_tpu_torch.ops.ell_spmm import BlockedELL
        from randblas_tpu_torch.sparse_data import ell as ell_mod
        from randblas_tpu_torch.sparse_data import left_spmm
        rows_n, cols_n = g["shape"]
        Bbig = self.randn(cols_n, max(g["n"]), seed=6)
        mats = [(nnz, 0) for nnz in g["nnz"]] + \
            [(g["heavy_nnz"], bw) for bw in g["bw"]]
        for j, (nnz, heavy) in enumerate(mats):
            A = self.coo_data(rows_n, cols_n, nnz, 10 + j, heavy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bell = BlockedELL.from_ell(ell_mod.ELLMatrix.from_coo(A),
                                       device=self.dev)
            torch.cuda.synchronize()
            conv_s = time.perf_counter() - t0
            table_bytes = (bell.local_cols.numel() * 4
                           + bell.vals.numel() * 4)
            object.__setattr__(A, "_bell_cache", bell)
            self.emit({"gate": "G5conv", "nnz": A.nnz, "heavy_bw": heavy,
                       "bw": bell.bw, "convert_s": conv_s,
                       "table_gib": table_bytes / 2 ** 30})
            for n in g["n"]:
                B = Bbig[:, :n].contiguous()

                def side(flag):
                    def call(i):
                        with rt.flags(auto_blocked_ell=flag):
                            return left_spmm(A, B)
                    return call
                k5 = ell_spmm.blocked_ell_matmul
                launched = []
                for flag in (True, False):
                    n0 = k5.launches
                    side(flag)(0)
                    launched.append(k5.launches - n0)
                if launched != [1, 0]:
                    raise RuntimeError(f"K5 launches {launched}")
                kms, ams = self.pair(side(True), side(False), None, None)
                self.emit({"gate": "G5", "nnz": A.nnz, "bw": bell.bw,
                           "n": n, "kernel": "blocked_ell",
                           "alt": "coo_left_apply_auto", "kernel_ms": kms,
                           "alt_ms": ams})
            del A, bell
            torch.cuda.empty_cache()

    # -- G6: the COO traffic model ------------------------------------------
    def coo_model(self):
        from randblas_tpu_torch.ops import coo_apply as ca
        g = G6
        Bbig = self.randn(max(g["m"]), max(g["n"]), seed=7)
        for d in g["d"]:
            for m in g["m"]:
                for nnz in g["nnz"]:
                    gen = torch.Generator(device=self.dev).manual_seed(
                        self.seed * 1000 + d + m + nnz)
                    r = torch.randint(0, d, (nnz,), generator=gen,
                                      device=self.dev, dtype=torch.int32)
                    c = torch.randint(0, m, (nnz,), generator=gen,
                                      device=self.dev, dtype=torch.int32)
                    v = torch.randn(nnz, generator=gen, device=self.dev)
                    dense = (ca.coo_left_apply_dense if d * m <= ca._DENSE_BUDGET
                             else ca.coo_left_apply_panels)
                    for n in g["n"]:
                        B = Bbig[:m, :n].contiguous()
                        k = ms(lambda i: ca.coo_left_apply(r, c, v, B, d, m),
                               self.dev)
                        a = ms(lambda i: dense(r, c, v, B, d, m), self.dev)
                        self.emit({"gate": "G6", "d": d, "m": m, "nnz": nnz,
                                   "n": n, "traffic": nnz * n / (d * m),
                                   "kernel": "index_add",
                                   "alt": dense.__name__, "kernel_ms": k,
                                   "alt_ms": a})

    # -- G7: the Hadamard stage cap -------------------------------------------
    def hadamard(self):
        rt, g = self.rt, G7
        from randblas_tpu_torch.ops import hadamard as had
        total = torch.cuda.get_device_properties(self.dev).total_memory
        saved = had.SRHT_CUDA_MAX_FACTOR
        for m in g["m"]:
            for n in g["n"]:
                # the data, its signed copy and three transform buffers
                if 5 * m * n * 4 > 0.8 * total:
                    self.emit({"gate": "G7", "m": m, "n": n, "skipped":
                               f"needs about {5 * m * n * 4 / 2**30:.0f} GiB"})
                    continue
                A = self.randn(m, n, seed=8)
                ops = [rt.TrigSkOp(rt.TrigDist(g["d"], m),
                                   rt.RNGState.from_key(i))
                       for i in range(REPS + 1)]
                for S in ops:
                    S._sample(self.dev)
                times = {}
                try:
                    for cap in g["caps"]:
                        had.SRHT_CUDA_MAX_FACTOR = cap
                        times[cap] = ms(
                            lambda i: rt.sketch_general(ops[i], A), self.dev)
                finally:
                    had.SRHT_CUDA_MAX_FACTOR = saved
                best = min(times, key=times.get)
                self.emit({"gate": "G7", "m": m, "n": n, "d": g["d"],
                           "ms": {str(c): t for c, t in times.items()},
                           "best": best})
                del A, ops
                torch.cuda.empty_cache()

    # -- F: the two K3 transforms ---------------------------------------------
    def fill(self):
        rt = self.rt
        from randblas_tpu_torch.ops import fused_sketch as fs
        for label, r, c, major in FILL["blocks"]:
            dist = rt.DenseDist(r, c, rt.DenseDistName.Gaussian,
                                rt.MajorAxis[major])
            times = {}
            for t in fs.FILL_TRANSFORMS:
                times[t] = ms(lambda i: fs.fill_block(
                    rt.DenseSkOp(dist, rt.RNGState.from_key(i)), r, c,
                    device=self.dev, transform=t), self.dev)
            self.emit({"gate": "F", "block": label, "rows": r, "cols": c,
                       "ms": times})


# -- what a run shows ---------------------------------------------------------

def _key(rec):
    return tuple((k, json.dumps(rec[k])) for k in sorted(rec) if k not in (
        "kernel_ms", "alt_ms", "ratio", "winner", "ms", "best", "convert_s",
        "table_gib"))


def _min_from(points):
    """The smallest x from which no point (x, cls) at x or above is 'alt'
    (None if the largest x is 'alt')."""
    points = sorted(points)
    lo = None
    for x, cls in reversed(points):
        if cls == "alt":
            break
        lo = x
    return lo


def boundaries(records):
    """Per gate, the boundary the records' winners show (a record's winner
    is 'alt' only where the alternative won)."""
    out = []
    by = {}
    for r in records:
        by.setdefault(r["gate"], []).append(r)
    for gate, axis, keys in (("G1", "m", ("d", "n")), ("G2", "m", ("d", "n")),
                             ("G1N", "m", ("d", "n")),
                             ("G2N", "m", ("d", "n")),
                             ("G1B", "m", ("d", "n")),
                             ("G2B", "m", ("d", "n")),
                             ("G4", "m", ("d", "n", "k")),
                             ("G4N", "m", ("d", "n", "k")),
                             ("G5", "n", ("nnz", "bw"))):
        groups = {}
        for r in by.get(gate, []):
            groups.setdefault(tuple(r[k] for k in keys), []).append(
                (r[axis], r["winner"]))
        for key, pts in sorted(groups.items()):
            alt = sorted(x for x, c in pts if c == "alt")
            out.append({"boundary": gate, **dict(zip(keys, key)),
                        f"kernel_from_{axis}": _min_from(pts),
                        f"alt_at_{axis}": alt})
    for r in by.get("G3", []) + by.get("G3N", []):
        out.append({"boundary": r["gate"], **{k: r[k] for k in (
            "case", "rows", "cols", "size_ratio", "n") if k in r},
            "winner": r["winner"]})
    g6 = by.get("G6", [])
    if g6:
        xs = sorted((r["traffic"], r["winner"]) for r in g6)
        best = None
        for t in sorted({0.0} | {x for x, _ in xs}):
            # index_add (the "kernel" side) where traffic <= t
            wrong = sum((x <= t and c == "alt") or (x > t and c == "kernel")
                        for x, c in xs)
            if best is None or wrong < best[1]:
                best = (t, wrong)
        out.append({"boundary": "G6", "index_add_while_traffic_le": best[0],
                    "misclassified": best[1], "points": len(xs),
                    "dense_wins": [[r["d"], r["m"], r["nnz"], r["n"]]
                                   for r in g6 if r["winner"] == "alt"]})
    for r in by.get("G7", []):
        if "best" in r:
            t = {int(c): v for c, v in r["ms"].items()}
            near = sorted(c for c, v in t.items() if v <= t[r["best"]] * 1.05)
            out.append({"boundary": "G7", "m": r["m"], "n": r["n"],
                        "best": r["best"], "within_5pct": near,
                        **({"best_of_each_run": r["best_of_each_run"]}
                           if "best_of_each_run" in r else {})})
    return out


def compare(path1, path2):
    """Merge two runs: a point's winner is 'alt' only where both runs say
    so; then the boundaries of the merged records."""
    runs = []
    for p in (path1, path2):
        with open(p) as f:
            runs.append({_key(r): r for r in map(json.loads, f)
                         if "gate" in r})
    merged, disagree = [], []
    for key, r1 in runs[0].items():
        r2 = runs[1].get(key)
        if r2 is None:
            continue
        r = dict(r1)
        if "winner" in r1:
            r["ratio"] = [r1["ratio"], r2["ratio"]]
            both = {r1["winner"], r2["winner"]}
            r["winner"] = "alt" if both == {"alt"} else (
                "kernel" if "alt" not in both else "split")
            if len(both) > 1:
                disagree.append({"gate": r["gate"], "point": {
                    k: json.loads(v) for k, v in key}, "ratios": r["ratio"]})
        if "best" in r1:
            # each cap at the slower of its two runs
            r["ms"] = {c: max(r1["ms"][c], r2["ms"][c]) for c in r1["ms"]}
            r["best"] = int(min(r["ms"], key=r["ms"].get))
            r["best_of_each_run"] = [r1["best"], r2["best"]]
        merged.append(r)
    for d in disagree:
        print(json.dumps({"disagree": d}))
    for b in boundaries(merged):
        print(json.dumps(b))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("gates", nargs="*", help="G1 .. G7, F (default: all)")
    p.add_argument("--out", help="also write the JSON lines here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare", nargs=2, metavar="RUN",
                   help="merge two runs' files; needs no card")
    cli = p.parse_args()
    if cli.compare:
        compare(*cli.compare)
        return
    if not torch.cuda.is_available():
        sys.exit("gate_sweep: torch.cuda.is_available() is False; nothing "
                 "was run")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch.ops import _build
    card = card_name()
    print(card, flush=True)
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = open(cli.out, "w") if cli.out else None
    sw = Sweep(rt, torch.device("cuda"), cli.seed, out)
    plan = {
        "G1": lambda: sw.dense_left("G1", G1, "RowMajor", "left_fused"),
        "G2": lambda: sw.dense_left("G2", G2, "ColMajor",
                                    "left_colmajor_fused"),
        "G1N": lambda: sw.dense_left("G1N", G1N, "RowMajor", "left_fused"),
        "G2N": lambda: sw.dense_left("G2N", G2N, "ColMajor",
                                     "left_colmajor_fused"),
        "G1B": lambda: sw.dense_left("G1B", G1B, "RowMajor", "left_fused",
                                     torch.bfloat16),
        "G2B": lambda: sw.dense_left("G2B", G2B, "ColMajor",
                                     "left_colmajor_fused", torch.bfloat16),
        "G3": sw.trans_right, "G3N": sw.trans_right_narrow, "G4": sw.saso,
        "G4N": lambda: sw.saso("G4N", G4N), "G5": sw.ell,
        "G6": sw.coo_model, "G7": sw.hadamard, "F": sw.fill}
    failed = []
    for gate in cli.gates or list(plan):
        t0 = time.perf_counter()
        try:
            plan[gate]()
        except Exception as e:     # the other gates still run
            failed.append(gate)
            print(json.dumps({"gate_failed": gate, "error": repr(e)}),
                  flush=True)
        torch.cuda.empty_cache()
        print(json.dumps({"gate_done": gate,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for b in boundaries(sw.records):
        print(json.dumps(b))
        if out:
            out.write(json.dumps(b) + "\n")
    if out:
        out.close()
    print(card)
    if failed:
        sys.exit(f"gate_sweep: {failed} failed")


if __name__ == "__main__":
    main()
