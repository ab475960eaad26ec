#!/usr/bin/env python3
"""Which part of the fused sketch kernels K1 and K2 sets their pace.

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 fused_ablation.py

It builds copies of ``randblas_tpu_torch/csrc/fused_sketch.cu`` with one
part of the kernels' work switched off (the other sources unchanged, all in
``randblas_tpu_torch/_build/ablation/``), then times K1 at the main path's
shape (1024 x 65536 @ 65536 x 4096, float32) and K2 at the backward pass's
(65536 x 1024 @ 1024 x 4096) through each build, with the launch plan the
card gets: device time a launch, by CUDA events around 20 launches queued
while the card sleeps, the median of 5 windows after a warm-up (one call's
time would hold the wrapper's host work, and varies by tenths of a
millisecond from run to run). The variants:

- ``full``: the kernels as they are;
- ``no_generation``: the producers store zeros instead of generating S;
- ``no_conversion``: the consumers leave the data tile as it is (A still
  arrives by TMA);
- ``no_products``: the consumers issue no wgmma;
- ``barriers_and_tma``: none of the three, only the loads of A, the panel's
  bulk copies and the barriers of both rings;
- ``barriers_only``: not even the loads of A: the panel's bulk copies and
  the barriers of the rings (the ring alone);
- ``barriers_only_4_stages``: the same on a panel ring of four stages
  (which fits in shared memory only without A's staging slots): whether
  the ring's depth or the work of each step sets the barriers' time;
- ``panel_step_64`` and ``barriers_only_panel_step_64``: the full kernels
  and the ring alone with the panel ring stepping 64 of the contraction
  (one handoff per step of A) instead of 128: what the longer panel step
  gives.

A variant's results are wrong by construction; only its time is read. The
time a part adds is the full time minus the variant's. Each variant is one
text substitution, checked to match the source, so the script fails rather
than time a variant that no longer switches anything off. Last, the full
kernels are timed once more with the plan held to clusters of 8 (the plan
told that clusters of 16 do not run), against the plan's own choice. It
imports nothing of JAX. The last line is a JSON object of the times.
"""

import json
import os
import sys

import numpy as np
import torch

from kernel_variants import bind, build_variants, card_name, launch_ms

NO_GENERATION = [
    ("if (gi < d && gc < m) {", "if (gi < d && gc < 0) {"),
    ("if (gc < m && rr + 3 >= 0 && rr < d) {", "if (gc < 0) {"),
]
NO_CONVERSION = [
    ("          for (int it = 0; it < kFours / 128; ++it) {\n"
     "            const int t = lt + it * 128;\n"
     "            const int k = t / (TN / 4)",
     "          for (int it = 0; it < 0; ++it) {\n"
     "            const int t = lt + it * 128;\n"
     "            const int k = t / (TN / 4)"),
]
NO_PRODUCTS = [
    ("          wgmma_m64n256k16<1>(acc, da + 2 * kk, db + 128 * kk);", ""),
    ("          wgmma_m64n256k16<0>(acc, da + 2 * kk, db + 2 * kk);", ""),
]
NO_LOADS = [  # A taken as unloadable by TMA, and its element loads skipped
    ("  const int amode = a_map<TA, TN, TK>(a, sk, sn, m, n, &map);",
     "  const int amode = kLoadDirect;"),
    ("        for (int it = 0; it < kEights / 128; ++it) {",
     "        for (int it = 0; it < 0; ++it) {"),
]
PANEL_STEP_64 = [  # the plan's words still say 128, which the check takes
    ("constexpr int PK = 2 * TK;", "constexpr int PK = TK;"),
    ("p.pk == PK", "p.pk == 2 * PK"),
]
RING_ALONE = NO_GENERATION + NO_CONVERSION + NO_PRODUCTS + NO_LOADS
VARIANTS = {
    "full": [],
    "no_generation": NO_GENERATION,
    "no_conversion": NO_CONVERSION,
    "no_products": NO_PRODUCTS,
    "barriers_and_tma": NO_GENERATION + NO_CONVERSION + NO_PRODUCTS,
    "barriers_only": RING_ALONE,
    "barriers_only_4_stages": (
        RING_ALONE
        + [("constexpr int PANEL_STAGES = 2;",
            "constexpr int PANEL_STAGES = 4;"),
           ("constexpr int STAGING_BYTES = TK * TN * 4;",
            "constexpr int STAGING_BYTES = 0;")]),
    "panel_step_64": PANEL_STEP_64,
    "barriers_only_panel_step_64": RING_ALONE + PANEL_STEP_64,
}


def main():
    if not torch.cuda.is_available():
        sys.exit("fused_ablation: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import fused_sketch as fs

    card = card_name()
    print(card)
    libs = build_variants("fused_sketch.cu", VARIANTS,
                          str(_build.BUILD_DIR / "ablation"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((65536, 4096),
                                             dtype=np.float32)).to(dev)
    G = torch.from_numpy(rng.standard_normal((1024, 4096),
                                             dtype=np.float32)).to(dev)
    S = rt.DenseSkOp(rt.DenseDist(1024, 65536), rt.RNGState.from_key(0))
    S_t = rt.DenseSkOp(rt.DenseDist(65536, 1024), rt.RNGState.from_key(0))
    times = {}

    def record(name):
        times[name] = {
            "K1_main_ms": launch_ms(lambda: fs.fused_sketch(S, A)),
            "K2_backward_ms": launch_ms(
                lambda: fs.fused_sketch_colmajor(S_t, G))}
        print(f"{name}: K1 {times[name]['K1_main_ms']:.3f} ms, K2 "
              f"{times[name]['K2_backward_ms']:.3f} ms [{card}]", flush=True)

    for name, path in libs.items():
        bind(path)
        record(name)
    bind(libs["full"])
    counts = dict(fs.max_active_clusters(dev))
    fs.max_active_clusters = lambda device: {**counts, 16: 0}
    for label, shape in (("K1", (1024, 65536, 4096)),
                         ("K2", (65536, 1024, 4096))):
        print(f"{label} plan in clusters of 8: "
              f"{fs.launch_plan(*shape, 0, {**counts, 16: 0})}; the card's "
              f"choice: {fs.launch_plan(*shape, 0, counts)}")
    record("full_clusters_of_8")
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
