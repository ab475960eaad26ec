#!/usr/bin/env python3
"""Which part of the SASO sketch kernel K4 sets its pace.

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 saso_ablation.py

It builds copies of ``randblas_tpu_torch/csrc/saso_sketch.cu`` with one
part of the kernel's work switched off (the other sources unchanged, all in
``randblas_tpu_torch/_build/saso_ablation/``), then times K4 through its
wrapper at benchmarks/run_all.py config 3 (a SASO SparseDist(1024, 65536,
vec_nnz=8) on A (65536, 2048) float32) through each build, with the launch
plan the card gets: median of 5 by CUDA events after one warm-up. The
variants:

- ``full``: the kernel as it is;
- ``no_panel``: the producers clear and set no panel entry (the tables'
  slices are still copied);
- ``no_conversion``: the consumers leave the data tile as it is (A still
  arrives by TMA);
- ``no_products``: the consumers run no wgmma;
- ``handoffs_and_tma``: none of the three: the loads of A by TMA, the
  tables' copies and the barriers of the rings.

A variant's results are wrong by construction; only its time is read. The
time a part adds is the full time minus the variant's. Each variant is one
text substitution, checked to match the source, so the script fails rather
than time a variant that no longer switches anything off. It imports
nothing of JAX. The last line is a JSON object of the times.
"""

import json
import os
import sys

import numpy as np
import torch

from kernel_variants import bind, build_variants, card_name, time_ms

NO_PANEL = [
    ("const int o = sl < k && was ? offset(old[sl * TPITCH + col]) : -1;",
     "const int o = -1;"),
    ("const int o = sl < k && is ? offset(now[sl * TPITCH + col]) : -1;",
     "const int o = -1;"),
]
NO_CONVERSION = [
    ("        for (int it = 0; it < kFours / 128; ++it) {\n"
     "          const int t = wg * kFours + lt + it * 128;\n"
     "          const int kk = t / (TN / 4)",
     "        for (int it = 0; it < 0; ++it) {\n"
     "          const int t = wg * kFours + lt + it * 128;\n"
     "          const int kk = t / (TN / 4)"),
]
NO_PRODUCTS = [
    ("          wgmma_m64n128k16<1>(acc[0], da0 + 2 * kk, db + 128 * kk);", ""),
    ("          wgmma_m64n128k16<1>(acc[1], da1 + 2 * kk, db + 128 * kk);", ""),
    ("          wgmma_m64n128k16<0>(acc[0], da0 + 2 * kk, db + 2 * kk);", ""),
    ("          wgmma_m64n128k16<0>(acc[1], da1 + 2 * kk, db + 2 * kk);", ""),
]
VARIANTS = {
    "full": [],
    "no_panel": NO_PANEL,
    "no_conversion": NO_CONVERSION,
    "no_products": NO_PRODUCTS,
    "handoffs_and_tma": NO_PANEL + NO_CONVERSION + NO_PRODUCTS,
}
D3, M3, N3, K3_NNZ = 1024, 65536, 2048, 8   # run_all.py config 3


def main():
    if not torch.cuda.is_available():
        sys.exit("saso_ablation: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import randblas_tpu_torch as rt
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import saso_sketch as saso

    card = card_name()
    print(card)
    libs = build_variants("saso_sketch.cu", VARIANTS,
                          str(_build.BUILD_DIR / "saso_ablation"))
    dev = torch.device("cuda")
    A = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (M3, N3), dtype=np.float32)).to(dev)
    s = rt.SparseSkOp(rt.SparseDist(D3, M3, vec_nnz=K3_NNZ),
                      rt.RNGState.from_key(3)).filled(dev)
    idx, sgn = s.rows.reshape(M3, K3_NNZ), s.vals.reshape(M3, K3_NNZ)
    times = {}
    for name, path in libs.items():
        bind(path)
        times[name] = time_ms(lambda: saso.saso_sketch(idx, sgn, A, D3))
        print(f"{name}: K4 {times[name]:.3f} ms [{card}]", flush=True)
    print(f"plan: {saso.launch_plan(D3, M3, N3, saso.max_active_ctas(dev))}")
    print(json.dumps({"card": card, "ms": times}))


if __name__ == "__main__":
    main()
