#!/usr/bin/env python3
"""Which part of the fill kernel K3 sets its pace: generation or stores;
and K3's times in another tree of this repository.

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 fill_ablation.py
    python3 fill_ablation.py --tree DIR

Without ``--tree`` it builds copies of ``randblas_tpu_torch/csrc/
fused_sketch.cu`` with one part of K3's natural-orientation kernel
(``fill_block_kernel``) switched off or done another way (the other sources
unchanged, all in ``randblas_tpu_torch/_build/fill_ablation/``), then times
K3 through its wrapper on a 1024 x 65536 block of a wide Gaussian and of a
wide Uniform operator (the main path's operator shape), with the staged
fill's Gaussian transform: the kernel's device time per call from one
torch.profiler window over 20 calls. The variants:

- ``full``: the kernel as it is;
- ``generation_only``: every value is generated and realigned, but no
  store is made (a store guarded by a test that no value passes, so the
  compiler keeps the generation): the card's floor for the generation
  work, the ALU side of K3's bound;
- ``no_generator``: the generator's four words are made from the counter
  offset by three integer operations in place of Philox4x32-10; the
  transform and the stores stay: what the stores cost beside the
  transform;
- ``conversions_by_fma``: each word's conversion to float (``I2F``, on
  the card's conversion pipe) made instead from its two 16-bit halves by
  exact float arithmetic and one fused multiply-add, which rounds once as
  the conversion does;
- ``philox_wide_multiply``: Philox's two multiplies a round written as
  64-bit products, in place of ``__umulhi`` beside the low product.

``generation_only``'s and ``no_generator``'s results are wrong by
construction: only their times are read. The last two compute the same
bits another way, and the script prints whether their blocks equal
``full``'s.

With ``--tree DIR`` it builds nothing of its own: it imports the package
of the repository tree in DIR (for example an earlier commit unpacked with
``git archive``; ``.`` for this one), which builds its kernels as it
always does, and times that tree's K3 as it is, through ``fill_block``
with its default Gaussian transform (the TPU kernel's, which every version
of K3 has), on the same two blocks: the device time as above, and one call
through the wrapper by CUDA events (median of 10). Two trees are compared
by runs of both, one after the other, on one card.

It imports nothing of JAX. The last line is a JSON object of the times.
"""

import argparse
import json
import os
import sys

import torch

from kernel_variants import (bind, build_variants, card_name, device_ms,
                             time_ms)

_BY_FMA = """// exact: both halves are exact floats, the FMA rounds once
__device__ __forceinline__ float i2f_by_fma(int32_t s) {
  const uint32_t hi = (uint32_t)((s >> 16) + 32768), lo = (uint32_t)s & 0xFFFFu;
  return __fmaf_rn(__fsub_rn(__int_as_float(0x4B000000u | hi), 8421376.0f),
                   65536.0f,
                   __fsub_rn(__int_as_float(0x4B000000u | lo), 8388608.0f));
}
__device__ __forceinline__ float u2f_by_fma(uint32_t w) {
  return __fmaf_rn(__fsub_rn(__int_as_float(0x4B000000u | (w >> 16)), 8388608.0f),
                   65536.0f,
                   __fsub_rn(__int_as_float(0x4B000000u | (w & 0xFFFFu)), 8388608.0f));
}
"""
_UNEG11 = "__device__ __forceinline__ float uneg11_i32(int32_t s) {"

VARIANTS = {
    "full": [],
    "generation_only": [
        ("      if (!stores || r >= rows) continue;",
         "      if (!(w[0] == 1234.5f && w[1] == w[3])) continue;")],
    "no_generator": [
        ("  words4<RNG>(seed, off, x);\n  if (GAUSS) {",
         "  x[0] = (uint32_t)off;\n  x[1] = x[0] * 3u;\n  x[2] = x[0] ^ 7u;\n"
         "  x[3] = x[0] + 5u;\n  if (GAUSS) {")],
    "conversions_by_fma": [
        ("__int2float_rn(s)", "i2f_by_fma(s)"),
        ("__uint2float_rn(w)", "u2f_by_fma(w)"),
        (_UNEG11, _BY_FMA + _UNEG11)],
    "philox_wide_multiply": [
        ("    const uint32_t hi0 = __umulhi(0xD2511F53u, x[0]);\n"
         "    const uint32_t lo0 = 0xD2511F53u * x[0];\n"
         "    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x[2]);\n"
         "    const uint32_t lo1 = 0xCD9E8D57u * x[2];",
         "    const uint64_t p0 = (uint64_t)0xD2511F53u * x[0];\n"
         "    const uint64_t p1 = (uint64_t)0xCD9E8D57u * x[2];\n"
         "    const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;\n"
         "    const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;")],
}
EXACT = ("conversions_by_fma", "philox_wide_multiply")
ROWS, COLS = 1024, 65536


def operators(rt):
    return {family: rt.DenseSkOp(
        rt.DenseDist(ROWS, COLS, rt.DenseDistName[family]),
        rt.RNGState.from_key(0)) for family in ("Gaussian", "Uniform")}


def ablation(card):
    """The variants of this tree's K3; {variant: {key: value}}."""
    import randblas_tpu_torch as rt
    from randblas_tpu_torch.ops import _build
    from randblas_tpu_torch.ops import fused_sketch as fs

    libs = build_variants("fused_sketch.cu", VARIANTS,
                          str(_build.BUILD_DIR / "fill_ablation"))
    dev = torch.device("cuda")
    times, blocks = {}, {}
    for name, path in libs.items():
        bind(path)
        times[name] = {}
        same = ""
        for family, S in operators(rt).items():
            def fill():
                return fs.fill_block(S, ROWS, COLS, device=dev,
                                     transform="boxmul")
            times[name][f"{family}_ms"] = device_ms(fill, "fill_block")
            if name == "full":
                blocks[family] = fill()
            elif name in EXACT:
                equal = torch.equal(fill(), blocks[family])
                times[name][f"{family}_bitwise"] = equal
                same += f", {family} bitwise equal to full: {equal}"
        print(f"{name}: K3 {ROWS}x{COLS} device time, Gaussian "
              f"{times[name]['Gaussian_ms']:.4f} ms, Uniform "
              f"{times[name]['Uniform_ms']:.4f} ms{same} [{card}]",
              flush=True)
    return times


def tree_times(tree, card):
    """K3 of the package in ``tree``, as it is; {key: ms}."""
    import randblas_tpu_torch as rt
    from randblas_tpu_torch.ops import fused_sketch as fs
    where = os.path.dirname(os.path.dirname(os.path.abspath(rt.__file__)))
    if where != tree:
        raise RuntimeError(f"fill_ablation: imported the package of {where}, "
                           f"not of {tree}")
    dev = torch.device("cuda")
    times = {}
    for family, S in operators(rt).items():
        def fill():
            return fs.fill_block(S, ROWS, COLS, device=dev)
        times[f"{family}_device_ms"] = device_ms(fill, "fill_block")
        times[f"{family}_one_call_ms"] = time_ms(fill, reps=10)
        print(f"K3 of {tree}, {ROWS}x{COLS} {family}, the wrapper's default "
              f"transform: device {times[f'{family}_device_ms']:.4f} ms, one "
              f"call {times[f'{family}_one_call_ms']:.4f} ms [{card}]",
              flush=True)
    return times


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", help="time K3 of the repository tree in "
                        "this directory, as it is, instead of the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fill_ablation: torch.cuda.is_available() is False")
    tree = os.path.abspath(args.tree or os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    card = card_name()
    print(card)
    times = tree_times(tree, card) if args.tree else ablation(card)
    print(json.dumps({"card": card, "tree": tree, "ms": times}))


if __name__ == "__main__":
    main()
