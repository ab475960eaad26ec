#!/usr/bin/env python3
"""Which part of the x64 fill kernel K6 sets its pace, what its SASS asks
of each pipe of the card, and K6's times in another tree of this
repository.

Run from the repository root on a machine with one NVIDIA H100 and the CUDA
toolkit:

    python3 x64_ablation.py
    python3 x64_ablation.py --tree DIR

Without ``--tree`` it builds copies of ``randblas_tpu_torch/csrc/
x64_fill.cu`` with one part of K6 switched off or done another way (the
other sources unchanged, all in ``randblas_tpu_torch/_build/
x64_ablation/``), then times K6 through its wrapper on the blocks that the
x64 sketches run: a 1024 x 65536 block of a Philox4x64 operator, Gaussian
and Uniform (``fill_block64_kernel``), and the 65536 x 1024 block of a
ColMajor-natural Threefry2x64 Gaussian operator (``fill_block64_T_
kernel``). A time is ``kernel_variants.launch_ms``: CUDA events around 20
launches back to back, queued while the card sleeps (so the window holds
no host work), per launch, the median of 5 such windows. The variants:

- ``full``: the kernel as it is;
- ``generation_only``: every value is made, but no store: the stores are
  guarded by a test that no value passes, so the compiler keeps the work;
- ``no_transform``: the generator's words are stored as their bits, with
  no Box-Muller and no scaling: the generator and the stores;
- ``no_generator``: the words are made from the counter offset by a few
  integer operations in place of the generator; the transform and the
  stores stay;
- the exact variants, whose blocks must equal ``full``'s bit for bit (the
  script checks it): one lever of the kernel taken back, ``sin_and_cos``
  (``sin`` and ``cos`` called apart, not one ``sincos``) and
  ``T_one_block`` (one counter block a thread in the T kernel, not two),
  or a change measured and not kept, ``four_rows`` (four rows a thread in
  the natural kernel, not two), ``threads_128`` (128-thread CTAs),
  ``product_helper`` (Philox's 128-bit product from four explicit 32 x 32
  -> 64-bit products, not ``__umul64hi`` beside the low product) and
  ``staged_stores`` (four-word rows through shared memory, so that each
  16-byte store of a warp writes 512 contiguous bytes).

A variant's result is wrong by construction where it switches work off:
only its time is read. Each substitution is checked to match the source.

The SASS census (``cuobjdump -sass`` of each built library, where the
toolkit has it; ``kernel_variants.k6_census``): for each instantiation of
K6, the instructions of its main loop (the span of its outermost backward
branch, runtime loops inside it, which only the slow paths of the math
library run, left out) by pipe class, per value made. With NVIDIA's
published throughputs for compute capability 9.0 (CUDA C++ Programming
Guide, "Arithmetic Instructions": per clock and SM, 64 FP64 operations,
64 32-bit integer multiply-adds, 64 32-bit integer adds, logic operations
and shifts, 16 conversions from and to 64-bit types, 16 special
functions) over 132 SMs at the card's maximum SM clock, each arithmetic
pipe's count gives the least time for a block: the operations bound is
the largest, K6's bound the larger of that and the bytes bound (the block
written once at 3.35 TB/s). Moves (MOV, IMAD.MOV), the uniform datapath,
memory and branch instructions count in no pipe. The time to issue every
instruction (four warp instructions a clock and SM) is printed beside it
as a diagnostic of the SASS, not as a bound: it counts what the compiler
chose, moves and control flow included, not what the function needs.

With ``--tree DIR`` it imports the package of the repository tree in DIR
(for example an earlier commit unpacked with ``git archive``; ``.`` for
this one), which builds its kernels as it always does, and times that
tree's K6 as it is on the same three blocks, with its census. Two trees
are compared by runs of both, in turns, in one call on one card.
``--sass DIR`` writes the SASS of K6 (``full``'s, or the tree's) to DIR.

It imports nothing of JAX. The last line is a JSON object of the times and
the census.
"""

import argparse
import json
import os
import sys

import torch

from kernel_variants import (GEN_NAMES, K6_KERNEL, bind, build_variants,
                             card_name, issue_ms, k6_census,
                             k6_values_per_iter, launch_ms, max_sm_clock,
                             operations_bound, operations_ms,
                             sass_of)

# -- the variants -----------------------------------------------------------
# A variant is a list of (old, new) text substitutions in x64_fill.cu.

_VALUES = "// the W values of the counter block at seed.c + off"
_NEVER = """// true for no block (the ablation's guard on the stores)
template <int R, int W>
__device__ __forceinline__ bool never64(const double (&v)[R][W]) {
  bool hit = true;
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int l = 0; l < W; ++l) hit &= v[k][l] == 1234.5;
  return hit;
}

""" + _VALUES
_BITS = ("    for (int i = 0; i < W; ++i) v[i] = __longlong_as_double("
         "(long long)x[i]);")
_ROWS_LOOP = ("      values64<GEN, GAUSS>(seed, off + (uint64_t)k * ctr_stride, "
              "v[k]);\n")
_T_LOOP = "          + (uint64_t)(b0 + i / 2 * X64_TY), v[i]);\n"

ABLATIONS = {
    "full": [],
    "generation_only": [
        (_VALUES, _NEVER),
        (_ROWS_LOOP, _ROWS_LOOP
         + "    if (!never64<X64_ROWS, W>(v)) continue;\n"),
        (_T_LOOP, _T_LOOP + "    if (!never64<2 * X64_T_BLOCKS, W>(v)) "
         "continue;\n")],
    "no_transform": [
        ("    for (int i = 0; i < W; i += 2) boxmul64(x[i], x[i + 1], v[i], "
         "v[i + 1]);", _BITS),
        ("    for (int i = 0; i < W; ++i) v[i] = __dmul_rn(uneg11_64(x[i]), "
         "kSqrt3_64);", _BITS)],
    "no_generator": [
        ("  block64<GEN>(c, s, x);",
         "#pragma unroll\n  for (int i = 0; i < W; ++i)\n"
         "    x[i] = (c[0] ^ s.k[0]) + (uint64_t)i * 0x9E3779B97F4A7C15ull;")],
}

_SIN_COS = "  x = __dmul_rn(sin(ang), r);\n  y = __dmul_rn(cos(ang), r);"
_SINCOS = ("  double s, c;\n  sincos(ang, &s, &c);\n  x = __dmul_rn(s, r);\n"
           "  y = __dmul_rn(c, r);")
_MULHILO = """// the 128-bit product m * x from four 32 x 32 -> 64-bit products
__device__ __forceinline__ uint64_t mulhilo64(uint64_t m, uint64_t x,
                                              uint64_t& hi) {
  const uint32_t m0 = (uint32_t)m, m1 = (uint32_t)(m >> 32);
  const uint32_t x0 = (uint32_t)x, x1 = (uint32_t)(x >> 32);
  const uint64_t p00 = (uint64_t)x0 * m0;
  const uint64_t p01 = (uint64_t)x0 * m1 + (p00 >> 32);
  const uint64_t p10 = (uint64_t)x1 * m0 + (uint32_t)p01;
  hi = (uint64_t)x1 * m1 + (p01 >> 32) + (p10 >> 32);
  return (p10 << 32) | (uint32_t)p00;
}

template <int GEN>
__device__ __forceinline__ void block64("""
_PRODUCT = [
    ("template <int GEN>\n__device__ __forceinline__ void block64(",
     _MULHILO),
    ("      const uint64_t hi = __umul64hi(kPhilox2M, x0);\n"
     "      const uint64_t lo = kPhilox2M * x0;",
     "      uint64_t hi;\n"
     "      const uint64_t lo = mulhilo64(kPhilox2M, x0, hi);"),
    ("      const uint64_t hi0 = __umul64hi(kPhilox4M0, x0);\n"
     "      const uint64_t lo0 = kPhilox4M0 * x0;\n"
     "      const uint64_t hi1 = __umul64hi(kPhilox4M1, x2);\n"
     "      const uint64_t lo1 = kPhilox4M1 * x2;",
     "      uint64_t hi0, hi1;\n"
     "      const uint64_t lo0 = mulhilo64(kPhilox4M0, x0, hi0);\n"
     "      const uint64_t lo1 = mulhilo64(kPhilox4M1, x2, hi1);")]

# four-word rows through shared memory, so that each 16-byte store of a
# warp writes 512 contiguous bytes (not every other 16 bytes of 1 KB)
_STAGED = [
    ("  if (c0 >= cols) return;\n  for (int64_t r0 = X64_ROWS",
     "  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;\n"
     "  const int64_t cw = c0 - lane * W;  // the warp's first column\n"
     "  if (cw >= cols) return;\n  for (int64_t r0 = X64_ROWS"),
    ("      if (vec) {  // c even, cols even: a pair is all in or all out\n",
     """      if (vec && W == 4) {
        __shared__ double2 stage[X64_THREADS / 32][2 * 32];
        stage[warp][2 * lane] = make_double2(v[k][0], v[k][1]);
        stage[warp][2 * lane + 1] = make_double2(v[k][W - 2], v[k][W - 1]);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int64_t c = cw + 2 * (32 * j + lane);
          if (c >= 0 && c < cols) {
            *reinterpret_cast<double2*>(o + c) = stage[warp][32 * j + lane];
          }
        }
        __syncwarp();
      } else if (vec) {
""")]


def _constant(name, old, new):
    return [(f"constexpr int {name} = {old};",
             f"constexpr int {name} = {new};")]


# exact variants: one part of the design taken back, or a geometry or
# rewrite that measured slower
LEVERS = {
    "sin_and_cos": [(_SINCOS, _SIN_COS)],
    "staged_stores": _STAGED,
    "T_one_block": _constant("X64_T_BLOCKS", 2, 1),
    "four_rows": _constant("X64_ROWS", 2, 4),
    "threads_128": _constant("X64_THREADS", 256, 128),
    "product_helper": _PRODUCT,
}
VARIANTS = {**ABLATIONS, **LEVERS}


def exact(name):
    return name not in ABLATIONS


# -- the census --------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12


def save_sass(sass, path):
    """Write the K6 functions of ``sass`` to ``path``: their instructions
    and labels, without the encodings."""
    with open(path, "w") as f:
        for block in sass.split("Function : ")[1:]:
            if "fill_block64" in block.split("\n", 1)[0]:
                lines = [ln.split(" /* 0x")[0].rstrip()
                         for ln in block.splitlines()
                         if ln.strip() and not ln.strip().startswith("/* 0x")]
                f.write("Function : " + "\n".join(lines) + "\n")


def ptxas_lines(log):
    """ptxas' register and spill lines of K6's instantiations."""
    if not log:
        return []
    keep, lines = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "fill_block64" in line
            if keep:
                m = K6_KERNEL.search(line)
                lines.append(f"{m.group(1)}<{GEN_NAMES[int(m.group(2))]}, "
                             f"{'Gaussian' if m.group(3) == '1' else 'Uniform'}>"
                             if m else line.strip())
        elif keep and ("registers" in line or "spill" in line
                       or "stack frame" in line):
            lines[-1] += " | " + line.split(":", 1)[-1].strip()
    return lines


# -- the blocks and their times ---------------------------------------------

ROWS, COLS = 1024, 65536
BLOCKS = (("philox4x64_gaussian", "fill_block64_kernel", "philox4x64",
           True),
          ("philox4x64_uniform", "fill_block64_kernel", "philox4x64",
           False),
          ("threefry2x64_T_gaussian", "fill_block64_T_kernel",
           "threefry2x64", True))


def fills(rt, dev):
    """{block: a call of K6's wrapper making it}."""
    from randblas_tpu_torch.ops import x64_fill
    out = {}
    for name, kernel, rng, gauss in BLOCKS:
        fam = rt.DenseDistName["Gaussian" if gauss else "Uniform"]
        if kernel == "fill_block64_T_kernel":  # ColMajor-natural
            S = rt.DenseSkOp(rt.DenseDist(COLS, ROWS, fam),
                             rt.RNGState.from_key(22, rng))
            shape = (COLS, ROWS)
        else:
            S = rt.DenseSkOp(rt.DenseDist(ROWS, COLS, fam),
                             rt.RNGState.from_key(21, rng))
            shape = (ROWS, COLS)
        out[name] = (lambda S=S, shape=shape:
                     x64_fill.fill_block64(S, *shape, device=dev))
    return out


def report_census(label, census, sm_hz, every=True):
    """Print the census of each block's instantiation with its bounds (and
    of ``every`` instantiation); {block: {...}}."""
    out = {}
    for name, kernel, rng, gauss in BLOCKS:
        c = census.get((kernel, rng, gauss))
        if c is None:
            continue
        values = ROWS * COLS
        pipes = operations_ms(c["per_value"], values, sm_hz)
        op_ms, pipe = operations_bound(c["per_value"], values, sm_hz)
        issue = issue_ms(c["per_value"], values, sm_hz)
        bytes_ms = values * 8 / HBM_BYTES_PER_S * 1e3
        per = ", ".join(f"{k} {v:.2f}" for k, v in c["per_value"].items())
        print(f"census {label} {name} ({kernel}): {c['instructions']} "
              f"instructions in the loop ({c['static']} in the function), "
              f"{c['values_per_iteration']} values an iteration; per value: "
              f"{per}; all {c['issue_per_value']:.2f}. Pipes at "
              f"{sm_hz / 1e6:.0f} MHz: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in pipes.items())
              + f" ms; operations {op_ms:.4f} ms ({pipe}), bytes "
              f"{bytes_ms:.4f} ms, bound {max(op_ms, bytes_ms):.4f} ms; "
              f"issuing every instruction {issue:.4f} ms (not a bound)",
              flush=True)
        out[name] = dict(c, pipes_ms=pipes, operations_ms=op_ms,
                         operations_by=pipe, bytes_ms=bytes_ms,
                         bound_ms=max(op_ms, bytes_ms), issue_ms=issue)
    if every:
        for (kernel, rng, gauss), c in sorted(census.items()):
            per = ", ".join(f"{k} {v:.2f}" for k, v in
                            c["per_value"].items())
            print(f"census {label} {kernel}<{rng}, "
                  f"{'Gaussian' if gauss else 'Uniform'}>: per value "
                  f"{per}; all {c['issue_per_value']:.2f}", flush=True)
    return out


def package_of(tree):
    """The package ``randblas_tpu_torch`` of the tree in ``tree``."""
    import randblas_tpu_torch as rt
    where = os.path.dirname(os.path.dirname(os.path.abspath(rt.__file__)))
    if where != tree:
        raise RuntimeError(f"x64_ablation: imported the package of {where}, "
                           f"not of {tree}")
    return rt


def ablation(card, tree, sm_hz, sass_dir=None):
    """The variants of the K6 in ``tree``; {variant: {...}}."""
    rt = package_of(tree)
    from randblas_tpu_torch.ops import _build
    text = (_build._PKG / "csrc" / "x64_fill.cu").read_text()
    logs = {}
    libs = build_variants("x64_fill.cu", VARIANTS,
                          str(_build.BUILD_DIR / "x64_ablation"), logs)
    per_iter = k6_values_per_iter(text)
    calls = fills(rt, torch.device("cuda"))
    results, blocks = {}, {}
    for name, path in libs.items():
        bind(path)
        res = {"ms": {}, "ptxas": ptxas_lines(logs.get(name))}
        for line in res["ptxas"]:
            print(f"ptxas {name}: {line}")
        for block, fn in calls.items():
            res["ms"][block] = launch_ms(fn)
            if name == "full":
                blocks[block] = fn()
            elif exact(name):
                same = torch.equal(fn(), blocks[block])
                res.setdefault("bitwise", {})[block] = same
                if not same:
                    raise SystemExit(f"x64_ablation: {name} changes the "
                                     f"{block} block")
        print(f"{name}: K6 " + ", ".join(
            f"{b} {t:.4f} ms" for b, t in res["ms"].items())
            + (", bitwise equal to full" if exact(name) else "")
            + f" [{card}]", flush=True)
        sass = sass_of(path)
        if sass is not None and sass_dir and name == "full":
            save_sass(sass, os.path.join(sass_dir, f"{name}.sass"))
        if sass is not None:
            res["census"] = report_census(
                name, k6_census(sass, per_iter), sm_hz,
                every=name == "full")
        results[name] = res
    return {"variants": results}


def tree_times(tree, card, sm_hz, sass_dir=None):
    """K6 of the package in ``tree``, as it is: times and census."""
    rt = package_of(tree)
    from randblas_tpu_torch.ops import _build
    calls = fills(rt, torch.device("cuda"))
    _build.load()
    times = {b: launch_ms(fn) for b, fn in calls.items()}
    print(f"K6 of {tree}: " + ", ".join(f"{b} {t:.4f} ms"
                                        for b, t in times.items())
          + f" [{card}]", flush=True)
    res = {"ms": times, "ptxas": ptxas_lines(_build.build_log)}
    for line in res["ptxas"]:
        print(f"ptxas {tree}: {line}")
    sass = sass_of(_build.LIBRARY)
    if sass is not None and sass_dir:
        save_sass(sass, os.path.join(sass_dir, os.path.basename(tree)
                                     + ".sass"))
    if sass is not None:
        text = (_build._PKG / "csrc" / "x64_fill.cu").read_text()
        res["census"] = report_census(
            tree, k6_census(sass, k6_values_per_iter(text)), sm_hz)
    return res


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", help="time K6 of the repository tree in "
                        "this directory, as it is, instead of the variants")
    parser.add_argument("--sass", metavar="DIR", help="write the SASS of "
                        "each K6 built to DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("x64_ablation: torch.cuda.is_available() is False")
    tree = os.path.abspath(args.tree or os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, tree)
    card = card_name()
    sm_hz = max_sm_clock()
    print(f"{card}; bounds at the maximum SM clock, {sm_hz / 1e6:.0f} MHz")
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
    if args.tree:
        res = tree_times(tree, card, sm_hz, args.sass)
    else:
        res = ablation(card, tree, sm_hz, args.sass)
    print(json.dumps({"card": card, "tree": tree,
                      "sm_clock_mhz": sm_hz / 1e6, "result": res},
                     default=str))


if __name__ == "__main__":
    main()
