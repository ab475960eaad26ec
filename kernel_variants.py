"""What chip_smoke.py and the ablation scripts (fused_ablation.py,
saso_ablation.py, fill_ablation.py, x64_ablation.py) share: the card's
name and maximum SM clock, times by CUDA events and by torch.profiler
device time, copies of a kernel source built with text substitutions and
bound in place of the package's library, and the SASS census of the x64
fill kernel K6 with the operations bound it gives.

It imports torch and nothing of JAX. The package it builds and binds is the
``randblas_tpu_torch`` that ``sys.path`` finds.
"""

import ctypes
import os
import re
import statistics
import subprocess

import torch


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def max_sm_clock():
    """The card's maximum SM clock in Hz, as nvidia-smi gives it: the
    clock at which an operations bound is least."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0])


def time_ms(fn, reps=5, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


# cycles the card sleeps before each window of launch_ms, while the host
# queues its launches (about 50 ms): the window times the card, not the
# wrapper's host work, which for K6 is about as long as a launch
SLEEP_CYCLES = 100_000_000


def launch_ms(fn, launches=20, windows=5):
    """Device milliseconds a launch of ``fn``: CUDA events around
    ``launches`` calls back to back, queued while the card sleeps, the
    median of ``windows`` windows, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return sorted(times)[windows // 2]


def event_device_us(e):
    """A profiler event's own device microseconds (the attribute's name
    changed across PyTorch versions)."""
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


def device_ms(fn, name, calls=20):
    """Device milliseconds a launch of the kernels whose name holds
    ``name`` (a call of ``fn`` launching one), from one torch.profiler
    window over ``calls`` calls of ``fn`` after one more: the mean over the
    launches the trace recorded, since late in a long process it may drop
    some (None if it recorded none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.key]
    us = sum(event_device_us(e) for e in found)
    return us / sum(e.count for e in found) / 1e3 if us else None


def build_variants(source, variants, root, logs=None):
    """One library per entry of ``variants`` ({name: [(old, new), ...]}):
    ``csrc/<source>`` of the package with each text substitution made (each
    checked to match, so a variant that no longer changes anything fails
    the build), linked with the package's other sources unchanged (each
    compiled once), all compiled in parallel into ``root``. Returns {name:
    library path}; ``logs``, a dict, receives each variant's nvcc output
    (ptxas registers and spills per kernel)."""
    from randblas_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    text0 = (_build._PKG / "csrc" / source).read_text()
    os.makedirs(root, exist_ok=True)
    objs = {}
    for name, subs in variants.items():
        text = text0
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        src = os.path.join(root, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        objs[name] = (src, os.path.join(root, f"{name}.o"))
    others = [(str(s), os.path.join(root, f"_{s.stem}.o"))
              for s in _build.SOURCES if s.name != source]
    jobs = [*objs.values(), *others]
    codes, outs = _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o,
                                    s] for s, o in jobs])
    for (src, _), code, out in zip(jobs, codes, outs):
        if code:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    libs = {name: os.path.join(root, f"{name}.so") for name in objs}
    codes, link_outs = _build._run_all([
        [nvcc, *_build._ARCH, "-shared", "-o", libs[name], obj,
         *[o for _, o in others]] for name, (_, obj) in objs.items()])
    for name, code, out in zip(objs, codes, link_outs):
        if code:
            raise RuntimeError(f"nvcc failed to link {name}:\n{out}")
    if logs is not None:
        logs.update(zip(objs, outs))
    return libs


def bind(path):
    """Make the library at ``path`` the one the package's wrappers call."""
    from randblas_tpu_torch.ops import _build
    _build._lib = _build._bind(ctypes.CDLL(path))


def sass_of(library):
    """``cuobjdump -sass`` of the library at ``library``; None where the
    toolkit has no cuobjdump."""
    from randblas_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout


# -- the SASS census of K6 --------------------------------------------------

# pipe classes by opcode (the part before the first dot); U* opcodes run on
# the uniform datapath; a move (MOV, IMAD.MOV) is an instruction but no
# operation of the function
PIPES = {
    "fp64": {"DFMA", "DMUL", "DADD", "DSETP", "DMNMX"},
    "imad": {"IMAD", "IMUL", "IDP", "IMADSP"},
    "alu": {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA",
            "ISETP", "SEL", "FSEL", "PRMT", "IABS", "IMNMX", "PLOP3",
            "BMSK", "BREV", "FLO", "POPC", "SGXT", "P2R", "R2P", "VIADD",
            "VIMNMX", "VIADDMNMX", "ICMP", "CSEL"},
    "fp32": {"FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FCHK", "FSWZADD"},
    "mufu": {"MUFU"},
    "conv": {"I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND", "I2I", "F2FP"},
    "mem": {"LDG", "STG", "LD", "ST", "LDL", "STL", "LDS", "STS", "LDC",
            "ATOM", "ATOMG", "RED", "LDGSTS", "ULDC"},
    "branch": {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BREAK",
               "WARPSYNC", "JMP", "BMOV", "YIELD", "BPT", "KILL"},
}
# the arithmetic pipes' operations a clock and SM (CUDA C++ Programming
# Guide, "Arithmetic Instructions", compute capability 9.0)
RATES = {"fp64": 64, "imad": 64, "alu": 64, "fp32": 128, "mufu": 16,
         "conv": 16}
ISSUE_RATE = 128  # four schedulers, one warp instruction a clock each
SMS = 132

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)")


def pipe_class(opcode):
    """The pipe class of a SASS opcode (its modifiers ignored)."""
    base = opcode.split(".")[0]
    if base == "MOV" or opcode.startswith("IMAD.MOV"):
        return "move"
    for pipe, ops in PIPES.items():
        if base in ops:
            return pipe
    return "uniform" if base.startswith("U") else "other"


def parse_sass(text):
    """{function name: [(address, opcode, operands), ...]} of
    ``cuobjdump -sass`` output, labels resolved to addresses in the
    operands (as ``0x...``)."""
    funcs = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        insns, labels, pending = [], {}, []
        for line in block.splitlines()[1:]:
            m = _LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _INSN.search(line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
        funcs[name] = [(a, op, re.sub(r"`\((\.L_x_\d+)\)",
                                      lambda t: hex(labels.get(t.group(1),
                                                               -1)), rest))
                       for a, op, rest in insns]
    return funcs


def loop_census(insns):
    """Instructions by pipe class in the main loop of one function: the
    span of its outermost backward branch, less the spans of backward
    branches nested in it (the slow paths' loops). The whole function if
    it has no loop. Returns ({class: count}, whether a loop was found)."""
    loops = []
    for addr, op, rest in insns:
        if op.startswith(("BRA", "JMP")):
            t = _TARGET.search(rest)
            if t and t.group(2) and int(t.group(2), 16) < addr:
                loops.append((int(t.group(2), 16), addr))
    if loops:
        lo, hi = max(loops, key=lambda s: s[1] - s[0])
        inner = [s for s in loops if lo <= s[0] and s[1] <= hi
                 and s != (lo, hi)]
        span = [i for i in insns if lo <= i[0] <= hi
                and not any(a <= i[0] <= b for a, b in inner)]
    else:
        span = insns
    counts = {}
    for _, op, _ in span:
        if op.startswith("NOP"):
            continue
        c = pipe_class(op)
        counts[c] = counts.get(c, 0) + 1
    return counts, bool(loops)


K6_KERNEL = re.compile(r"(fill_block64(?:_T)?_kernel)ILi(\d)ELb([01])E")
GEN_NAMES = ("philox2x64", "philox4x64", "threefry2x64", "threefry4x64")


def k6_census(sass_text, values_per_iter):
    """{(kernel, generator, gaussian): {"per_value": {class: count}, ...}}
    for each K6 instantiation in the SASS text, the loop's counts divided
    by ``values_per_iter(kernel, W)``, the values a thread makes in one
    iteration."""
    out = {}
    for name, insns in parse_sass(sass_text).items():
        m = K6_KERNEL.search(name)
        if not m:
            continue
        kernel, gen = m.group(1), GEN_NAMES[int(m.group(2))]
        w = 2 if gen.endswith("2x64") else 4
        counts, looped = loop_census(insns)
        per = values_per_iter(kernel, w)
        total = sum(counts.values())
        out[(kernel, gen, m.group(3) == "1")] = dict(
            loop=looped, instructions=total, static=len(insns),
            values_per_iteration=per,
            per_value={k: v / per for k, v in sorted(counts.items())},
            issue_per_value=total / per)
    return out


def k6_values_per_iter(text):
    """values_per_iter for the K6 source ``text``: rows (and counter
    blocks) a thread takes in one loop iteration, times W; a source
    that names neither X64_ROWS nor X64_T_BLOCKS (an earlier K6) takes two
    rows in both kernels."""
    def const(name, default):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        return int(m.group(1)) if m else default
    rows, t_blocks = const("X64_ROWS", 2), const("X64_T_BLOCKS", 1)

    def per(kernel, w):
        return (rows if kernel == "fill_block64_kernel"
                else 2 * t_blocks) * w
    return per


def operations_ms(per_value, values, sm_hz):
    """{pipe: ms}: the least time each arithmetic pipe of the card needs
    for ``values`` values at the census' per-value counts. The largest is
    the operations bound: moves, the uniform datapath, memory and branch
    instructions count in no pipe."""
    return {p: per_value.get(p, 0.0) * values / (rate * SMS * sm_hz) * 1e3
            for p, rate in RATES.items()}


def operations_bound(per_value, values, sm_hz):
    """(ms, pipe): the operations bound, the largest of operations_ms."""
    ms = operations_ms(per_value, values, sm_hz)
    pipe = max(ms, key=ms.get)
    return ms[pipe], pipe


def issue_ms(per_value, values, sm_hz):
    """ms to issue every instruction of the census at four warp
    instructions a clock and SM: a diagnostic of this SASS, not a bound,
    since it counts the moves and control flow the compiler chose."""
    return (sum(per_value.values()) * values / (ISSUE_RATE * SMS * sm_hz)
            * 1e3)
