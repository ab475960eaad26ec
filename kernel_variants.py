"""What chip_smoke.py and the ablation scripts (fused_ablation.py,
saso_ablation.py, fill_ablation.py) share: the card's name, times by CUDA
events and by torch.profiler device time, and copies of a kernel source
built with text substitutions and bound in place of the package's library.

It imports torch and nothing of JAX. The package it builds and binds is the
``randblas_tpu_torch`` that ``sys.path`` finds.
"""

import ctypes
import os
import statistics
import subprocess

import torch


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


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


def build_variants(source, variants, root):
    """One library per entry of ``variants`` ({name: [(old, new), ...]}):
    ``csrc/<source>`` of the package with each text substitution made (each
    checked to match, so a variant that no longer changes anything fails
    the build), linked with the package's other sources unchanged, all
    compiled in parallel into ``root``. Returns {name: library path}."""
    from randblas_tpu_torch.ops import _build
    text0 = (_build._PKG / "csrc" / source).read_text()
    others = [str(s) for s in _build.SOURCES if s.name != source]
    os.makedirs(root, exist_ok=True)
    procs, libs = {}, {}
    for name, subs in variants.items():
        text = text0
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        src = os.path.join(root, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        libs[name] = os.path.join(root, f"{name}.so")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             libs[name], src, *others],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return libs


def bind(path):
    """Make the library at ``path`` the one the package's wrappers call."""
    from randblas_tpu_torch.ops import _build
    _build._lib = _build._bind(ctypes.CDLL(path))
