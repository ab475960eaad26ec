"""Timing and tracing of the port's calls (counterpart of
randblas_tpu/profiling.py).

- ``time_op``: the time of one call of ``fn(i, carry, *operands)``, with
  CUDA events on CUDA operands (after a warm-up call, the median of
  ``iters_large`` calls) and ``time.perf_counter`` on CPU ones. The carry
  threads a data dependence from call to call, as in the JAX package, so
  no call can be skipped or overlapped.
- ``roofline_report``: GFLOP/s of a sketch against a GEMM's, and the
  operator bytes generated per second, the JAX package's keys and
  arithmetic.
- ``trace``: a ``torch.profiler`` context that writes a Chrome trace into
  a directory (a no-op without one).

Not ported: ``bench_util.time_loop``, the JAX package's loop differencing
for a TPU whose ``block_until_ready`` returns early; CUDA events time the
card's own work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class OpTiming:
    seconds: float
    flops: float

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9


def time_op(fn: Callable, *operands, flops: float,
            iters_large: int = 4) -> OpTiming:
    """Time ``fn(i, carry, *operands)``, which runs the op and returns the
    next carry, a tensor that depends on the op's result (the first call
    gets a float32 scalar 0 on the first tensor operand's device). One
    warm-up call, then ``iters_large`` timed calls; the median of their
    times. CUDA events when a tensor operand lies on the card, else the
    host clock: pass the op's tensors as operands."""
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    cuda = any(x.is_cuda for x in tensors)
    device = tensors[0].device if tensors else torch.device("cpu")
    carry = fn(0, torch.zeros((), device=device), *operands)
    times = []
    for i in range(1, int(iters_large) + 1):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            carry = fn(i, carry, *operands)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            carry = fn(i, carry, *operands)
            times.append(time.perf_counter() - t0)
    return OpTiming(seconds=statistics.median(times), flops=flops)


def roofline_report(sketch_timing: OpTiming, gemm_timing: OpTiming,
                    gen_bytes: Optional[float] = None) -> dict:
    """Summary dict: sketch GFLOP/s, roofline GFLOP/s, fraction, and the
    effective in-kernel generation bandwidth (bytes of operator produced
    per second) if gen_bytes is given."""
    rep = {
        "sketch_gflops": sketch_timing.gflops,
        "roofline_gflops": gemm_timing.gflops,
        "fraction_of_roofline": sketch_timing.gflops / gemm_timing.gflops,
    }
    if gen_bytes is not None:
        rep["gen_gbytes_per_s"] = gen_bytes / sketch_timing.seconds / 1e9
    return rep


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """A torch.profiler trace of the block, CPU and (where present) CUDA
    activity, written as a Chrome trace into ``trace_dir``; a no-op when
    ``trace_dir`` is None. Yields the profiler (None for the no-op)."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
