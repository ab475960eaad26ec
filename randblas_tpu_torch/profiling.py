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
  a directory (a no-op without one), with the block's spans on a host
  track of their own.
- ``span`` and ``recording``: named intervals of the port's host work
  (the sketch's dispatch, its route decision, the K1/K2/K4 launches, the
  Fisher-Yates fill and its steps, the distributed sketch and its
  all-reduce), kept in memory while a ``recording()`` block runs. Their
  times are ``time.time_ns()``, the Unix-nanosecond clock of
  ``torch.profiler``'s timestamps, so a span and the device's events of
  a trace lie on one time line. Off (the default) ``span`` returns one
  shared object that does nothing: no clock, no lock, no synchronize.

Not ported: ``bench_util.time_loop``, the JAX package's loop differencing
for a TPU whose ``block_until_ready`` returns early; CUDA events time the
card's own work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import threading
import time
from typing import Callable, NamedTuple, Optional

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


# -- spans ----------------------------------------------------------------


class Span(NamedTuple):
    """One recorded span. ``parent`` is the index (in the recording) of the
    span that encloses it on its thread, None for an outermost one;
    ``call`` is the index of the outermost span it lies in (its own for
    an outermost span); ``thread`` the OS thread id it ran on."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call: int
    args: dict
    thread: int


class _Off:
    """The span of a block run while no recording is on: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """Args of the span (ignored: nothing is recorded)."""


_OFF = _Off()
_recording = None   # the Recording that spans go to, or None (off)


class _On:
    """A span of a recording: opened by ``with``, its times read from
    ``time.time_ns()`` at the block's start and end."""
    __slots__ = ("_rec", "_name", "_args", "_row")

    def __init__(self, rec, name, args):
        self._rec, self._name, self._args = rec, name, args

    def __enter__(self):
        rec = self._rec
        local = rec._thread()
        stack = local.stack
        index = next(rec._count)
        parent = stack[-1] if stack else None
        call = index if parent is None else rec._rows[parent][4]
        # a Span's fields; the end stays None until the block ends
        self._row = [self._name, 0, None, parent, call, self._args,
                     local.tid]
        rec._rows[index] = self._row
        stack.append(index)
        self._row[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._row[2] = time.time_ns()
        self._rec._thread().stack.pop()
        return False

    def set(self, **args) -> None:
        """Add ``args`` to the span's args (a value known only inside the
        block: the route taken, the launch plan)."""
        self._args.update(args)


def span(name: str, **args):
    """A context manager that records the block as the span ``name`` with
    ``args`` while a ``recording()`` is on; otherwise one shared object
    that does nothing. ``set(**args)`` on the object it yields adds args."""
    rec = _recording
    if rec is None:
        return _OFF
    return _On(rec, name, args)


class Recording:
    """The spans of a ``recording()`` block, in the order they were
    opened: ``spans`` once the block has ended."""

    def __init__(self):
        self._count = itertools.count()
        self._rows = {}
        self._local = threading.local()
        self.spans = []

    def _thread(self):
        """This thread's open spans (``stack``) and OS thread id (``tid``)."""
        local = self._local
        if not hasattr(local, "tid"):
            local.stack, local.tid = [], threading.get_native_id()
        return local

    def _finish(self) -> None:
        self.spans = [Span(r[0], r[1], r[2], r[3], r[4], r[5], r[6])
                      for _, r in sorted(self._rows.items())
                      if r[2] is not None]


@contextlib.contextmanager
def recording():
    """Record the port's spans while the block runs; yields a
    ``Recording`` whose ``spans`` are read out when the block ends. One
    recording at a time: a second one inside the block raises."""
    global _recording
    if _recording is not None:
        raise RuntimeError("span recording is already on")
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        rec._finish()


def _add_span_track(path: str, spans) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    of a process track of their own, on the trace's time base
    (``baseTimeNanoseconds``, where the exporter writes one)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.setdefault("traceEvents", [])
    base = int(doc.get("baseTimeNanoseconds", 0))
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    pid = max(pids, default=0) + 1
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "randblas_tpu_torch spans"}})
    for i, s in enumerate(spans):
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.args, index=i, parent=s.parent, call=s.call)})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """A torch.profiler trace of the block, CPU and (where present) CUDA
    activity, and the port's spans of the block, written as one Chrome
    trace into ``trace_dir`` (the spans on a host track of their own); a
    no-op when ``trace_dir`` is None. Yields the profiler (None for the
    no-op). It records spans, so it does not nest in ``recording()``."""
    if trace_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with recording() as rec, profile(activities=activities) as prof:
        yield prof
    path = os.path.join(trace_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, rec.spans)
