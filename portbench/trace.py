"""The device trace of a measured window, read in memory.

``Recorder`` runs ``torch.profiler`` around the window and keeps no trace
file. It records CUDA activity only: the device's operations and the
host's CUDA runtime calls. Recording every PyTorch operation on the host
as well doubled the traced call of the host-paced cells, where CUDA
activity alone slows it by half. The window's bounds are read on the host
clock. ``summarize`` reduces the events to what the per-layer metrics and
the result's ``device`` and ``breakdown`` need:

- ``busy_s``: the union of the device's operation intervals inside the
  window (kernels, copies, sets), so overlapping streams count once;
- ``kernels``: the kernels launched in the window (copies and sets are
  not kernels);
- ``ops_s``: device seconds by operation name;
- ``gaps_s``: the device's idle time by what the host was doing: the
  innermost host event of the caller's thread at the middle of each gap
  (a CUDA runtime call), or ``IDLE_HOST`` where the host was in none:
  Python and PyTorch's own dispatch between runtime calls.
"""

from __future__ import annotations

import collections
import contextlib
import time

NOT_KERNELS = ("Memcpy", "Memset")
PROFILER_OWN = ("Activity Buffer Request",)   # the profiler's own host work
IDLE_HOST = "host outside the CUDA runtime"


def union(intervals) -> list:
    """The sorted, merged (start, end) intervals of ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _host_names(host, points) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    event (name, start, end) that covers it, or ``IDLE_HOST``. Host events
    of one thread nest, so a stack swept along time holds the covering
    ones."""
    host = sorted(host, key=lambda e: (e[1], -e[2]))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][1] <= p:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        names.append(stack[-1][0] if stack else IDLE_HOST)
    return names


def summarize(device, host, w0: int, w1: int) -> dict:
    """Reduce the device events (name, start_ns, end_ns) and the host
    events of the window's thread to the window [w0, w1] (ns)."""
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device
               if e > w0 and s < w1]
    busy = union((s, e) for _, s, e in clipped)
    ops = collections.Counter()
    for n, s, e in clipped:
        ops[n] += (e - s) / 1e9
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    names = _host_names(host, [(a + b) / 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), name in zip(gaps, names):
        idle[name] += (b - a) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": sum(1 for n, _, _ in clipped
                       if not n.startswith(NOT_KERNELS)),
        "ops_s": dict(ops),
        "gaps_s": dict(idle),
    }


def top(counts: dict, k: int = 10) -> list:
    """The k largest [name, seconds] of a dict, largest first."""
    return [[n, v] for n, v in sorted(counts.items(),
                                      key=lambda x: -x[1])[:k]]


class Recorder:
    """The profiler around a measured window; ``summary()`` after it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        on_card = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                         else ProfilerActivity.CPU])
        self._clock = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    @contextlib.contextmanager
    def window(self):
        """Marks the measured window on the host clock, which the
        profiler's timestamps share (Unix nanoseconds)."""
        t0 = time.time_ns()
        yield
        self._clock = (t0, time.time_ns())

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CPU:
                if e.name() not in PROFILER_OWN:
                    host.append((span, e.start_thread_id()))
            elif not e.is_user_annotation():   # annotations run nothing
                device.append(span)
        # the caller's thread: the one that made the most host calls
        tid = collections.Counter(t for _, t in host).most_common(1)
        host = [s for s, t in host if tid and t == tid[0][0]]
        return summarize(device, host, *self._clock)
