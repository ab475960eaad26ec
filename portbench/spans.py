"""The program's own spans (``randblas_tpu_torch.profiling.span``) read
beside the device trace of a window, and a tool that measures them in a
cell.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--pairs <k>]

runs the cell as ``run.py`` does (its data, warm-up and closed loop; one
process a card on a mesh), then, with the program's span recording on: an
untraced window (the span window: host-clock spans), a profiled window
(the device trace and the spans on one clock), and ``--pairs`` pairs of
untraced windows with recording off and on, in turns (what the spans
cost). It
prints one JSON line: the readings of the ``metrics/`` readers of this
module's quantities, each span's median duration in the span window, the
existing per-layer readings of the profiled window, its idle gaps named by the program's spans beside the same gaps
named as ``trace.summarize`` names them, the launch plans a call took, and
each pair's ``call_ms`` and ``fill_ms``. It checks no output and prints no
result of the benchmark's contract: ``run.py`` does that.

``summarize`` reduces a profiled window with the program's spans:

- ``gaps_s``: the device's idle time by the innermost host event at each
  gap's middle, a CUDA runtime call or a program span, or ``RESIDUAL``:
  the benchmark's own loop and the operator's construction;
- ``idle_s`` and ``idle_in_program_s``: all idle time, and the part of it
  that overlaps a program span that no other span encloses (split by
  overlap, not by the gap's middle);
- ``device_s_by_span``: each kernel's device time under every program span
  whose block holds its launch (the runtime call whose correlation id the
  kernel carries), by span name; ``span_calls``: the spans of each name
  begun in the window.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import sys
import threading
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench import trace  # noqa: E402

RESIDUAL = "host outside the program and the CUDA runtime"
QUANTITIES = ("dispatch_us", "idle_in_program_pct", "fill_host_ms",
              "fill_device_ms", "allreduce_wait_ms")


def _innermost(spans, points) -> list:
    """For each of the sorted ``points`` (ns), the index of the innermost
    span (name, start, end, parent, ...) that covers it, or None. Spans of
    one thread nest, so a stack swept along time holds the covering
    ones."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    out, stack, k = [], [], 0
    for p in points:
        while k < len(order) and spans[order[k]][1] <= p:
            while stack and spans[stack[-1]][2] < spans[order[k]][1]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and spans[stack[-1]][2] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def overlap(intervals, within) -> float:
    """The length of the part of ``intervals`` that lies in the union of
    ``within`` ((start, end) pairs, ns)."""
    cover = trace.union(within)
    total, j = 0, 0
    for a, b in sorted(intervals):
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        i = j
        while i < len(cover) and cover[i][0] < b:
            total += min(b, cover[i][1]) - max(a, cover[i][0])
            i += 1
    return total


def summarize(device, runtime, spans, w0: int, w1: int) -> dict:
    """Reduce a profiled window [w0, w1] (ns): ``device`` events (name,
    start, end, correlation id), the caller thread's CUDA ``runtime`` calls
    (name, start, end, correlation id) and its program ``spans``
    (``profiling.Span``, or tuples of its first five fields: name, start,
    end, parent index, call)."""
    clipped = [(n, max(s, w0), min(e, w1), c) for n, s, e, c in device
               if e > w0 and s < w1]
    busy = trace.union((s, e) for _, s, e, _ in clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [(n, s, e) for n, s, e, _ in runtime] + [
        (sp[0], sp[1], sp[2]) for sp in spans]
    names = trace._host_names(host, [(a + b) / 2 for a, b in gaps])
    named = collections.Counter()
    for (a, b), name in zip(gaps, names):
        named[RESIDUAL if name == trace.IDLE_HOST else name] += (b - a) / 1e9
    outer = [(sp[1], sp[2]) for sp in spans if sp[3] is None]

    # a kernel's launch: the runtime call of its correlation id; the spans
    # that hold it: the innermost at the call's start and its parents
    launch = {c: s for _, s, _, c in runtime if c}
    kernels = [(n, s, e, launch[c]) for n, s, e, c in clipped
               if c in launch and not n.startswith(trace.NOT_KERNELS)]
    at = sorted(range(len(kernels)), key=lambda i: kernels[i][3])
    inner = _innermost(spans, [kernels[i][3] for i in at])
    by_span = collections.Counter()
    for i, sp in zip(at, inner):
        n, s, e, _ = kernels[i]
        held = set()
        while sp is not None:
            held.add(spans[sp][0])
            sp = spans[sp][3]
        for name in held:
            by_span[name] += (e - s) / 1e9
            if n.startswith("nccl"):
                by_span[f"{name}:nccl"] += (e - s) / 1e9
    calls = collections.Counter(sp[0] for sp in spans if w0 <= sp[1] < w1)
    return {
        "gaps_s": dict(named),
        "idle_s": sum(b - a for a, b in gaps) / 1e9,
        "idle_in_program_s": overlap(gaps, outer) / 1e9,
        "device_s_by_span": dict(by_span),
        "span_calls": dict(calls),
    }


def durations(spans) -> tuple:
    """({name: [seconds]} of every span, the same of the outermost ones)."""
    every, outer = collections.defaultdict(list), collections.defaultdict(
        list)
    for sp in spans:
        every[sp[0]].append((sp[2] - sp[1]) / 1e9)
        if sp[3] is None:
            outer[sp[0]].append((sp[2] - sp[1]) / 1e9)
    return dict(every), dict(outer)


def plans(spans, calls: int) -> dict:
    """The launch plans a call took: ``K*.launch`` spans by their args."""
    got = collections.Counter(
        sp[0] + json.dumps(sp[5], sort_keys=True) for sp in spans
        if sp[0].endswith(".launch"))
    return {k: v / max(1, calls) for k, v in got.items()}


def reading_summary(span_window: list, traced: list) -> dict:
    """What the readers of this module's quantities read: rank 0's
    host-clock spans of the span window (``durations``), and each rank's
    ``summarize`` of its profiled window (``traced``, in rank order)."""
    every, outer = durations(span_window)
    return {
        "span_s": every,
        "outer_span_s": outer,
        "idle_s": [t["idle_s"] for t in traced],
        "idle_in_program_s": [t["idle_in_program_s"] for t in traced],
        "program_spans": sum(sum(t["span_calls"].values()) for t in traced),
        "device_s_by_span": traced[0]["device_s_by_span"],
        "span_calls": traced[0]["span_calls"],
        "allreduce_s": [
            t["device_s_by_span"].get("sum_over:nccl", 0.0)
            / t["span_calls"]["sum_over"]
            for t in traced if t["span_calls"].get("sum_over")],
    }


# -- the tool -----------------------------------------------------------


class Recorder(trace.Recorder):
    """``trace.Recorder`` that keeps each event's correlation id."""

    def events(self) -> tuple:
        """(device events, the caller thread's runtime calls, window)."""
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            ev = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.correlation_id())
            if e.device_type() == DeviceType.CPU:
                if e.name() not in trace.PROFILER_OWN:
                    host.append((ev, e.start_thread_id()))
            elif not e.is_user_annotation():
                device.append(ev)
        tid = collections.Counter(t for _, t in host).most_common(1)
        host = [h for h, t in host if tid and t == tid[0][0]]
        return device, host, self._clock


def _mine(spans) -> list:
    """The spans of this thread, their parents re-indexed."""
    me = threading.get_native_id()
    keep = [i for i, s in enumerate(spans) if s.thread == me]
    new = {old: i for i, old in enumerate(keep)}
    return [spans[i]._replace(parent=new.get(spans[i].parent),
                              call=new.get(spans[i].call, -1))
            for i in keep]


def measure(spec: dict, seed: int, seconds: float, pairs: int, device,
            mesh=None) -> dict:
    """This rank's part: the span window, the profiled window and the
    pairs (see the module docstring)."""
    import torch
    from randblas_tpu_torch import profiling
    from portbench import harness
    from portbench.workload import sync
    device = torch.device(device)
    ranks = harness.Ranks(mesh)
    wl = spec["call"].Call(spec["config"], spec["traffic"], seed, device,
                           ranks.rank, ranks.world, mesh)
    for j in (1, 2):
        wl.call(-j)
        sync(device)
        ranks.barrier()
    samples, first = spec["expect"]["samples"], 0

    def window(spans=None, counts=None):
        nonlocal first
        w = harness.window(wl, ranks, seconds, samples, seed, spans, first,
                           counts)
        first += w["attempted"]
        done = w["attempted"] - w["failed"]
        return w, done

    part = {"rank": ranks.rank}
    with profiling.recording() as rec:
        w, done = window({})
    spans = _mine(rec.spans)
    part["span_window"] = [tuple(s[:6]) for s in spans]
    part["calls_span_window"] = done
    part["plans"] = plans(spans, done)

    prof = Recorder()
    part["counts"] = {}
    with profiling.recording() as rec, prof, prof.window():
        w, done = window(counts=part["counts"])
    spans = _mine(rec.spans)
    dev, runtime, clock = prof.events()
    part["traced"] = summarize(dev, runtime, [tuple(s[:5]) for s in spans],
                               *clock)
    part["trace"] = trace.summarize([e[:3] for e in dev],
                                    [e[:3] for e in runtime], *clock)
    part["calls_traced"] = done
    del prof

    part["pairs"] = []
    for k in range(pairs):      # off, on, then on, off: no drift favours one
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            fills = {}
            with (profiling.recording() if on
                  else contextlib.nullcontext()):
                w, done = window(fills)
            f = fills.get("fill", [])
            part["pairs"].append({
                "spans": on, "call_ms": w["seconds"] / max(1, done) * 1e3,
                "fill_ms": 1e3 * sum(f) / len(f) if f else None})
    return part


def report(spec: dict, parts: list) -> dict:
    """The printed line from every rank's part (rank order)."""
    from portbench import harness
    p0 = parts[0]
    s = reading_summary(p0["span_window"], [p["traced"] for p in parts])
    new = {q: harness.reader(q)(s) for q in QUANTITIES}
    sums = [p["trace"] for p in parts]
    old_summary = {
        "calls": p0["calls_traced"], "chips": len(parts),
        "window_s": statistics.fmean(t["window_s"] for t in sums),
        "busy_s": statistics.fmean(t["busy_s"] for t in sums),
        "busy_s_rank0": sums[0]["busy_s"], "kernels": sums[0]["kernels"],
        "ops_s": sums[0]["ops_s"], "gaps_s": sums[0]["gaps_s"],
        "spans": {}, "counts": p0["counts"],
        "least_s": harness.least_seconds(spec, p0["counts"])}
    old = {}
    for m in spec["per_layer"]:
        if m["source"] == "device_trace":
            old[m["name"]] = harness.reader(m["name"], spec["here"])(
                old_summary)
    return {"portbench_spans": {
        "new": new, "existing_traced": old,
        "span_us_median": {k: 1e6 * statistics.median(v)
                           for k, v in s["span_s"].items()},
        "idle_gaps_named": trace.top(p0["traced"]["gaps_s"]),
        "idle_gaps_as_run_py": trace.top(sums[0]["gaps_s"]),
        "plans_per_call_by_rank": [p["plans"] for p in parts],
        "device_ms_by_span_per_call": {
            k: 1e3 * v / p0["calls_traced"]
            for k, v in p0["traced"]["device_s_by_span"].items()},
        "span_calls_traced": p0["traced"]["span_calls"],
        "calls": {"span_window": p0["calls_span_window"],
                  "traced": p0["calls_traced"]},
        "allreduce_ms_by_rank": [1e3 * x for x in s["allreduce_s"]],
        "pairs": p0["pairs"]}}


def main(argv=None) -> int:
    import argparse
    from portbench import harness, launch
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    spec = harness.find_cell(args.workload)
    chips = spec["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench spans: the cell needs {chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    if chips > 1 and not args.rank:
        cmd = [sys.executable, os.path.abspath(__file__),
               *(sys.argv[1:] if argv is None else argv), "--rank"]
        code, out = launch.run(cmd, chips, time.time())
        sys.stdout.write(out)
        return code
    if args.rank:
        import torch.distributed as dist
        from randblas_tpu_torch import parallel
        parallel.initialize_multihost()
        shape = spec["config"]["mesh"]
        mesh = parallel.make_sketch_mesh(shape["model"], shape["data"])
        device = torch.device("cuda", torch.cuda.current_device())
        part = measure(spec, args.seed, args.seconds, args.pairs, device,
                       mesh)
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, part)
        if dist.get_rank() == 0:
            print(json.dumps(report(spec, parts)), flush=True)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    torch.cuda.set_device(0)
    part = measure(spec, args.seed, args.seconds, args.pairs,
                   torch.device("cuda", 0))
    print(json.dumps(report(spec, [part])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
