"""The program's spans beside the device trace (``portbench/spans.py``):
the overlap split, the naming of idle gaps with program spans, kernels
tied to the span that launched them by correlation id, the readers of its
quantities on synthetic summaries (None where nothing is read), and the
tool's windows on the CPU, on one process and on a two-rank gloo mesh."""

import json
import os
import sys
import time

import pytest

from _pb_tiny import tiny
from portbench import harness, launch, spans, trace


def test_overlap_counts_only_the_covered_part():
    within = [(10, 20), (15, 30), (40, 50)]     # union [10, 30] [40, 50]
    assert spans.overlap([(0, 12), (25, 45), (60, 70)], within) == 2 + 10
    assert spans.overlap([(0, 100)], within) == 30
    assert spans.overlap([(0, 5)], within) == 0


# A window [0, 100]: the caller's thread runs a call 0..60 (``sketch`` with
# ``route`` and ``K1.launch`` inside it) and a fill 70..90 (two steps).
# Device: k1 20..50 (launched at 16, inside K1.launch), a fill kernel
# 80..85 (launched at 74, step 0), a copy 86..88 (corr 4, launched in step
# 1), a kernel launched outside any span (corr 5, at 95) running 95..97.
PROGRAM = [("sketch", 5, 60, None, 0), ("route", 6, 9, 0, 0),
           ("K1.launch", 12, 18, 0, 0), ("fill", 70, 90, None, 3),
           ("fisher_yates.step", 72, 76, 3, 3),
           ("fisher_yates.step", 76, 89, 3, 3)]
RUNTIME = [("cudaLaunchKernelExC", 14, 17, 1),
           ("cudaLaunchKernel", 73, 75, 2), ("cudaMemcpyAsync", 77, 78, 4),
           ("cudaDeviceSynchronize", 55, 62, 0),
           ("cudaLaunchKernel", 94, 95, 5)]
DEVICE = [("k1", 20, 50, 1), ("fill_kernel", 80, 85, 2),
          ("Memcpy DtoD", 86, 88, 4), ("late", 95, 97, 5)]


def _summary():
    return spans.summarize(DEVICE, RUNTIME, PROGRAM, 0, 100)


def test_gaps_are_named_by_the_innermost_host_event():
    # gaps [0,20] mid 10 (no span: route ended at 9, K1.launch starts at
    # 12) -> sketch; [50,80] mid 65 -> residual; [85,86] mid 85.5 -> step;
    # [88,95] mid 91.5 -> residual; [97,100] mid 98.5 -> residual
    got = _summary()["gaps_s"]
    assert got == pytest.approx({"sketch": 20e-9, spans.RESIDUAL: 40e-9,
                                 "fisher_yates.step": 1e-9})
    # the benchmark's reading of the same gaps knows no program span
    old = trace.summarize([d[:3] for d in DEVICE], [r[:3] for r in RUNTIME],
                          0, 100)["gaps_s"]
    assert set(old) == {trace.IDLE_HOST}


def test_a_runtime_call_inside_a_span_keeps_its_name():
    s = spans.summarize([("k", 0, 10, 1), ("k", 30, 40, 2)],
                        [("cudaLaunchKernel", 5, 6, 1),
                         ("cudaStreamSynchronize", 12, 28, 0),
                         ("cudaLaunchKernel", 29, 30, 2)],
                        [("sketch", 1, 30, None, 0)], 0, 40)
    assert s["gaps_s"] == pytest.approx({"cudaStreamSynchronize": 20e-9})


def test_idle_time_split_by_overlap_with_outermost_spans():
    s = _summary()
    assert s["idle_s"] == pytest.approx(61e-9)      # 20 + 30 + 1 + 7 + 3
    # outermost spans [5, 60] and [70, 90]: 15 of [0,20], 10+10 of [50,80],
    # 1 of [85,86], 2 of [88,95]
    assert s["idle_in_program_s"] == pytest.approx(38e-9)


def test_kernels_are_tied_to_the_span_of_their_launch():
    s = _summary()
    assert s["device_s_by_span"] == pytest.approx({
        "K1.launch": 30e-9, "sketch": 30e-9, "fill": 5e-9,
        "fisher_yates.step": 5e-9})
    assert s["span_calls"] == {"sketch": 1, "route": 1, "K1.launch": 1,
                               "fill": 1, "fisher_yates.step": 2}


def test_nccl_kernels_are_kept_apart():
    s = spans.summarize(
        [("ncclDevKernel_AllReduce_Sum_f32", 10, 40, 7)],
        [("cudaLaunchKernelExC", 3, 4, 7)],
        [("distributed_sketch", 0, 9, None, 0), ("sum_over", 2, 8, 0, 0)],
        0, 50)
    assert s["device_s_by_span"]["sum_over:nccl"] == pytest.approx(30e-9)


SUMMARY = {"span_s": {"fill": [0.004, 0.002], "sketch": [1e-4, 3e-4]},
           "outer_span_s": {"fill": [0.004, 0.002], "sketch": [1e-4, 3e-4]},
           "idle_s": [2.0, 1.0], "idle_in_program_s": [0.5, 0.5],
           "program_spans": 40,
           "device_s_by_span": {"fill": 0.03, "K4.launch": 0.02},
           "span_calls": {"fill": 20, "sketch": 20},
           "allreduce_s": [0.003, 0.001, 0.002, 0.002]}


@pytest.mark.parametrize("name,want", [
    ("dispatch_us", 200.0), ("idle_in_program_pct", 37.5),
    ("fill_host_ms", 3.0), ("fill_device_ms", 1.5),
    ("allreduce_wait_ms", 1.0)])
def test_readers(name, want):
    assert harness.reader(name)(SUMMARY) == pytest.approx(want)


def test_dispatch_on_a_mesh_is_the_distributed_sketch():
    s = dict(SUMMARY, outer_span_s={"distributed_sketch": [0.002]})
    assert harness.reader("dispatch_us")(s) == pytest.approx(2000.0)


@pytest.mark.parametrize("name", spans.QUANTITIES)
def test_readers_that_find_nothing_return_nothing(name):
    """What a program without spans (or a cell without the span) gives."""
    empty = {"span_s": {}, "outer_span_s": {}, "idle_s": [1.0],
             "idle_in_program_s": [0.0], "program_spans": 0,
             "device_s_by_span": {}, "span_calls": {}, "allreduce_s": []}
    assert harness.reader(name)(empty) is None


@pytest.mark.parametrize("cell", ["dense_gauss_f32.whole",
                                  "saso_k8_f32.fresh"])
def test_the_tool_on_the_cpu(cell):
    spec = tiny(cell)
    part = spans.measure(spec, 2 ** 31 + 29, 0.2, 2, "cpu")
    out = spans.report(spec, [part])["portbench_spans"]
    new = out["new"]
    assert new["dispatch_us"] > 0
    names = [s[0] for s in part["span_window"]]
    assert "sketch" in names and "route" in names
    if cell == "saso_k8_f32.fresh":
        assert new["fill_host_ms"] > 0
        assert names.count("fisher_yates.step") == 8 * names.count("fill")
    else:
        assert new["fill_host_ms"] is None and "fill" not in names
    assert [p["spans"] for p in out["pairs"]] == [False, True, True, False]
    assert all(p["call_ms"] > 0 for p in out["pairs"])


def test_the_tool_on_a_two_rank_gloo_mesh():
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_pb_span_ranks.py")
    code, out = launch.run([sys.executable, script], 2, time.time())
    assert code == 0
    got = json.loads(out.strip().splitlines()[-1])["portbench_spans"]
    assert got["new"]["dispatch_us"] > 0
    assert got["span_calls_traced"]["distributed_sketch"] == \
        got["span_calls_traced"]["sum_over"] > 0
    assert len(got["allreduce_ms_by_rank"]) == 2
