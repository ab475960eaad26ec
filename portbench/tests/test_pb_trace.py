"""The trace arithmetic on synthetic event lists, the per-call numbers
and the per-layer readers."""

import time

import pytest

from _pb_tiny import tiny
from portbench import harness, trace
from portbench.workload import p95


def test_union_merges_overlaps():
    assert trace.union([(5, 9), (0, 2), (1, 3), (9, 10), (12, 13)]) == [
        [0, 3], [5, 10], [12, 13]]


def test_summarize_busy_idle_kernels_and_gaps():
    device = [("k1", 10, 20), ("k1", 15, 30), ("Memcpy HtoD", 40, 45),
              ("ncclDevKernel_AllReduce", 50, 60), ("late", 95, 120),
              ("early", -10, 5)]
    host = [("call", 0, 100), ("cudaStreamSynchronize", 30, 40),
            ("cudaLaunchKernel", 45, 50)]
    s = trace.summarize(device, host, 0, 100)
    assert s["window_s"] == pytest.approx(100e-9)
    # busy: [0,5] [10,30] [40,45] [50,60] [95,100] = 5+20+5+10+5
    assert s["busy_s"] == pytest.approx(45e-9)
    assert s["kernels"] == 5            # the copy is no kernel
    assert s["ops_s"]["k1"] == pytest.approx(25e-9)
    assert s["ops_s"]["late"] == pytest.approx(5e-9)
    # gaps [5,10] [30,40] [45,50] [60,95]
    assert s["gaps_s"] == pytest.approx(
        {"call": 40e-9, "cudaStreamSynchronize": 10e-9,
         "cudaLaunchKernel": 5e-9})


def test_gap_outside_any_host_event_is_host_idle():
    s = trace.summarize([("k", 0, 10)], [("call", 12, 20)], 0, 50)
    assert s["gaps_s"] == pytest.approx({trace.IDLE_HOST: 40e-9})


def test_top_keeps_ten_largest():
    got = trace.top({f"k{i}": float(i) for i in range(15)})
    assert [n for n, _ in got] == [f"k{i}" for i in range(14, 4, -1)]


def test_p95_interpolates():
    assert p95(list(range(101))) == pytest.approx(95.0)
    assert p95([1.0, 2.0]) == pytest.approx(1.95)
    assert p95([3.0]) == 3.0


SUMMARY = {"calls": 100, "chips": 1, "window_s": 2.0, "busy_s": 1.5,
           "busy_s_rank0": 1.5, "kernels": 300,
           "ops_s": {"k": 1.2, "ncclDevKernel_AllReduce": 0.3},
           "gaps_s": {}, "spans": {"fill": [0.004, 0.006]},
           "least_s": 0.003}


@pytest.mark.parametrize("name,want", [
    ("idle_pct", 25.0), ("roofline_pct", 20.0), ("kernels_per_call", 3.0),
    ("fill_ms", 5.0), ("nccl_pct", 20.0)])
def test_readers(name, want):
    assert harness.reader(name)(SUMMARY) == pytest.approx(want)


@pytest.mark.parametrize("name", ["idle_pct", "roofline_pct",
                                  "kernels_per_call", "fill_ms", "nccl_pct"])
def test_readers_that_find_nothing_return_nothing(name):
    empty = dict(SUMMARY, busy_s=0.0, busy_s_rank0=0.0, kernels=0, spans={},
                 ops_s={"k": 1.0})
    assert harness.reader(name)(empty) is None


@pytest.mark.parametrize("cell,spans", [("saso_k8_f32.fresh", True),
                                        ("dense_gauss_f32.whole", False)])
def test_host_clock_spans_come_from_an_untraced_window(cell, spans):
    """A traced run of a cell with a host-clock metric first runs an
    untraced window for its spans, then the traced one, whose calls carry
    on from the first's; the part counts the calls of both."""
    part = harness.run(tiny(cell), 2 ** 31 + 9, 0.2, True, "cpu",
                       time.time())
    fills = part["spans"].get("fill", [])
    traced = part["window"]["attempted"]
    if spans:
        assert len(fills) == part["attempted"] - traced > 0
    else:
        assert not fills and part["attempted"] == traced
    assert part["failed"] == 0 and part["forbidden"] == []
