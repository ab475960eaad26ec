"""randblas_tpu_torch.profiling against randblas_tpu.profiling, on the CPU.

``roofline_report`` takes the same timings in both packages and gives the
same dict (the same float64 arithmetic, so equal). ``time_op`` on CPU
tensors times with the host clock: its seconds are positive and its GFLOP/s
is flops / seconds. ``trace(None)`` is a no-op and ``trace(dir)`` writes a
Chrome trace of the block into the directory, with the block's spans. The
CUDA-event branch of ``time_op`` runs on the card (chip_smoke.py phase 12).

Spans (no JAX in these cases): off, nothing is recorded and every output is
bitwise the recorded call's; on, ``sketch`` encloses ``route``, which ends
before the call returns, with the route that ``route_counts`` counted; a
fill is ``fill`` over one ``fisher_yates.step`` a step; every span lies
inside its parent and shares its call's id; K1/K2's launch spans carry the
launch plan (the launcher stood in for on the CPU); on a two-rank gloo mesh
``distributed_sketch`` encloses ``sum_over`` on each rank. That a launch
span holds its kernel's runtime launch on the card's trace is a card test
(tests/test_torch_cuda_spans.py).
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from randblas_tpu import profiling as jprof
import randblas_tpu_torch as rt
from randblas_tpu_torch import profiling, skge
from randblas_tpu_torch.ops import fused_sketch as fs


@pytest.mark.parametrize("gen_bytes", [None, 3.0e9])
def test_roofline_report_matches_the_jax_package(gen_bytes):
    sk, gemm = (1.25e-3, 2.0e12), (4.0e-4, 2.0e12)
    got = profiling.roofline_report(profiling.OpTiming(*sk),
                                    profiling.OpTiming(*gemm), gen_bytes)
    want = jprof.roofline_report(jprof.OpTiming(*sk), jprof.OpTiming(*gemm),
                                 gen_bytes)
    assert got == want
    assert sorted(got) == sorted(want)


def test_time_op_on_cpu_tensors():
    S = rt.DenseSkOp(rt.DenseDist(16, 256), rt.RNGState.from_key(3))
    A = torch.randn(256, 32, generator=torch.Generator().manual_seed(0))
    seen = []

    def body(i, carry, a):
        seen.append((i, carry.dtype, carry.device.type))
        return carry + rt.sketch_general(S, a)[0, 0] * 0

    flops = 2.0 * 16 * 256 * 32
    t = profiling.time_op(body, A, flops=flops, iters_large=3)
    assert t.seconds > 0 and t.flops == flops
    assert t.gflops == pytest.approx(flops / t.seconds / 1e9)
    assert t.gflops > 0
    assert seen == [(i, torch.float32, "cpu") for i in range(4)]


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None) as prof:
        torch.ones(4).sum()
    assert prof is None
    assert not list(tmp_path.iterdir())


def test_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "traces"
    with profiling.trace(str(out)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(out.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- spans ----------------------------------------------------------------

GEN = torch.Generator().manual_seed(5)
A_TALL = torch.randn(256, 24, generator=GEN)     # m = 256 rows of data
A_WIDE = torch.randn(24, 256, generator=GEN)     # right sketches
A_SHORT = torch.randn(16, 24, generator=GEN)     # a tall operator's data


def _dense(d=16, m=256):
    return rt.DenseSkOp(rt.DenseDist(d, m), rt.RNGState.from_key(3))


def _saso(d=16, m=256, k=8, key=4):
    return rt.SparseSkOp(rt.SparseDist(d, m, k), rt.RNGState.from_key(key))


# (operator, data, sketch_general's keywords, flags, route)
CALLS = {
    "dense_staged": (_dense, A_TALL, {}, {}, "left_staged"),
    "dense_fused": (_dense, A_TALL, {}, {"use_fused": True}, "left_fused"),
    "dense_trans_fused": (lambda: _dense(256, 16), A_TALL, {"op_s": "T"},
                          {"use_fused": True}, "left_trans_fused"),
    "dense_right_fused": (lambda: _dense(256, 16), A_WIDE,
                          {"side": "right"}, {"use_fused": True},
                          "right_fused"),
    "dense_right_staged": (lambda: _dense(256, 16), A_WIDE,
                           {"side": "right"}, {}, "right_staged"),
    "saso_lazy": (_saso, A_TALL, {}, {}, "sparse_fixed_nnz"),
    "saso_kernel": (_saso, A_TALL, {}, {"use_saso_kernel": True},
                    "sparse_saso_kernel"),
    "saso_filled_tall": (lambda: _saso(256, 16, 4).filled("cpu"), A_SHORT,
                         {}, {}, "sparse_row_gather"),
    "saso_right": (lambda: _saso(256, 16, 4), A_WIDE, {"side": "right"},
                   {}, "sparse_fixed_nnz"),
    "saso_offset": (_saso, A_TALL[:128], {"d": 8, "co_s": 64}, {},
                    "sparse_coo"),
    "srht": (lambda: rt.TrigSkOp(rt.TrigDist(16, 256),
                                 rt.RNGState.from_key(6)),
             A_TALL, {}, {}, "srht"),
}


def _call(case, S):
    _, a, kw, flags, _ = CALLS[case]
    with rt.flags(**flags):
        return rt.sketch_general(S, a, **kw)


def _tree(spans):
    """[(name, parent name or None)] of the spans, in order."""
    return [(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans]


def _nested(spans) -> None:
    """Every parent precedes its child and holds it in time; every span
    shares its parent's call, and an outermost span's call is its own."""
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == i
            continue
        p = spans[s.parent]
        assert s.parent < i and s.call == p.call
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_off_is_one_shared_object_that_records_nothing():
    assert profiling.span("sketch") is profiling.span("fill", j=1)
    with profiling.span("sketch") as off:
        off.set(route="x")
    with profiling.recording() as rec:
        pass
    assert rec.spans == []


@pytest.mark.parametrize("case", sorted(CALLS))
def test_spans_change_no_output(case):
    S = CALLS[case][0]()
    off = _call(case, S)
    with profiling.recording() as rec:
        on = _call(case, S)
    assert rec.spans
    assert torch.equal(off, on)


@pytest.mark.parametrize("case", sorted(CALLS))
def test_sketch_span_holds_the_route_decision(case):
    S = CALLS[case][0]()
    skge.route_counts.clear()
    with profiling.recording() as rec:
        _call(case, S)
        returned = profiling.time.time_ns()
    spans = rec.spans
    _nested(spans)
    tree = _tree(spans)
    assert tree[:2] == [("sketch", None), ("route", "sketch")]
    sketch, route = spans[0], spans[1]
    assert route.end_ns <= sketch.end_ns <= returned
    # nothing is filled or launched while the route is decided
    assert all(s.start_ns >= route.end_ns for s in spans[2:])
    assert dict(skge.route_counts) == {sketch.args["route"]: 1}
    assert sketch.args["route"] == CALLS[case][4]
    if case == "saso_lazy":      # the lazy operator's fill, in the call
        assert tree[2] == ("fill", "sketch")


def test_fill_span_holds_one_step_span_a_step():
    with profiling.recording() as rec:
        rt.fill_sparse(_saso(k=8), device="cpu")
    spans = rec.spans
    _nested(spans)
    assert _tree(spans) == [("fill", None)] + [
        ("fisher_yates.step", "fill")] * 8
    assert [s.args["j"] for s in spans[1:]] == list(range(8))


def test_calls_have_ids_of_their_own():
    S = _saso()
    with profiling.recording() as rec:
        for _ in range(2):
            rt.sketch_general(S.filled("cpu"), A_TALL)
    spans = rec.spans
    _nested(spans)
    outer = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in outer] == ["fill", "sketch"] * 2
    assert len({spans[i].call for i in outer}) == 4
    for i in outer:
        inside = [s for s in spans if s.call == i]
        assert inside[0] is spans[i] and len(inside) == (
            9 if spans[i].name == "fill" else 2)


def test_recordings_do_not_nest():
    with profiling.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.recording():
                pass
    assert profiling.span("x") is profiling.span("y")


@pytest.mark.parametrize("colmajor", [False, True])
def test_launch_span_reports_the_launch_plan(monkeypatch, colmajor):
    """K1's and K2's launcher, stood in for on the CPU: the launch span
    holds the plan that ``launch_plan`` chose and the launcher's call."""
    calls = []

    class Lib:
        def rbt_fused_sketch(self, *args):
            calls.append(profiling.time.time_ns())
            return 0
        rbt_fused_sketch_T = rbt_fused_sketch

    active = {8: 16, 16: 7}
    monkeypatch.setattr(fs._build, "load", Lib)
    monkeypatch.setattr(fs, "max_active_clusters", lambda device: active)
    monkeypatch.setattr(fs, "_stream", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    d, m, n = 1024, 4096, 2048
    a = torch.zeros(m, n)
    with profiling.recording() as rec:
        fs._launch(colmajor, rt.RNGState.from_key(1), a, d, 0, 1024, True,
                   1.0)
    (span,) = rec.spans
    plan = fs.launch_plan(d, m, n, 0, active)
    assert span.name == ("K2.launch" if colmajor else "K1.launch")
    assert span.args == {"cluster": plan.cluster, "splits": plan.splits}
    assert plan.splits > 1
    assert span.start_ns <= calls[0] <= span.end_ns


def test_distributed_sketch_span_holds_sum_over_on_each_rank(tmp_path):
    world = 2
    worker = Path(__file__).with_name("_torch_spans_worker.py")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), f"localhost:{port}", str(rank),
         str(world), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=str(worker.parent.parent))
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), outs
    for rank in range(world):
        got = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert got["bitwise"] is True
        spans = [profiling.Span(*s, {}, 0) for s in got["spans"]]
        _nested(spans)
        tree = _tree(spans)
        assert tree[0] == ("distributed_sketch", None)
        assert ("sum_over", "distributed_sketch") in tree
        assert all(p is not None for _, p in tree[1:])


def test_trace_carries_the_spans(tmp_path):
    out = tmp_path / "traces"
    with profiling.trace(str(out)):
        rt.sketch_general(_saso().filled("cpu"), A_TALL)
    doc = json.loads(next(out.glob("*.json")).read_text())
    events = doc["traceEvents"]
    track = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in track] == (
        ["fill"] + ["fisher_yates.step"] * 8 + ["sketch", "route"])
    assert track[-2]["args"]["route"] == "sparse_fixed_nnz"
    assert len({e["pid"] for e in track}) == 1
    pid = track[0]["pid"]
    assert pid not in {e.get("pid") for e in events
                       if e.get("cat") != "span" and e.get("ph") == "X"}
    # on the trace's time base: the spans lie among the profiler's events
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    first = min(e["ts"] for e in ops)
    last = max(e["ts"] + e["dur"] for e in ops)
    assert first - 1e6 < track[0]["ts"] and track[-1]["ts"] < last + 1e6
