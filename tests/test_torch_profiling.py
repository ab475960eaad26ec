"""randblas_tpu_torch.profiling against randblas_tpu.profiling, on the CPU.

``roofline_report`` takes the same timings in both packages and gives the
same dict (the same float64 arithmetic, so equal). ``time_op`` on CPU
tensors times with the host clock: its seconds are positive and its GFLOP/s
is flops / seconds. ``trace(None)`` is a no-op and ``trace(dir)`` writes a
Chrome trace of the block into the directory. The CUDA-event branch of
``time_op`` runs on the card (chip_smoke.py phase 12).
"""

import json

import pytest
import torch

from randblas_tpu import profiling as jprof
import randblas_tpu_torch as rt
from randblas_tpu_torch import profiling


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
