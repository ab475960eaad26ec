"""On the card: the port's launch spans and the profiler's trace share one
clock. Every runtime call that launched a K1 or K4 kernel in a profiled
window (tied to its kernel by correlation id) lies inside a ``K1.launch``
or ``K4.launch`` span of the same window, within ``SLACK_NS``, and each
launch span holds one. Run on a machine with a CUDA device from the
repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda_spans.py

It imports neither JAX nor the JAX package. Marked ``cuda``; skips where
``torch.cuda.is_available()`` is False (decided inside the fixture).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# Both clocks read the host's real-time clock. On an H100 80GB HBM3 every
# launch call lay inside its span, margin 0 ns, starting 0.18-0.32 ms
# after the span's start and ending 19-70 us before its end (PERF.md
# section 6); the slack allows for the profiler's conversion of CUPTI's
# timestamps to that clock.
SLACK_NS = 2000
KERNELS = {"K1": "fused_sketch_kernel", "K4": "saso_sketch_kernel"}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _calls(kernel: str, device, calls: int = 5):
    """``calls`` sketches of a shape that takes ``kernel`` on the card."""
    import randblas_tpu_torch as rt
    gen = torch.Generator(device=device).manual_seed(7)
    a = torch.randn(16384, 2048, device=device, generator=gen)
    if kernel == "K1":
        ops = [rt.DenseSkOp(rt.DenseDist(1024, 16384),
                            rt.RNGState.from_key(i)) for i in range(calls)]
        flags = {"use_fused": True}
    else:
        ops = [rt.SparseSkOp(rt.SparseDist(1024, 16384, 8),
                             rt.RNGState.from_key(i)).filled(device)
               for i in range(calls)]
        flags = {"use_saso_kernel": True}
    torch.cuda.synchronize(device)

    def run():
        with rt.flags(**flags):
            for S in ops:
                rt.sketch_general(S, a)
        torch.cuda.synchronize(device)
    return run


def launch_margins(kernel: str, device) -> tuple:
    """(margins, launch spans, launch calls): for each launch of ``kernel``
    in a profiled window of five calls, how far (ns) its runtime call lies
    outside the nearest ``<kernel>.launch`` span, 0 inside one; the spans'
    and the calls' (start, end) ns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from randblas_tpu_torch import profiling
    run = _calls(kernel, device)
    run()                                     # built and warm
    with profiling.recording() as rec, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        run()
    events = list(prof.profiler.kineto_results.events())
    corr = {e.correlation_id() for e in events
            if e.device_type() != DeviceType.CPU
            and KERNELS[kernel] in e.name()}
    calls = {}   # correlation id -> the host call that launched it
    for e in events:
        c = e.correlation_id()
        if e.device_type() == DeviceType.CPU and c in corr:
            c0, c1 = e.start_ns(), e.start_ns() + e.duration_ns()
            got = calls.setdefault(c, (c0, c1))
            calls[c] = (min(got[0], c0), max(got[1], c1))
    calls = sorted(calls.values())
    mine = [(s.start_ns, s.end_ns) for s in rec.spans
            if s.name == f"{kernel}.launch"]
    margins = [min(max(s0 - c0, c1 - s1, 0) for s0, s1 in mine)
               for c0, c1 in calls]
    return margins, mine, calls


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_calls_lie_inside_their_launch_spans(card, kernel):
    margins, mine, _ = launch_margins(kernel, card)
    assert len(mine) == 5
    assert len(margins) == len(mine), (
        f"{len(margins)} runtime launches of {KERNELS[kernel]} for "
        f"{len(mine)} spans")
    assert max(margins) <= SLACK_NS, margins
