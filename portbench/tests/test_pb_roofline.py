"""The call modules' work against counts by hand, and the least time a
call, for every cell."""

import pytest

from portbench import harness, roofline, run as prun

D, M, N = 1024, 65536, 4096
HAND = {   # (operations, bytes) of one call
    "dense_gauss_f32.whole": (2 * D * M * N, (M * N + D * N) * 4),
    "saso_k8_f32.fresh": (2 * 8 * M * 2048, (M * 2048 + D * 2048) * 4),
    "dense_gauss_rows_x4.whole": (2 * D * 2 ** 23 * N,
                                  (2 ** 23 * N + D * N) * 4),
}
LEAST_MS = {   # the bound, and what sets it
    "dense_gauss_f32.whole": 549755813888 / 989e12 * 1e3,     # bf16 ops
    "saso_k8_f32.fresh": 545259520 / 3.35e12 * 1e3,           # bytes
    "dense_gauss_rows_x4.whole": 70368744177664 / (4 * 989e12) * 1e3,
}


# the least time a call as the benchmark has read it since it began: a
# change to how a call's work is found leaves it where it was
PINNED_MS = {
    "dense_gauss_f32.whole": 0.5558703881577352,
    "saso_k8_f32.fresh": 0.16276403582089552,
    "dense_gauss_rows_x4.whole": 17.787852421047525,
}


@pytest.mark.parametrize("cell", sorted(HAND))
def test_work_by_hand(cell):
    spec = harness.find_cell(cell)
    config = spec["config"]
    assert spec["call"].work(config, {}) == HAND[cell]
    precision = spec["call"].precision(config, spec["expect"])
    least = roofline.least_seconds(*HAND[cell], config["chips"], precision)
    assert least * 1e3 == pytest.approx(LEAST_MS[cell], rel=1e-12)


@pytest.mark.parametrize("cell", sorted(PINNED_MS))
def test_least_time_a_call_is_pinned(cell):
    """What ``roofline_pct`` divides by, as ``run.py`` passes it to the
    readers."""
    spec = harness.find_cell(cell)
    part = {"window": {"attempted": 10, "failed": 0}, "spans": {},
            "counts": {},
            "summary": {"window_s": 1.0, "busy_s": 0.5, "kernels": 20,
                        "ops_s": {}, "gaps_s": {}}}
    least = prun._summary(spec, [part])["least_s"]
    assert least * 1e3 == pytest.approx(PINNED_MS[cell], rel=1e-9)


def test_peaks_are_the_data_sheets():
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12
    assert roofline.PEAK_FLOPS["float32"] == 67e12
    assert roofline.PEAK_FLOPS["tf32"] == 495e12
    assert roofline.PEAK_BYTES == 3.35e12
