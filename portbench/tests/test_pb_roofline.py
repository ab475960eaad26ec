"""The work functions against counts by hand, for every cell."""

import pytest

from portbench import harness, roofline

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


@pytest.mark.parametrize("cell", sorted(HAND))
def test_work_by_hand(cell):
    spec = harness.find_cell(cell)
    assert roofline.call_work(spec["config"]) == HAND[cell]
    precision = spec["config"]["precision"][spec["expect"]["route"]]
    least = roofline.least_seconds(spec["config"], precision)
    assert least * 1e3 == pytest.approx(LEAST_MS[cell], rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert roofline.PEAK_FLOPS["bfloat16"] == 989e12
    assert roofline.PEAK_FLOPS["float32"] == 67e12
    assert roofline.PEAK_FLOPS["tf32"] == 495e12
    assert roofline.PEAK_BYTES == 3.35e12
