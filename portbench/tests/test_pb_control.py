"""The control of each cell: the reference computed in the precision just
below the one the configuration states for the cell's route has to come
out not correct, where the program's own path (its kernels' plain
versions on the CPU, at the precision it states) comes out correct. At a
size a CPU test holds; the limits are the cells' own."""

import time

import pytest
import torch

import randblas_tpu_torch as rt
from _pb_tiny import tiny
from portbench import harness
from portbench.reference import compare, sketch

# the flags that put each route's plain version on the CPU
PLAIN = {"dense_gauss_f32.whole": {"use_fused": True},
         "saso_k8_f32.fresh": {"use_saso_kernel": True}}


@pytest.mark.parametrize("cell", sorted(PLAIN))
def test_control_fails_where_the_program_passes(cell):
    spec = tiny(cell)
    limits = spec["expect"]["limits"]
    precision = spec["call"].precision(spec["config"], spec["expect"])
    with rt.flags(**PLAIN[cell]):
        part = harness.run(spec, 2 ** 31 + 3, 0.2, False, "cpu", time.time())
    assert all(part["checks"][k] <= v for k, v in limits.items())
    wl = spec["call"].Call(spec["config"], spec["traffic"], 2 ** 31 + 3,
                           "cpu")
    readings = []
    for i in range(3):
        exact = wl.exact_part(i)
        got = wl.control_part(i, sketch.BELOW[precision])
        readings.append(compare.gaps(got, exact))
    worst = compare.worst(readings)
    assert any(worst[k] > limits[k] for k in ("rel_fro", "max_rel"))


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -12)])
    got = sketch._round(x, "tf32")
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -(1.0 + 2 ** -10)]
