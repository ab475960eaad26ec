"""The launch plan of the SASO sketch kernel K4
(randblas_tpu_torch.ops.saso_sketch.launch_plan): the one place where its
tiles, grid and contraction splits are chosen. The kernel only checks it,
so the CPU can hold it to its promises:

- the tiles cover every output element exactly once, for ragged d and n up
  to the gate's d = 4096, and the splits cover every contraction step
  exactly once;
- the row tiles of one column tile are adjacent on grid.x (they read the
  same tiles of A), and the grid stays inside CUDA's limits;
- at run_all.py config 3 the splits fill the card's SMs.

``max_active`` stands for the card's cudaOccupancyMaxActiveClusters of K4's
launch shape (clusters of one CTA): None (unknown: no splits) or the 132
CTAs an H100 80GB HBM3 runs at once, one per SM."""

import numpy as np
import pytest

from randblas_tpu_torch.ops import _plan
from randblas_tpu_torch.ops import saso_sketch as saso

H100 = 132
CONFIG3 = (1024, 65536, 2048)   # run_all.py config 3: d, m, n

SHAPES = [  # (d, m, n)
    CONFIG3,
    (1000, 60001, 777),
    (513, 4096, 7),
    (60, 500, 33),
    (40, 40, 300),
    (2048, 8192, 64),
    (4096, 8192, 64),
    (3000, 3000, 100),
    (256, 2048, 129),
    (1, 1, 1),
]


def _coverage(plan, d, n):
    """How many tiles of the plan write each output element."""
    hits = np.zeros((d, n), dtype=np.uint8)
    for t in range(plan.grid[0]):
        r0, c0 = (t % plan.row_tiles) * plan.ti, (t // plan.row_tiles) * plan.tn
        hits[r0:min(d, r0 + plan.ti), c0:min(n, c0 + plan.tn)] += 1
    return hits


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("d,m,n", SHAPES)
def test_tiles_cover_each_output_once(d, m, n, max_active):
    plan = saso.launch_plan(d, m, n, max_active)
    assert (plan.ti, plan.tn, plan.tk) == (saso.TI, saso.TN, saso.TK)
    assert plan.row_tiles == -(-d // plan.ti)
    assert plan.col_tiles == -(-n // plan.tn)
    assert np.all(_coverage(plan, d, n) == 1)


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("d,m,n", SHAPES)
def test_splits_cover_each_step_once(d, m, n, max_active):
    plan = saso.launch_plan(d, m, n, max_active)
    steps = max(1, -(-m // saso.TK))
    assert plan.splits * plan.split_steps >= steps
    assert (plan.splits - 1) * plan.split_steps < steps
    assert plan.grid[2] == plan.splits
    if plan.splits > 1:
        assert plan.splits * d * n * 4 <= _plan.MAX_WORKSPACE
        assert plan.split_steps >= _plan.MIN_SPLIT_STEPS
    if max_active is None:
        assert plan.splits == 1


@pytest.mark.parametrize("d,m,n", SHAPES)
def test_grid_limits(d, m, n):
    plan = saso.launch_plan(d, m, n, H100)
    assert plan.grid == (plan.row_tiles * plan.col_tiles, 1, plan.splits)
    assert plan.grid[0] <= 0x7fffffff and plan.splits <= 65535
    # the gate's largest d takes 16 row tiles, adjacent on grid.x
    assert plan.row_tiles <= saso.MAX_D_PAD // saso.TI


def test_config3_fills_the_sms():
    # 4 x 16 tiles on 132 SMs fill half the card; two splits of 512 steps
    # each fill 128 SMs in one round
    plan = saso.launch_plan(*CONFIG3, H100)
    assert (plan.row_tiles, plan.col_tiles) == (4, 16)
    assert plan.splits == 2 and plan.split_steps == 512
    ctas = plan.grid[0] * plan.splits
    assert H100 * 0.95 <= ctas <= H100


def test_large_grids_do_not_split():
    plan = saso.launch_plan(4096, 65536, 1 << 20, H100)
    assert plan.grid[0] >= 8 * H100 and plan.splits == 1


def test_plan_words_are_what_the_launcher_reads():
    plan = saso.launch_plan(*CONFIG3, H100)
    assert list(plan.words()) == [plan.ti, plan.tn, plan.tk, plan.row_tiles,
                                  plan.col_tiles, plan.splits,
                                  plan.split_steps]
