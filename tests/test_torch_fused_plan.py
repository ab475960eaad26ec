"""The launch plan of the fused sketch kernels K1 and K2
(randblas_tpu_torch.ops.fused_sketch.launch_plan): the one place where
their tiles, thread-block cluster, grid and contraction splits are chosen.
The kernels only check it, so the CPU can hold it to its promises:

- the tiles cover every output element exactly once, for ragged d and n and
  K2's row shift, and the splits cover every contraction step exactly once;
- the cluster is a power of two up to 16 and divides grid.x;
- every operator element is generated ceil(ceil(n / TN) / C) times, at most
  twice at the main path's shape and at the backward pass's;
- the row limit follows TI;
- the right route hands K1 a transposed view of A, which the plan keeps
  (no contiguous copy).

``max_active`` stands for the card's cudaOccupancyMaxActiveClusters: None
(unknown, the portable cluster of 8 and no splits) or the counts an H100
80GB HBM3 reports for this kernel (15 clusters of 8, 7 of 16)."""

import numpy as np
import pytest
import torch

import randblas_tpu_torch as rt
from randblas_tpu_torch.ops import fused_sketch as fs

H100 = {8: 15, 16: 7}
MAIN = (1024, 65536, 4096)      # K1 on the main path: d, m, n
BACKWARD = (65536, 1024, 4096)  # K2 in (a)'s backward pass and (b)

SHAPES = [  # (d, m, n, shift)
    (1024, 65536, 4096, 0),
    (65536, 1024, 4096, 0),
    (1000, 60003, 4000, 0),
    (60000, 1000, 1000, 3),
    (50, 40, 100, 1),
    (300, 3000, 2 * 1024 + 1, 2),
    (130, 1000, 5 * 256, 0),
    (1024, 16384, 16384, 0),
    (1, 1, 1, 0),
]


def _coverage(plan, d, n, shift):
    """How many tiles of the plan write each output element."""
    hits = np.zeros((d, n), dtype=np.uint8)
    grid_x, grid_y = plan.grid
    for y in range(grid_y):
        r0 = max(0, y * plan.ti - shift)
        r1 = min(d, (y + 1) * plan.ti - shift)
        for x in range(grid_x):
            c0, c1 = x * plan.tn, min(n, (x + 1) * plan.tn)
            if r0 < r1 and c0 < c1:
                hits[r0:r1, c0:c1] += 1
    return hits


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("d,m,n,shift", [s for s in SHAPES
                                         if s[0] * s[2] <= 1 << 22])
def test_tiles_cover_each_output_once(d, m, n, shift, max_active):
    plan = fs.launch_plan(d, m, n, shift, max_active)
    assert (plan.ti, plan.tn, plan.tk) == (fs.TI, fs.TN, fs.TK)
    assert np.all(_coverage(plan, d, n, shift) == 1)


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("d,m,n,shift", SHAPES)
def test_splits_cover_each_step_once(d, m, n, shift, max_active):
    plan = fs.launch_plan(d, m, n, shift, max_active)
    steps = max(1, -(-m // fs.TK))
    assert plan.splits * plan.split_steps >= steps
    assert (plan.splits - 1) * plan.split_steps < steps
    if plan.splits > 1:
        assert plan.splits * d * n * 4 <= fs._MAX_WORKSPACE
        assert plan.split_steps >= fs._MIN_SPLIT_STEPS


@pytest.mark.parametrize("max_active", [None, H100, {8: 15, 16: 0}])
@pytest.mark.parametrize("d,m,n,shift", SHAPES)
def test_cluster_divides_grid_x(d, m, n, shift, max_active):
    plan = fs.launch_plan(d, m, n, shift, max_active)
    c = plan.cluster
    assert c in (1, 2, 4, 8, 16)
    assert plan.grid[0] % c == 0
    assert plan.grid[0] * plan.tn >= n > (plan.grid[0] - c) * plan.tn
    assert plan.grid[1] == -(-(d + shift) // plan.ti)
    if max_active is None or not max_active.get(16):
        assert c <= 8  # clusters of 16 only where the card runs them


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("d,m,n,shift", SHAPES)
def test_regeneration_factor(d, m, n, shift, max_active):
    plan = fs.launch_plan(d, m, n, shift, max_active)
    tiles = -(-n // plan.tn)
    assert plan.regen == -(-tiles // plan.cluster)
    assert plan.regen == plan.grid[0] // plan.cluster


@pytest.mark.parametrize("max_active", [None, H100])
@pytest.mark.parametrize("shape", [MAIN, BACKWARD], ids=["main", "backward"])
def test_main_and_backward_generate_s_at_most_twice(shape, max_active):
    plan = fs.launch_plan(*shape, 0, max_active)
    assert plan.regen <= 2


def test_h100_plan_of_the_main_path():
    # clusters of 16 (S generated once) win over the 15 clusters of 8 the
    # card fits; the contraction splits so that the 8 clusters' work fills
    # the 7 that run at once
    plan = fs.launch_plan(*MAIN, 0, H100)
    assert plan.cluster == 16 and plan.regen == 1
    assert plan.grid == (16, 8)
    units = plan.grid[0] // plan.cluster * plan.grid[1] * plan.splits
    assert units % H100[16] == 0


def test_plan_words_are_what_the_launcher_reads():
    plan = fs.launch_plan(*MAIN, 0, H100)
    assert list(plan.words()) == [plan.ti, plan.tn, plan.tk, plan.cluster,
                                  *plan.grid, plan.splits, plan.split_steps]


def test_row_limit_follows_ti():
    assert fs._MAX_GRID_Y_ROWS == 65535 * fs.TI
    plan = fs.launch_plan(fs._MAX_GRID_Y_ROWS, 64, 8)
    assert plan.grid[1] == 65535
    assert fs.launch_plan(fs._MAX_GRID_Y_ROWS + 1, 64, 8).grid[1] == 65536
    S = rt.DenseSkOp(rt.DenseDist(8, 64), rt.RNGState.from_key(0))
    with pytest.raises(ValueError, match="at most"):
        fs._launch(False, S.seed_state, torch.ones(64, 8),
                   fs._MAX_GRID_Y_ROWS + 1, 0, 16, True, 1.0)
    with pytest.raises(ValueError, match="at most"):
        fs._launch(True, S.seed_state, torch.ones(64, 8),
                   fs._MAX_GRID_Y_ROWS - 1, 2, 16, True, 1.0)


@pytest.mark.parametrize("co_s", [0, 8])
def test_fused_plan_keeps_a_transposed_view(co_s):
    # the right route hands K1 a_mat.T: K1 reads it through its strides
    S = rt.DenseSkOp(rt.DenseDist(40, 300), rt.RNGState.from_key(1))
    a_mat = torch.ones(16, 250)
    base, A, d, _, _ = fs._fused_plan(S, a_mat.T, 20, 250, 3, co_s)
    assert A.data_ptr() == a_mat.data_ptr()
    assert A.stride() == a_mat.T.stride() and not A.is_contiguous()
    assert d == 20


def test_fused_plan_pads_an_unaligned_column_offset():
    # co_s % 4 zero rows on top of A: the one case that still copies A
    S = rt.DenseSkOp(rt.DenseDist(40, 300), rt.RNGState.from_key(1))
    a_mat = torch.ones(16, 250)
    _, A, _, _, _ = fs._fused_plan(S, a_mat.T, 20, 250, 3, 6)
    assert A.shape == (252, 16)
    assert torch.equal(A[:2], torch.zeros(2, 16))
    assert torch.equal(A[2:], a_mat.T)


def test_colmajor_plan_keeps_strides():
    S = rt.DenseSkOp(rt.DenseDist(300, 40), rt.RNGState.from_key(2))
    a_mat = torch.ones(16, 30)
    _, A, d, shift, _, _ = fs._colmajor_plan(S, a_mat.T, 250, 30, 5, 4)
    assert A.data_ptr() == a_mat.data_ptr() and not A.is_contiguous()
    assert (d, shift) == (250, 1)
