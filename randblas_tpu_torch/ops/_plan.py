"""What the launch plans of the tiled kernels share: K1 and K2
(``fused_sketch.launch_plan``) and K4 (``saso_sketch.launch_plan``) cut
their contraction into ranges on grid.z by the same rule, from the card's
occupancy of their launch shape, which is asked once per device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SPLIT_BELOW_WAVES = 8  # cut the contraction of grids of fewer rounds
MIN_SPLIT_STEPS = 16   # steps of a split, to amortise filling the ring
MAX_WORKSPACE = 1 << 28  # bytes of partial sums


def waves(units: int, active: int, splits: int) -> float:
    """Rounds of ``active`` concurrent units (clusters or CTAs) that
    ``units`` take with the contraction cut in ``splits``, in units of the
    uncut round."""
    return -(-units * splits // active) / splits


def splits(units: int, active: int, steps: int, d: int, n: int) -> int:
    """How many ranges to cut a contraction of ``steps`` steps into, for a
    (d, n) float32 output: a grid of a few rounds leaves part of the card
    idle in the last one (16 clusters of 8 where 15 fit take two rounds;
    64 tiles on 132 SMs fill half of it), so it takes the count that fills
    the rounds best, each range of at least MIN_SPLIT_STEPS steps, with at
    most MAX_WORKSPACE bytes of partial sums. ``active`` 0 (unknown): no
    cut."""
    if not active or units >= SPLIT_BELOW_WAVES * active:
        return 1
    most = min(steps // MIN_SPLIT_STEPS, MAX_WORKSPACE // max(1, 4 * d * n))
    return min(range(1, max(1, most) + 1),
               key=lambda s: (waves(units, active, s), s))


_occupancy = {}


def occupancy(device, entry: str, *args) -> int:
    """What the library's occupancy query ``entry`` (``rbt_*``, called with
    ``args`` and a count to fill) reports on a CUDA device, 0 where it
    fails; asked once per device and arguments."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, entry, args)
    if key not in _occupancy:
        lib = _build.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            code = getattr(lib, entry)(*args, ctypes.byref(out))
        _occupancy[key] = out.value if code == 0 else 0
    return _occupancy[key]
