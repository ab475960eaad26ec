"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have; the run skips the look for a card (CPU, tiny
sizes) and drives everything else: set-up, warm-up, the window, the
sample and the comparison with the reference."""

import json
import os
import sys
import time

import pytest

import randblas_tpu_torch as rt
from _pb_tiny import tiny
from portbench import harness, launch, run as prun

CELLS = ["dense_gauss_f32.whole", "saso_k8_f32.fresh"]
SOUND = rt.sketch_general


def stale():
    """Each call returns the output of the call before it."""
    last = []

    def call(S, a, **kw):
        out = SOUND(S, a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return call


def half():
    """Half of the contraction left out, the rest scaled up for it."""
    def call(S, a, **kw):
        kept = a.clone()
        kept[a.shape[0] // 2:] = 0
        return 2 * SOUND(S, kept, **kw)
    return call


def altered():
    """One entry of the output changed where it is produced."""
    def call(S, a, **kw):
        out = SOUND(S, a, **kw)
        out[3, 1] += 8 * out.std()
        return out
    return call


def _correct(spec):
    part = harness.run(spec, 2 ** 31 + 71, 0.2, False, "cpu", time.time())
    return prun.result(spec, [part], False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _correct(tiny(cell))["correct"] is True


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(rt, "sketch_general", fault())
    res = _correct(tiny(cell))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _rehearse(fault, monkeypatch):
    """The four-card cell on four gloo processes, with ``fault``."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_pb_ranks.py")
    monkeypatch.setenv("PB_FAULT", fault)
    return launch.run([sys.executable, script], 4, time.time())


@pytest.mark.parametrize("fault,want", [("none", True),
                                        ("exchange", False)])
def test_four_ranks_exchange_left_out(fault, want, monkeypatch):
    """Sound, then with the all-reduce over 'data' left out."""
    code, out = _rehearse(fault, monkeypatch)
    assert code == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is want
    assert res["device"]["count"] == 4


def test_jax_on_a_rank_but_zero_refuses_the_result(monkeypatch):
    """Rank 2 has ``jax`` in its modules when its window closes: the run
    fails and prints no result."""
    code, out = _rehearse("jax", monkeypatch)
    assert code == 3
    assert '"correct"' not in out


def test_a_failing_rank_fails_the_launch():
    code, out = launch.run([sys.executable, "-c",
                            "import os, sys, time\n"
                            "r = int(os.environ['RANK'])\n"
                            "print('rank', r)\n"
                            "sys.exit(3 if r == 2 else 0)"], 4, time.time())
    assert code == 3


def test_only_rank_zero_prints():
    code, out = launch.run([sys.executable, "-c",
                            "import os\nprint('rank', os.environ['RANK'])"],
                           4, time.time())
    assert code == 0 and out.strip() == "rank 0"
