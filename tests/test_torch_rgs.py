"""Randomized Gram-Schmidt QR and its precise sketch of the port against the
JAX package and float64, on the CPU, with the same numpy-seeded inputs.

Tolerances: R 1e-4 relative to max |R| and Q 1e-4 of max |Q| up to column
signs (LAPACK's panel QRs may flip a sign; the CGS2 passes round in
another order), on matrices of condition 10: Q's trailing columns carry
float32 rounding times cond(A), so two float32 implementations part by
~1e-4 at cond 1e4 (the cond 1e7 test holds the port to the properties
instead); ``_precise_sketch`` 1e-6 of max |want| against the float64
product of the same operator; next states equal.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
import randblas_tpu_torch as rt
from randblas_tpu_torch import linalg as tla
from randblas_tpu_torch.linalg.embed import make_embedding

# the modules, not the functions of the same name that linalg exports
jrgs = importlib.import_module("randblas_tpu.linalg.rgs")
trgs = importlib.import_module("randblas_tpu_torch.linalg.rgs")

R_REL = 1e-4
SKETCH_TOL = 1e-6


def _states(key=3):
    j = rb.RNGState.from_key(key)
    return j, rt.RNGState.from_dict(j.to_dict())


def _tall(m=300, k=26, cond=10.0, seed=0):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.normal(size=(m, k)))
    v, _ = np.linalg.qr(rng.normal(size=(k, k)))
    s = cond ** (-np.arange(k) / (k - 1))
    return ((u * s) @ v.T).astype(np.float32)


def _aligned(tq, jq):
    """tq with each column flipped to jq's sign."""
    signs = np.sign((tq * jq).sum(axis=0))
    return tq * signs[None, :], signs


@pytest.mark.parametrize("operator", ["gaussian", "saso", "srht"])
@pytest.mark.parametrize("final", ["orth", "sketch"])
def test_rgs_qr(operator, final):
    a = _tall()
    js, ts = _states(4)
    jq, jr, jn = jrgs.rgs_qr(jnp.asarray(a), js, block=8, operator=operator,
                             final=final)
    tq, tr, tn = tla.rgs_qr(torch.from_numpy(a), ts, block=8,
                            operator=operator, final=final)
    jq, jr = np.asarray(jq, np.float64), np.asarray(jr, np.float64)
    tq, tr = tq.numpy().astype(np.float64), tr.numpy().astype(np.float64)
    tq, signs = _aligned(tq, jq)
    tr = tr * signs[:, None]
    assert np.abs(tq - jq).max() <= R_REL * np.abs(jq).max()
    assert np.abs(tr - jr).max() <= R_REL * np.abs(jr).max()
    assert np.allclose(tr, np.triu(tr))
    assert np.linalg.norm(tq @ tr - a) <= 1e-5 * np.linalg.norm(a)
    assert tn.to_dict() == jn.to_dict()


def test_rgs_qr_orthonormal_at_cond_1e7():
    """The regime RGS exists for: float32 CholQR's Gram is singular at this
    condition number, RGS's Q is orthonormal to float32 after 'orth'."""
    a = _tall(m=1000, k=40, cond=1e7)
    q, r, _ = tla.rgs_qr(torch.from_numpy(a), _states(5)[1], block=16)
    q, r = q.double(), r.double()
    assert (q.T @ q - torch.eye(40, dtype=torch.float64)).norm(2) < 2e-3
    assert (q @ r - torch.from_numpy(a).double()).norm() < \
        2e-4 * np.linalg.norm(a)


def test_clip_triangular():
    rng = np.random.default_rng(6)
    r = np.triu(rng.normal(size=(5, 5))).astype(np.float32)
    r[2, 2] = 0.0
    want = np.asarray(jrgs._clip_triangular(jnp.asarray(r)))
    np.testing.assert_array_equal(
        trgs._clip_triangular(torch.from_numpy(r)).numpy(), want)


def test_rgs_panel_step():
    rng = np.random.default_rng(7)
    m, d, k, b = 60, 30, 12, 4
    a = rng.normal(size=(m, b)).astype(np.float32)
    sa = rng.normal(size=(d, b)).astype(np.float32)
    q0, _ = np.linalg.qr(rng.normal(size=(m, 4)))
    sq0, _ = np.linalg.qr(rng.normal(size=(d, 4)))
    bufs = []
    for mod, conv in ((jrgs, jnp.asarray), (trgs, torch.from_numpy)):
        q = np.zeros((m, k), np.float32)
        sq = np.zeros((d, k), np.float32)
        q[:, :4], sq[:, :4] = q0, sq0
        r = np.zeros((k, k), np.float32)
        args = [conv(x) for x in (q, sq, r, a, sa)]
        out = mod._rgs_panel_step(*args, 4)
        bufs.append([np.asarray(x) for x in (out if out is not None
                                             else args[:3])])
    for t, j in zip(bufs[1], bufs[0]):
        assert np.abs(t - j).max() <= R_REL * max(np.abs(j).max(), 1.0)


def _want(S, a):
    """The float64 product of the operator's entries with a."""
    return (S.materialize(device="cpu").double() @ torch.from_numpy(a)
            .double()).numpy()


@pytest.mark.parametrize("operator,cap", [("gaussian", None),
                                          ("gaussian", 1000),
                                          ("saso", None), ("saso", 1000),
                                          ("srht", None)])
def test_precise_sketch(monkeypatch, operator, cap):
    """Each family on both sides of the footprint cap (lowered through the
    module's constant, not a giant matrix), against float64 and JAX."""
    if cap is not None:
        monkeypatch.setattr(trgs, "_FOOTPRINT_CAP", cap)
        monkeypatch.setattr(jrgs, "_FOOTPRINT_CAP", cap)
    rng = np.random.default_rng(8)
    m, k, d = 256, 10, 24
    a = rng.normal(size=(m, k)).astype(np.float32)
    js, ts = _states(9)
    tS = make_embedding(operator, d, m, ts)
    got = trgs._precise_sketch(tS, torch.from_numpy(a), 0.5).numpy()
    want = 0.5 * _want(tS, a)
    assert np.abs(got - want).max() <= SKETCH_TOL * np.abs(want).max()
    from randblas_tpu.linalg.embed import make_embedding as jmake
    jgot = np.asarray(jrgs._precise_sketch(jmake(operator, d, m, js),
                                           jnp.asarray(a), 0.5))
    assert np.abs(got - jgot).max() <= SKETCH_TOL * np.abs(want).max()


def test_precise_sketch_never_reaches_the_bf16_kernels(monkeypatch):
    """With every kernel route forced on (their plain versions on the
    CPU), RGS still never calls K1, K2 or K4."""
    from randblas_tpu_torch.ops import fused_sketch, saso_sketch

    def refuse(*args, **kwargs):
        raise AssertionError("a bf16-operand kernel was reached")

    for mod, name in ((fused_sketch, "fused_sketch"),
                      (fused_sketch, "fused_sketch_colmajor"),
                      (saso_sketch, "saso_sketch")):
        monkeypatch.setattr(mod, name, refuse)
    a = torch.from_numpy(_tall(m=400, k=20))
    with rt.flags(use_fused=True, use_saso_kernel=True):
        for operator in ("gaussian", "saso", "srht"):
            q, r, _ = tla.rgs_qr(a, _states(10)[1], block=8,
                                 operator=operator)
            assert (q @ r - a).norm() <= 1e-5 * a.norm()
