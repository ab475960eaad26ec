"""Autograd through the port's fused kernels K1 and K2, on the CPU, against
the JAX package's jax.custom_vjp (its Pallas kernels in interpret mode).

The sketch B = alpha * block(S) @ A is linear in A, so with the loss
sum(B * G) the gradient is alpha * block^T @ G. In both packages the
backward pass of K1 is K2 on the transposed distribution and that of K2 is
K1 (a square distribution takes the filled block), so on the CPU the port's
gradient is the other kernel's plain version. Compared normalised by
max |want| at 1e-4, as the forward kernels (tests/test_torch_fused.py): the
sums run in another order and Gaussian values may differ by an ulp, which
can flip a bf16 rounding. A few cases take jax.grad itself (the JAX suite
marks its own gradient tests slow, so these stay tiny); the others compare
with the JAX forward of the other kernel on the transposed distribution,
which is the same VJP by construction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import randblas_tpu as rb
from randblas_tpu.ops import fused_sketch as jfs
import randblas_tpu_torch as rt
from randblas_tpu_torch import skge as tskge
from randblas_tpu_torch.ops import fused_sketch as tfs

TOL = 1e-4


def _ops(shape, family="Gaussian", major="Long", key=1):
    jS = rb.DenseSkOp(rb.DenseDist(*shape, rb.DenseDistName[family],
                                   rb.MajorAxis[major]),
                      rb.RNGState.from_key(key))
    tS = rt.DenseSkOp(rt.DenseDist(*shape, rt.DenseDistName[family],
                                   rt.MajorAxis[major]),
                      rt.RNGState.from_key(key))
    return jS, tS


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol=TOL):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _port_grad(kernel, tS, A, G, **kw):
    a = torch.from_numpy(A).requires_grad_()
    B = kernel(tS, a, **kw)
    (grad,) = torch.autograd.grad((B.float() * torch.from_numpy(G)).sum(), a)
    return grad


# (kernel, operator shape, family, major, A shape, kwargs of the kernel)
JAX_GRAD_CASES = [
    ("fused_sketch", (16, 64), "Gaussian", "Long", (64, 24),
     dict(alpha=0.5)),
    ("fused_sketch_colmajor", (96, 32), "Gaussian", "Long", (32, 16), {}),
    ("fused_sketch", (32, 32), "Gaussian", "Short", (32, 8), {}),   # square
    ("fused_sketch_colmajor", (32, 32), "Gaussian", "Long", (32, 8), {}),
]


@pytest.mark.parametrize("kernel,shape,family,major,a_shape,kw",
                         JAX_GRAD_CASES)
def test_grad_matches_jax_grad(kernel, shape, family, major, a_shape, kw):
    jS, tS = _ops(shape, family, major)
    A = _data(a_shape, seed=a_shape[1])
    d = kw.get("rows_s", shape[0])
    G = _data((d, a_shape[1]), seed=7)
    jfn = getattr(jfs, kernel)
    want = jax.grad(lambda a: jnp.sum(
        jfn(jS, a, interpret=True, **kw) * G))(jnp.asarray(A))
    got = _port_grad(getattr(tfs, kernel), tS, A, G, **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


# (kernel, operator shape, family, major, (d, m, n), ro_s, co_s, alpha)
TRANSPOSED_CASES = [
    ("fused_sketch", (40, 120), "Gaussian", "Long", (24, 64, 8), 8, 13, 1.0),
    ("fused_sketch", (16, 64), "Uniform", "Long", (16, 64, 8), 0, 0, 2.0),
    ("fused_sketch", (300, 40), "Uniform", "Short", (250, 33, 12), 7, 5,
     -0.5),
    ("fused_sketch_colmajor", (40, 300), "Gaussian", "Short", (33, 250, 12),
     5, 7, 1.0),
    ("fused_sketch_colmajor", (500, 64), "Uniform", "Long", (497, 60, 20), 3,
     4, 0.25),
]


def _transposed(jS):
    d = jS.dist
    return rb.DenseSkOp(rb.DenseDist(d.n_cols, d.n_rows, d.family,
                                     d.major_axis), jS.seed_state)


@pytest.mark.parametrize("kernel,shape,family,major,dmn,ro_s,co_s,alpha",
                         TRANSPOSED_CASES)
def test_grad_is_the_other_kernel_on_the_transposed_dist(
        kernel, shape, family, major, dmn, ro_s, co_s, alpha):
    jS, tS = _ops(shape, family, major, key=3)
    d, m, n = dmn
    A = _data((m, n), seed=m)
    G = _data((d, n), seed=d)
    other = (jfs.fused_sketch_colmajor if kernel == "fused_sketch"
             else jfs.fused_sketch)
    want = other(_transposed(jS), G, alpha=alpha, interpret=True, rows_s=m,
                 cols_s=d, ro_s=co_s, co_s=ro_s)
    got = _port_grad(getattr(tfs, kernel), tS, A, G, alpha=alpha, rows_s=d,
                     cols_s=m, ro_s=ro_s, co_s=co_s)
    _close(got.numpy(), want)
    # the gradient is the bf16-operand product: the filled block's float32
    # product is more than 10x the limit away
    blk = tS.submat(d, m, ro_s, co_s, device="cpu")
    f32 = alpha * (blk.T @ torch.from_numpy(G))
    assert np.abs(f32.numpy() - np.asarray(want)).max() \
        > 10 * TOL * np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("kernel,shape", [("fused_sketch", (16, 64)),
                                          ("fused_sketch_colmajor", (64, 16))])
def test_bf16_data_gets_a_bf16_grad(kernel, shape):
    jS, tS = _ops(shape, key=7)
    A = _data((shape[1], 8), seed=7)
    G = _data((shape[0], 8), seed=8)
    a = torch.from_numpy(A).to(torch.bfloat16).requires_grad_()
    B = getattr(tfs, kernel)(tS, a)
    assert B.dtype == torch.bfloat16
    (grad,) = torch.autograd.grad((B.float() * torch.from_numpy(G)).sum(), a)
    assert grad.dtype == torch.bfloat16
    jfn = getattr(jfs, kernel)
    want = jax.grad(lambda x: jnp.sum(
        jfn(jS, x, interpret=True).astype(jnp.float32) * G))(
            jnp.asarray(A, dtype=jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    # bf16 gradients: one bf16 ulp (2^-8) of slack
    _close(grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
           atol=1e-2)


@pytest.mark.parametrize("side,op_s,shape,a_shape,route", [
    ("left", "N", (16, 256), (256, 8), "left_fused"),
    ("left", "N", (256, 16), (16, 8), "left_colmajor_fused"),
    ("left", "T", (256, 16), (256, 8), "left_trans_fused"),
    ("right", "N", (256, 16), (8, 256), "right_fused"),
])
def test_grad_through_sketch_general_forced_fused(side, op_s, shape, a_shape,
                                                  route):
    _, tS = _ops(shape, key=5)
    A = _data(a_shape, seed=5)
    a = torch.from_numpy(A).requires_grad_()
    tskge.route_counts.clear()
    with rt.flags(use_fused=True):
        B = rt.sketch_general(tS, a, side=side, op_s=op_s, alpha=0.5)
    assert tskge.route_counts == {route: 1}
    assert B.grad_fn is not None
    G = torch.from_numpy(_data(tuple(B.shape), seed=6))
    (grad,) = torch.autograd.grad((B * G).sum(), a)
    # the staged route's gradient: float32 products of the filled block
    a2 = torch.from_numpy(A).requires_grad_()
    B2 = rt.sketch_general(tS, a2, side=side, op_s=op_s, alpha=0.5)
    assert tskge.route_counts[f"{side}_staged"] == 1
    (want,) = torch.autograd.grad((B2 * G).sum(), a2)
    _close(grad.numpy(), want.numpy(), atol=2e-2)


def test_backward_saves_neither_the_data_nor_the_operator():
    _, tS = _ops((16, 256))
    a = torch.ones(256, 8, requires_grad=True)
    B = tfs.fused_sketch(tS, a, rows_s=12, ro_s=2)
    assert B.grad_fn.call == (tS.dist, tS.seed_state, 1.0, 12, 256, 2, 0)
    assert B.grad_fn.saved_tensors == ()
    # first-order reverse mode only, as the JAX package's custom_vjp
    w = torch.ones_like(B, requires_grad=True)
    (g,) = torch.autograd.grad(B, a, grad_outputs=w, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
