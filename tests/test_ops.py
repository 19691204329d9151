"""Mandatory correctness gates for every shipped operator (SURVEY §4:
the dot-product test is a CI gate for all operators)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.ops.conv import conv1d_operator, derivative_operator
from jets_tpu.ops.diagonal import diagonal_operator
from jets_tpu.ops.fft import fft_operator, rfft_operator
from jets_tpu.ops.matrix import matrix_operator
from jets_tpu.ops.stencil import blur2d_operator, laplacian_operator, stencil_operator


def _gate(A, seed=0, rtol=1e-10):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    m = A.dom.randn(k1)
    d = A.rng.randn(k2)
    lhs, rhs = jt.dot_product_test(A, m, d)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), rtol=rtol)
    l1, l2 = jt.linearity_test(A, k3)
    np.testing.assert_allclose(np.asarray(A.rng.ravel(l1)),
                               np.asarray(A.rng.ravel(l2)), rtol=1e-6, atol=1e-10)


OPERATORS = {
    "diagonal": lambda: diagonal_operator(
        jax.random.normal(jax.random.PRNGKey(1), (17,), jnp.float64)),
    "diagonal_complex": lambda: diagonal_operator(
        jt.Space((9,), jnp.complex128).randn(jax.random.PRNGKey(2))),
    "matrix": lambda: matrix_operator(
        jax.random.normal(jax.random.PRNGKey(3), (13, 7), jnp.float64)),
    "matrix_complex": lambda: matrix_operator(
        jt.Space((6, 11), jnp.complex128).randn(jax.random.PRNGKey(4))),
    "conv1d_odd": lambda: conv1d_operator(
        jnp.array([1.0, -2.0, 3.0, -2.0, 1.0]), 50, jnp.float64),
    "conv1d_even": lambda: conv1d_operator(
        jnp.array([1.0, -2.0, 3.0, 1.0]), 33, jnp.float64),
    "derivative": lambda: derivative_operator(40, 0.1, jnp.float64),
    "fft2d": lambda: fft_operator(jt.Space((8, 8), jnp.complex128)),
    "rfft_even": lambda: rfft_operator(jt.Space((16,), jnp.float64)),
    "rfft_odd": lambda: rfft_operator(jt.Space((15,), jnp.float64)),
    "rfft_2d": lambda: rfft_operator(jt.Space((6, 10), jnp.float64)),
    "blur2d": lambda: blur2d_operator((24, 24), 2, jnp.float64),
    "laplacian3d": lambda: laplacian_operator((6, 7, 8), jnp.float64),
    "stencil1d": lambda: stencil_operator(
        jt.Space((30,), jnp.float64), jnp.array([1.0, -2.0, 1.0])),
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_gates(name):
    _gate(OPERATORS[name]())


def test_fft_unitary():
    A = fft_operator(jt.Space((16,), jnp.complex128))
    m = A.dom.randn(jax.random.PRNGKey(5))
    np.testing.assert_allclose(A.H(A(m)), m, rtol=1e-12, atol=1e-12)
    # Parseval w.r.t. the space norms
    np.testing.assert_allclose(float(A.rng.norm(A(m))), float(A.dom.norm(m)),
                               rtol=1e-12)


def test_rfft_parseval_symmetric_space():
    """The symmetric space's weighted norm reproduces the full-spectrum norm
    (the reference's doubled-norm semantics, test/runtests.jl:243-248)."""
    A = rfft_operator(jt.Space((32,), jnp.float64))
    m = A.dom.randn(jax.random.PRNGKey(6))
    d = A(m)
    np.testing.assert_allclose(float(A.rng.norm(d)), float(A.dom.norm(m)),
                               rtol=1e-12)


@pytest.mark.parametrize("L", [2, 3, 4, 5, 6, 9])
def test_conv1d_matches_numpy_same(L):
    """'same' forward semantics vs numpy for even AND odd kernel lengths
    (the even case is where asymmetric-pad bookkeeping can silently flip:
    the adjoint stays consistent but the forward crop lands off by one)."""
    rng = np.random.default_rng(L)
    n = 21
    k = rng.standard_normal(L)
    A = conv1d_operator(jnp.asarray(k), n, jnp.float64)
    x = rng.standard_normal(n)
    got = np.asarray(A(jnp.asarray(x)))
    want = np.convolve(x, k, mode="same")
    np.testing.assert_allclose(got, want, atol=1e-12)
    _gate(A, seed=L)


def test_derivative_matches_dense():
    n = 12
    D = derivative_operator(n, 1.0, jnp.float64)
    M = jt.materialize(D)
    dense = np.zeros((n, n))
    for i in range(n - 1):
        dense[i, i] = -1.0
        dense[i, i + 1] = 1.0
    np.testing.assert_allclose(M, dense)


def test_deconv_chain_lsqr():
    """BASELINE config #2 (scaled down): A = D ∘ S deconvolution by LSQR."""
    from jets_tpu.solvers import lsqr

    n = 200
    wavelet = jnp.exp(-0.5 * ((jnp.arange(9, dtype=jnp.float64) - 4) / 1.5) ** 2)
    S = conv1d_operator(wavelet, n, jnp.float64)
    D = derivative_operator(n, 1.0, jnp.float64)
    A = D @ S
    key = jax.random.PRNGKey(7)
    x_true = jnp.zeros((n,), jnp.float64).at[
        jax.random.randint(key, (8,), 10, n - 10)
    ].set(1.0)
    b = A(x_true)
    res = lsqr(A, b, maxiter=200, tol=1e-12)
    # D∘S is severely ill-conditioned (smooth wavelet): assert solid relative
    # residual reduction rather than machine-precision data fit
    rel = float(A.rng.norm(A(res.x) - b)) / float(A.rng.norm(b))
    assert rel < 5e-3
    # and the residual history is monotonically non-increasing
    h = np.asarray(res.history)[: int(res.iterations)]
    assert np.all(np.diff(h) <= 1e-12)


def test_transform_operator_gates():
    from jets_tpu.ops.transforms import (
        dct_operator, identity_operator, pad_operator, restriction_operator)

    ops = {
        "dct2d": dct_operator(jt.Space((12, 10), jnp.float64)),
        "identity": identity_operator(jt.Space((9,), jnp.float64)),
        "pad": pad_operator(jt.Space((6, 7), jnp.float64), [(1, 2), (0, 3)]),
        "restrict": restriction_operator(jt.Space((10, 8), jnp.float64),
                                         [(2, 9), (1, 8)]),
    }
    for name, A in ops.items():
        _gate(A)
    # dct unitary round trip
    D = ops["dct2d"]
    m = D.dom.randn(jax.random.PRNGKey(9))
    np.testing.assert_allclose(np.asarray(D.H(D(m))), np.asarray(m),
                               rtol=1e-10, atol=1e-12)
    # pad/restrict mutual adjoints materialize as transposes
    P = ops["pad"]
    MP = jt.materialize(P)
    MPH = jt.materialize(P.H)
    np.testing.assert_allclose(np.asarray(MP).T, np.asarray(MPH))
