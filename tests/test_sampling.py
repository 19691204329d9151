"""Gates for the Kaiser-windowed-sinc off-grid sampling operators
(JetPackWaveFD's Hicks-interpolation equivalent, built as matmuls)."""
import jax
import jax.numpy as jnp
import numpy as np

import jets_tpu as jt
from jets_tpu.core.verify import materialize
from jets_tpu.ops.sampling import (
    kaiser_sinc_matrix,
    sinc_point_sampling_operator,
    sinc_sampling_operator,
)


def test_on_grid_rows_are_one_hot():
    W = np.asarray(kaiser_sinc_matrix(16, [3.0, 7.0, 12.0], radius=4,
                                      dtype=jnp.float64))
    expect = np.zeros((3, 16))
    expect[0, 3] = expect[1, 7] = expect[2, 12] = 1.0
    np.testing.assert_allclose(W, expect, atol=1e-12)


def test_fractional_sampling_accuracy():
    # bandlimited signal sampled at half-integer offsets: r=4 Kaiser sinc
    # should reconstruct to ~1e-3 relative (Hicks 2002 design point)
    n = 128
    t = np.arange(n)
    f = lambda x: np.sin(2 * np.pi * 3.7 * x / n) + 0.5 * np.cos(  # noqa
        2 * np.pi * 7.3 * x / n)
    u = jnp.asarray(f(t), jnp.float64)
    coords = np.linspace(20.25, 100.75, 37)
    W = kaiser_sinc_matrix(n, coords, radius=4, dtype=jnp.float64)
    got = np.asarray(W @ u)
    np.testing.assert_allclose(got, f(coords), atol=2e-3)


def test_separable_operator_gates_and_exactness():
    sp = jt.Space((20, 24), jnp.float64)
    A = sinc_sampling_operator(sp, [np.array([2.0, 5.5, 11.0]),
                                    np.array([1.0, 7.25, 13.0, 20.5])])
    assert A.rng.shape == (3, 4)
    m = sp.randn(jax.random.PRNGKey(0))
    d = A.rng.randn(jax.random.PRNGKey(1))
    lhs, rhs = jt.dot_product_test(A, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    # integer coordinates hit grid points exactly
    out = A(m)
    np.testing.assert_allclose(float(out[0, 0]), float(m[2, 1]), atol=1e-12)
    np.testing.assert_allclose(float(out[2, 2]), float(m[11, 13]),
                               atol=1e-12)


def test_point_sampling_matches_separable_tensor_product():
    sp = jt.Space((14, 17), jnp.float64)
    pts = np.array([[3.25, 4.5], [7.0, 10.75], [11.5, 2.0]])
    P = sinc_point_sampling_operator(sp, pts)
    m = sp.randn(jax.random.PRNGKey(2))
    got = np.asarray(P(m))
    # ground truth: separate row contractions per point
    Wz = np.asarray(kaiser_sinc_matrix(14, pts[:, 0], dtype=jnp.float64))
    Wx = np.asarray(kaiser_sinc_matrix(17, pts[:, 1], dtype=jnp.float64))
    mm = np.asarray(m)
    expect = np.array([Wz[k] @ mm @ Wx[k] for k in range(3)])
    np.testing.assert_allclose(got, expect, rtol=1e-12)
    d = P.rng.randn(jax.random.PRNGKey(3))
    lhs, rhs = jt.dot_product_test(P, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_point_sampling_3d_and_materialize_adjoint():
    sp = jt.Space((6, 7, 8), jnp.float64)
    pts = np.array([[2.5, 3.0, 4.25], [1.0, 5.5, 6.0]])
    P = sinc_point_sampling_operator(sp, pts)
    M = np.asarray(materialize(P))
    assert M.shape == (2, 6 * 7 * 8)
    m = sp.randn(jax.random.PRNGKey(4))
    np.testing.assert_allclose(
        np.asarray(P(m)), M @ np.asarray(m).ravel(), rtol=1e-12)
