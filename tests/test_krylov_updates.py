"""The Krylov solvers' vector updates and the 3-D Laplacian they run
against, at grid shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.ops.matrix import matrix_operator
from jets_tpu.ops.stencil import laplacian_nd, laplacian_operator
from jets_tpu.models.seismic import make_seismic_operator
from jets_tpu.solvers import cg, lsmr, lsqr


def _fields(shape, n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [jax.random.normal(k, shape, jnp.float64) for k in keys]


@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
@pytest.mark.parametrize("grid", [(6, 5, 7), (9, 10)])
def test_least_squares_updates_match_scipy(solver, grid):
    """LSQR's x/w and LSMR's x/h/hbar updates on a grid-shaped model:
    iteration for iteration, the iterate equals scipy's on the dense
    matrix of the same operator."""
    import scipy.sparse.linalg as spla

    A = make_seismic_operator(grid, 4, 6, jax.random.PRNGKey(3),
                              dtype=jnp.float64)
    n = A.dom.size
    K = np.asarray(jt.materialize(A)).reshape(-1, n)
    b = np.asarray(_fields((K.shape[0],), 1, seed=4)[0])
    iters = 5
    if solver == "lsqr":
        got = lsqr(A, jnp.asarray(b.reshape(A.rng.shape)), maxiter=iters,
                   tol=0.0)
        want = spla.lsqr(K, b, atol=0.0, btol=0.0, conlim=1e300,
                         iter_lim=iters)[0]
    else:
        got = lsmr(A, jnp.asarray(b.reshape(A.rng.shape)), maxiter=iters,
                   tol=0.0)
        want = spla.lsmr(K, b, atol=0.0, btol=0.0, conlim=1e300,
                         maxiter=iters)[0]
    assert np.linalg.norm(want) > 0
    np.testing.assert_allclose(np.asarray(got.x).reshape(-1), want,
                               rtol=1e-9, atol=1e-12 * np.abs(want).max())


def test_cg_on_3d_grid_matches_dense_solve():
    """CG (x/r/p updates fused by XLA) on the SPD operator 4·I − ∇²/8 over
    a 3-D grid reaches the dense solution."""
    shape = (6, 5, 7)
    n = int(np.prod(shape))
    L = laplacian_operator(shape, jnp.float64)
    M = np.asarray(jt.materialize(L)).reshape(n, n)
    K = 4.0 * np.eye(n) - M / 8.0
    op = matrix_operator(jnp.asarray(K))
    b = np.asarray(_fields((n,), 1, seed=2)[0])
    res = cg(op, jnp.asarray(b), maxiter=200, tol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(K, b),
                               rtol=1e-9, atol=1e-11)
    h = np.asarray(res.history)[: int(res.iterations)]
    assert h[-1] < 1e-10 * np.linalg.norm(b)


@pytest.mark.parametrize("order", [2, 4, 8])
def test_laplacian_operator_orders(order):
    shape = (9, 8, 10)
    L = laplacian_operator(shape, jnp.float64, order=order)
    m = L.dom.randn(jax.random.PRNGKey(order))
    np.testing.assert_array_equal(np.asarray(L(m)),
                                  np.asarray(laplacian_nd(m, order=order)))
    lhs, rhs = jt.dot_product_test(L, m, L.rng.randn(jax.random.PRNGKey(9)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_laplacian_operator_rejects_bad_order_and_impl():
    with pytest.raises(ValueError, match="order"):
        laplacian_operator((8, 8), jnp.float32, order=6)
    with pytest.raises(TypeError):
        laplacian_operator((8, 8, 8), jnp.float32, impl="pallas")
