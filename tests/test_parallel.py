"""Sharded stacked block operator on the virtual 8-device CPU mesh:
forward/adjoint parity with the unsharded path, psum adjoint accumulation,
and a distributed LSQR solve (BASELINE config #4, scaled down)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.models.seismic import make_seismic_operator, make_seismic_problem
from jets_tpu.parallel.sharded import (
    make_block_mesh,
    shard_blocks,
    replicate,
    stacked_block_operator,
)
from jets_tpu.solvers import cgls, lsqr


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _mini_stacked(mesh=None, nblocks=8, n=12, dtype=jnp.float64):
    """Tiny stacked operator: per block d_b = w_b * m (diagonal per shot)."""
    key = jax.random.PRNGKey(0)
    w = jax.random.normal(key, (nblocks, n), dtype)

    def df(dm, m0, bs):
        return bs["w"] * dm

    return stacked_block_operator(
        nblocks=nblocks,
        dom=jt.Space((n,), dtype),
        rng_block=jt.Space((n,), dtype),
        bstate={"w": w},
        df=df,
        mesh=mesh,
    ), w


def test_stacked_forward_adjoint_unsharded():
    A, w = _mini_stacked()
    m = A.dom.randn(jax.random.PRNGKey(1))
    d = A(m)
    np.testing.assert_allclose(d, w * m[None, :], rtol=1e-12)
    dd = A.rng.randn(jax.random.PRNGKey(2))
    np.testing.assert_allclose(A.H(dd), jnp.sum(w * dd, axis=0), rtol=1e-12)
    lhs, rhs = jt.dot_product_test(A, m, dd)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_stacked_sharded_matches_unsharded():
    mesh = make_block_mesh(8)
    A0, _ = _mini_stacked()
    A1, _ = _mini_stacked(mesh=mesh)
    m = A0.dom.randn(jax.random.PRNGKey(3))
    d0 = A0(m)
    d1 = A1(replicate(m, mesh))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-12)
    dd = A0.rng.randn(jax.random.PRNGKey(4))
    a0 = A0.H(dd)
    a1 = A1.H(shard_blocks(dd, mesh))
    np.testing.assert_allclose(np.asarray(a0), np.asarray(a1), rtol=1e-12)


def test_sharded_adjoint_gate_under_jit():
    mesh = make_block_mesh(8)
    A, _ = _mini_stacked(mesh=mesh)

    @jax.jit
    def gate(op, m, d):
        return jt.dot_product_test(op, m, d)

    m = A.dom.randn(jax.random.PRNGKey(5))
    d = A.rng.randn(jax.random.PRNGKey(6))
    lhs, rhs = gate(A, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_seismic_operator_gates():
    A = make_seismic_operator((16, 16), 8, 20, jax.random.PRNGKey(0),
                              dtype=jnp.float64)
    m = A.dom.randn(jax.random.PRNGKey(1))
    d = A.rng.randn(jax.random.PRNGKey(2))
    lhs, rhs = jt.dot_product_test(A, m, d)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_seismic_sharded_matches_unsharded():
    mesh = make_block_mesh(8)
    A0 = make_seismic_operator((12, 12), 8, 15, jax.random.PRNGKey(0),
                               dtype=jnp.float64)
    A1 = make_seismic_operator((12, 12), 8, 15, jax.random.PRNGKey(0),
                               mesh=mesh, dtype=jnp.float64)
    m = A0.dom.randn(jax.random.PRNGKey(1))
    np.testing.assert_allclose(np.asarray(A0(m)), np.asarray(A1(m)), rtol=1e-12)
    d = A0.rng.randn(jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(A0.H(d)), np.asarray(A1.H(d)),
                               rtol=1e-12)


def _all_reduce_sizes(fn, *args):
    """Element counts of the all-reduces in ``fn``'s lowered program."""
    txt = jax.jit(fn).lower(*args).as_text()
    shapes = re.findall(r"stablehlo\.all_reduce.*?\}\) : \(tensor<([^>]*)>",
                        txt, flags=re.S)
    return [int(np.prod([int(t) for t in sh.split("x")[:-1]] or [1]))
            for sh in shapes]


@pytest.mark.parametrize("impl", ["fused", "composed"])
def test_seismic_sharded_adjoint_psums_receiver_sums(impl):
    """The sharded flagship adjoint all-reduces the (nrecv,) receiver sums,
    never a model-sized array: the lift into the grid runs after the
    psum."""
    mesh = make_block_mesh(4)
    A = make_seismic_operator((32, 32), 8, 16, jax.random.PRNGKey(0),
                              mesh=mesh, dtype=jnp.float32, impl=impl)
    d = shard_blocks(A.rng.randn(jax.random.PRNGKey(1)), mesh)
    sizes = _all_reduce_sizes(lambda op, y: op.H(y), A, d)
    assert sizes == [16]


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("grid,nrecv", [((64, 64), 64), ((16, 16, 16), 27)])
def test_seismic_adjoint_stays_on_stamps(grid, nrecv, sharded):
    """Receivers sit ≥2 cells apart, so the float32 adjoint is exactly a sum
    of Laplacian stamps: at every receiver the centre is -2·nd times each
    arm, bit for bit, on one device and over the mesh. Off-stamp rounding
    would lie in the null space of A, where LSQR amplifies it."""
    mesh = make_block_mesh(8) if sharded else None
    A = make_seismic_operator(grid, 8, nrecv, jax.random.PRNGKey(2),
                              mesh=mesh, dtype=jnp.float32)
    d = A.rng.randn(jax.random.PRNGKey(3))
    if sharded:
        d = shard_blocks(d, mesh)
    z = np.asarray(A.H(d)).reshape(-1)
    rcv = np.asarray(A.jet.state["sstate"]["rcv"])
    nd = len(grid)
    strides = np.cumprod((1,) + grid[::-1])[:nd][::-1]
    assert np.all(z[rcv] != 0)
    for st in strides:
        for arm in (rcv - st, rcv + st):
            np.testing.assert_array_equal(z[rcv], -2.0 * nd * z[arm])


def test_distributed_lsqr_converges():
    """Config #4 scaled down: multi-shot LSQR on the 8-device mesh matches the
    single-device solve."""
    mesh = make_block_mesh(8)
    A0, m_true, d_obs = make_seismic_problem((12, 12), 16, 30, seed=1,
                                             dtype=jnp.float64)
    A1, _, _ = make_seismic_problem((12, 12), 16, 30, seed=1, mesh=mesh,
                                    dtype=jnp.float64)
    r0 = lsqr(A0, d_obs, maxiter=50, tol=1e-12)
    r1 = lsqr(A1, shard_blocks(d_obs, mesh), maxiter=50, tol=1e-12)
    bnorm = float(A0.rng.norm(d_obs))
    # the convergence behavior, the true residuals and the solutions agree
    assert abs(float(r0.resnorm) - float(r1.resnorm)) < 1e-3 * bnorm
    true_res0 = float(A0.rng.norm(A0(r0.x) - d_obs))
    true_res1 = float(A0.rng.norm(A0(r1.x.astype(jnp.float64)) - d_obs))
    assert abs(true_res0 - true_res1) < 1e-3 * bnorm
    # each path's phibar estimate must track ITS true residual tightly
    assert abs(true_res0 - float(r0.resnorm)) < 1e-9 * bnorm
    assert abs(true_res1 - float(r1.resnorm)) < 1e-9 * bnorm
    np.testing.assert_allclose(np.asarray(r0.x), np.asarray(r1.x), rtol=1e-9,
                               atol=1e-12 * float(np.max(np.abs(r0.x))))
    # converging at all: residual decreased substantially
    assert float(r1.resnorm) < 0.1 * bnorm


def test_seismic_fused_matches_composed():
    # the fused stamp implementation is mathematically identical to the
    # explicit S∘L composition (same stencil, same weights)
    key = jax.random.PRNGKey(9)
    Af = make_seismic_operator((24, 20), 6, 40, key, dtype=jnp.float64,
                               impl="fused")
    Ac = make_seismic_operator((24, 20), 6, 40, key, dtype=jnp.float64,
                               impl="composed")
    m = Af.dom.randn(jax.random.PRNGKey(1))
    d = Af.rng.randn(jax.random.PRNGKey(2))
    np.testing.assert_allclose(
        np.asarray(Af(m)), np.asarray(Ac(m)), rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(jt.adjoint(Af)(d)), np.asarray(jt.adjoint(Ac)(d)),
        rtol=1e-12, atol=1e-12,
    )
    lhs, rhs = jt.dot_product_test(Af, m, d)
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-12)


def test_runner_local_block_range_and_assemble():
    # single-process run: all 8 virtual devices are local, so the local
    # range is the full block range and assemble_global places every shard
    from jets_tpu.parallel.runner import assemble_global, local_block_range

    mesh = make_block_mesh(8)
    lo, hi = local_block_range(16, mesh)
    assert (lo, hi) == (0, 16)
    data = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = assemble_global(data[lo:hi], (16, 3), mesh)
    assert arr.shape == (16, 3)
    np.testing.assert_array_equal(np.asarray(arr), data)
    # sharded over the block axis
    assert len(arr.sharding.device_set) == 8

    with pytest.raises(ValueError):
        local_block_range(15, mesh)  # not divisible


def test_distributed_chebyshev_reduction_free_solve():
    """Chebyshev on the sharded normal operator matches the single-device
    solve: the inner recurrence has NO collectives at all (the multi-host
    scaling solver), yet converges identically to CG-grade accuracy."""
    from jets_tpu.solvers import chebyshev, normal_operator
    mesh = make_block_mesh(8)
    A0, m_true, d_obs = make_seismic_problem((12, 12), 16, 30, seed=5,
                                             dtype=jnp.float64)
    A1, _, _ = make_seismic_problem((12, 12), 16, 30, seed=5, mesh=mesh,
                                    dtype=jnp.float64)
    N0 = normal_operator(A0, damp=0.5)
    N1 = normal_operator(A1, damp=0.5)
    b0 = A0.adjoint_apply(d_obs)
    b1 = A1.adjoint_apply(shard_blocks(d_obs, mesh))
    from jets_tpu.solvers import estimate_spectral_bounds
    lmin, lmax = estimate_spectral_bounds(N0)
    # damp=0.5 ⇒ the damped normal operator's spectrum has the exact
    # analytic floor damp² = 0.25; prefer it over the (deliberately
    # deflated) power-iteration estimate, per the chebyshev docstring
    lmin = max(float(lmin), 0.5**2)
    r0 = chebyshev(N0, b0, lmin, float(lmax), maxiter=200, tol=1e-10,
                   check_every=10)
    r1 = chebyshev(N1, b1, lmin, float(lmax), maxiter=200, tol=1e-10,
                   check_every=10)
    np.testing.assert_allclose(np.asarray(r0.x), np.asarray(r1.x),
                               rtol=1e-6, atol=1e-9)
    res0 = float(N0.dom.norm(N0(r0.x) - b0) / N0.dom.norm(b0))
    assert res0 < 1e-6


# ---------------------------------------------------------------------- #
# sequential shot mapping (lax.map) — one shot's wavefields at a time
# ---------------------------------------------------------------------- #


def test_shot_map_sequential_matches_vmap():
    """shot_map="map" (sequential lax.map over local shots — the mode that
    holds one shot's wavefields at a time) produces the same operator as the vmapped default: forward, tangent, and the
    derived psum adjoint, single-device and on the mesh."""
    import numpy as np

    from jets_tpu.ops.wave import multishot_wave_operator
    from jets_tpu.parallel.sharded import make_block_mesh

    grid = (24, 24)
    srcs = jnp.array([24 * 6 + 6, 24 * 6 + 17, 24 * 17 + 6, 24 * 17 + 17])
    kw = dict(nt=20, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float64)
    c = jnp.full(grid, 2000.0, jnp.float64)

    Fv = multishot_wave_operator(grid, srcs, **kw)
    Fm = multishot_wave_operator(grid, srcs, shot_map="map", **kw)
    dv, dm = Fv(c), Fm(c)
    assert float(jnp.max(jnp.abs(dv))) > 0
    np.testing.assert_allclose(np.asarray(dm), np.asarray(dv), rtol=1e-13)

    J = Fm.linearize(c)
    mm = J.dom.randn(jax.random.PRNGKey(61))
    dd = J.rng.randn(jax.random.PRNGKey(62))
    lhs, rhs = jt.dot_product_test(J, mm, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

    if len(jax.devices()) >= 4:
        mesh = make_block_mesh(4)
        Fs = multishot_wave_operator(grid, srcs, mesh=mesh, shot_map="map",
                                     **kw)
        np.testing.assert_allclose(np.asarray(Fs(c)), np.asarray(dv),
                                   rtol=1e-13)
        Js = Fs.linearize(c)
        lhs, rhs = jt.dot_product_test(
            Js, Js.dom.randn(jax.random.PRNGKey(63)),
            Js.rng.randn(jax.random.PRNGKey(64)))
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

    with pytest.raises(ValueError, match="shot_map"):
        multishot_wave_operator(grid, srcs, shot_map="scan", **kw)
