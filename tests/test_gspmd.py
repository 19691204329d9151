"""GSPMD 2-D mesh (block × grid): the vmap-path operator + jitted solvers,
partitioned purely by input shardings, match the unsharded run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.parallel.gspmd import (
    make_mesh_2d,
    shard_data,
    shard_model,
)
from jets_tpu.solvers import cgls, lsqr

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_forward_adjoint_match_on_2d_mesh():
    mesh = make_mesh_2d(4, 2)
    A, m_true, d_obs = make_seismic_problem((16, 16), 8, 32, seed=3,
                                            dtype=jnp.float64)
    # shard inputs; operator itself stays the vmap (mesh=None) path
    m_sh = shard_model(m_true, mesh)
    d0 = A(m_true)
    fwd = jax.jit(lambda op, m: op(m))
    d1 = fwd(A, m_sh)
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-12)

    adj = jax.jit(lambda op, d: op.H(d))
    a0 = adj(A, d_obs)
    a1 = adj(A, shard_data(d_obs, mesh))
    np.testing.assert_allclose(np.asarray(a0), np.asarray(a1), rtol=1e-12)


def test_lsqr_on_2d_mesh_matches_unsharded():
    mesh = make_mesh_2d(4, 2)
    A, m_true, d_obs = make_seismic_problem((16, 16), 8, 32, seed=4,
                                            noise=0.02, dtype=jnp.float64)
    r0 = lsqr(A, d_obs, maxiter=25, tol=0.0)
    r1 = lsqr(A, shard_data(d_obs, mesh), maxiter=25, tol=0.0)
    bnorm = float(A.rng.norm(d_obs))
    assert abs(float(r0.resnorm) - float(r1.resnorm)) < 1e-9 * bnorm
    np.testing.assert_allclose(np.asarray(r0.x), np.asarray(r1.x),
                               rtol=1e-6, atol=1e-9)


def test_3d_grid_sharded_cgls():
    """3-D model grid sharded over the grid axis (config #5 shape)."""
    mesh = make_mesh_2d(2, 4)
    A, m_true, d_obs = make_seismic_problem((8, 10, 6), 4, 24, seed=5,
                                            noise=0.02, dtype=jnp.float64)
    r0 = cgls(A, d_obs, maxiter=15, tol=0.0)
    r1 = cgls(A, shard_data(d_obs, mesh), x0=shard_model(A.dom.zeros(), mesh),
              maxiter=15, tol=0.0)
    np.testing.assert_allclose(np.asarray(r0.x), np.asarray(r1.x),
                               rtol=1e-6, atol=1e-9)


def test_grid_sharded_wave_propagator_parity_and_halo():
    """GRID-AXIS sharding of the 3-D wave propagator (the model-larger-
    than-one-chip axis of BASELINE config #5): with the velocity and the
    scan-carry wavefields sharded over a 'grid' mesh axis, XLA/GSPMD
    partitions the leapfrog — forward, autodiff gradient AND the stored
    int8 adjoint match the unsharded run, and the compiled forward
    actually contains halo-exchange collectives (not a replicated
    fallback)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jets_tpu.ops.wave import wave_propagator
    from jets_tpu.parallel.sharded import make_block_mesh

    shape = (16, 8, 16)
    mesh = make_block_mesh(8, axis="grid")  # Auto axes: GSPMD-inferred
    ws = NamedSharding(mesh, P("grid"))
    src = int(np.ravel_multi_index((8, 4, 8), shape))
    rcv = jnp.asarray([np.ravel_multi_index((8, 4, x), shape)
                       for x in range(16)], jnp.int32)
    kw = dict(nt=14, dt=8e-4, dx=10.0, freq=18.0, src_idx=src,
              rcv_idx=rcv, sponge_width=3, dtype=jnp.float32)
    F0 = wave_propagator(shape, **kw)
    Fs = wave_propagator(shape, wavefield_sharding=ws, **kw)

    c_host = jnp.full(shape, 1500.0, jnp.float32) + 20.0 * \
        jax.random.normal(jax.random.PRNGKey(9), shape, jnp.float32)
    c_sh = jax.device_put(c_host, ws)

    fwd = jax.jit(lambda c: Fs(c))
    d_sh = fwd(c_sh)
    d0 = F0(c_host)
    assert float(jnp.max(jnp.abs(d0))) > 0.0, "vacuous"
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d0),
                               rtol=2e-6, atol=1e-30)

    # the compiled partitioned program must move halos, not replicate:
    # look for halo-exchange collectives in the optimized HLO
    txt = fwd.lower(c_sh).compile().as_text()
    assert ("collective-permute" in txt or "all-gather" in txt), \
        "no halo-exchange collectives — wavefield silently replicated?"

    # autodiff gradient through the sharded scan
    g_sh = jax.jit(jax.grad(lambda c: jnp.sum(Fs(c) ** 2)))(c_sh)
    g0 = jax.grad(lambda c: jnp.sum(F0(c) ** 2))(c_host)
    scale = float(jnp.max(jnp.abs(g0)))
    assert scale > 0.0
    np.testing.assert_allclose(np.asarray(g_sh) / scale,
                               np.asarray(g0) / scale, rtol=0, atol=1e-5)

    # stored-wavefield adjoint with a grid-sharded history
    Fss = wave_propagator(shape, wavefield_sharding=ws,
                          store_adjoint="f32", **kw)
    F0s = wave_propagator(shape, store_adjoint="f32", **kw)
    d = F0.rng.randn(jax.random.PRNGKey(10)).astype(jnp.float32)
    a_sh = jax.jit(lambda dd: Fss.linearize(c_sh).H(dd))(d)
    a0 = F0s.linearize(c_host).H(d)
    s2 = float(jnp.max(jnp.abs(a0)))
    assert s2 > 0.0
    np.testing.assert_allclose(np.asarray(a_sh) / s2,
                               np.asarray(a0) / s2, rtol=0, atol=1e-5)


def test_grid_sharded_multishot_block_by_grid():
    """2-D mesh: shots over 'block' × model grid over 'grid' for the full
    wave multishot (vmap path, GSPMD-partitioned) — forward and derived
    adjoint match unsharded."""
    from jets_tpu.ops.wave import multishot_wave_operator

    grid = (16, 16)
    srcs = jnp.array([16 * 8 + 2, 16 * 8 + 6, 16 * 8 + 10, 16 * 8 + 13])
    kw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float32)
    F = multishot_wave_operator(grid, srcs, **kw)  # vmap path, no mesh
    mesh2 = make_mesh_2d(4, 2)
    c = jnp.full(grid, 1500.0, jnp.float32)
    c_sh = shard_model(c, mesh2)
    d0 = F(c)
    assert float(jnp.max(jnp.abs(d0))) > 0.0
    d_sh = jax.jit(lambda cc: F(cc))(c_sh)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d0),
                               rtol=2e-6, atol=1e-30)
    J = F.linearize(c)
    a0 = J.H(d0)
    a_sh = jax.jit(lambda dd: F.linearize(c_sh).H(dd))(shard_data(d0, mesh2))
    s = float(jnp.max(jnp.abs(a0)))
    np.testing.assert_allclose(np.asarray(a_sh) / s, np.asarray(a0) / s,
                               rtol=0, atol=1e-5)


def test_grid_sharded_vti_propagator_parity_and_halo():
    """GRID-AXIS sharding of the coupled VTI propagator: both wavefields
    (and the stored two-field history) shard over the mesh; forward,
    stored adjoint and halo collectives gated as for the isotropic case."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jets_tpu.ops.wave import vti_wave_propagator
    from jets_tpu.parallel.sharded import make_block_mesh

    shape = (16, 8, 16)
    mesh = make_block_mesh(8, axis="grid")
    ws = NamedSharding(mesh, P("grid"))
    src = int(np.ravel_multi_index((8, 4, 8), shape))
    rcv = jnp.asarray([np.ravel_multi_index((8, 4, x), shape)
                       for x in range(16)], jnp.int32)
    kw = dict(nt=14, dt=8e-4, dx=10.0, freq=18.0, src_idx=src,
              rcv_idx=rcv, sponge_width=3, dtype=jnp.float32)
    F0 = vti_wave_propagator(shape, **kw)
    Fs = vti_wave_propagator(shape, wavefield_sharding=ws, **kw)

    full = lambda v: jnp.full(shape, v, jnp.float32)  # noqa: E731
    m0 = (F0.dom.zeros().setblock(0, full(1500.0))
          .setblock(1, full(0.1)).setblock(2, full(0.05)))
    m_sh = jax.tree_util.tree_map(
        lambda x: x, m0)  # same values; velocity block device_put sharded
    m_sh = m_sh.setblock(0, jax.device_put(m0.getblock(0), ws))

    fwd = jax.jit(lambda m: Fs(m))
    d_sh = fwd(m_sh)
    d0 = F0(m0)
    assert float(jnp.max(jnp.abs(d0))) > 0.0, "vacuous"
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d0),
                               rtol=2e-6, atol=1e-30)
    txt = fwd.lower(m_sh).compile().as_text()
    assert ("collective-permute" in txt or "all-gather" in txt), \
        "no halo-exchange collectives — wavefields silently replicated?"

    # stored two-field history adjoint, grid-sharded
    Fss = vti_wave_propagator(shape, wavefield_sharding=ws,
                              store_adjoint="f32", **kw)
    F0s = vti_wave_propagator(shape, store_adjoint="f32", **kw)
    d = F0.rng.randn(jax.random.PRNGKey(11)).astype(jnp.float32)
    a_sh = jax.jit(lambda dd: Fss.linearize(m_sh).H(dd))(d)
    a0 = F0s.linearize(m0).H(d)
    for b in range(3):
        x = np.asarray(a0.getblock(b))
        s = np.asarray(a_sh.getblock(b))
        sc = float(np.max(np.abs(x)))
        assert sc > 0.0, f"vacuous adjoint block {b}"
        np.testing.assert_allclose(s / sc, x / sc, rtol=0, atol=1e-5)


def test_grid_sharded_tti_propagator_parity():
    """GRID-AXIS sharding of the 3-D TTI propagator (the heaviest physics
    on the model-larger-than-one-chip axis): forward + stored adjoint
    parity vs unsharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jets_tpu.ops.wave import tti_wave_propagator
    from jets_tpu.parallel.sharded import make_block_mesh

    shape = (16, 8, 16)
    mesh = make_block_mesh(8, axis="grid")
    ws = NamedSharding(mesh, P("grid"))
    src = int(np.ravel_multi_index((8, 4, 8), shape))
    rcv = jnp.asarray([np.ravel_multi_index((8, 4, x), shape)
                       for x in range(16)], jnp.int32)
    kw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, src_idx=src,
              rcv_idx=rcv, sponge_width=3, dtype=jnp.float32)
    F0 = tti_wave_propagator(shape, **kw)
    Fs = tti_wave_propagator(shape, wavefield_sharding=ws, **kw)
    with pytest.raises(ValueError, match="3-D only"):
        tti_wave_propagator((16, 16), wavefield_sharding=ws, nt=8)

    full = lambda v: jnp.full(shape, v, jnp.float32)  # noqa: E731
    m0 = F0.dom.zeros()
    for b, v in enumerate((1500.0, 0.1, 0.05, 0.2, 0.7)):
        m0 = m0.setblock(b, full(v))
    m_sh = m0.setblock(0, jax.device_put(m0.getblock(0), ws))

    d_sh = jax.jit(lambda m: Fs(m))(m_sh)
    d0 = F0(m0)
    assert float(jnp.max(jnp.abs(d0))) > 0.0
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d0),
                               rtol=2e-6, atol=1e-30)

    Fss = tti_wave_propagator(shape, wavefield_sharding=ws,
                              store_adjoint="f32", **kw)
    F0s = tti_wave_propagator(shape, store_adjoint="f32", **kw)
    d = F0.rng.randn(jax.random.PRNGKey(12)).astype(jnp.float32)
    a_sh = jax.jit(lambda dd: Fss.linearize(m_sh).H(dd))(d)
    a0 = F0s.linearize(m0).H(d)
    for b in range(5):
        x = np.asarray(a0.getblock(b))
        s = np.asarray(a_sh.getblock(b))
        sc = float(np.max(np.abs(x)))
        assert sc > 0.0, f"vacuous adjoint block {b}"
        np.testing.assert_allclose(s / sc, x / sc, rtol=0, atol=1e-5)


def test_grid_sharded_multishot_vti_block_by_grid():
    """2-D mesh block×grid for the ANISOTROPIC multishot: shots over
    'block', model grid over 'grid' (vmap path, GSPMD-partitioned by
    input shardings) — forward and derived adjoint match unsharded,
    per model block."""
    from jets_tpu.ops.wave import multishot_vti_wave_operator

    grid = (16, 16)
    srcs = jnp.array([16 * 8 + 2, 16 * 8 + 6, 16 * 8 + 10, 16 * 8 + 13])
    kw = dict(nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float32)
    F = multishot_vti_wave_operator(grid, srcs, **kw)
    mesh2 = make_mesh_2d(4, 2)
    full = lambda v: jnp.full(grid, v, jnp.float32)  # noqa: E731
    m = (F.dom.zeros().setblock(0, full(1500.0))
         .setblock(1, full(0.1)).setblock(2, full(0.05)))
    m_sh = m.setblock(0, shard_model(m.getblock(0), mesh2))
    d0 = F(m)
    assert float(jnp.max(jnp.abs(d0))) > 0.0
    d_sh = jax.jit(lambda mm: F(mm))(m_sh)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d0),
                               rtol=2e-6, atol=1e-30)
    a0 = F.linearize(m).H(d0)
    a_sh = jax.jit(lambda dd: F.linearize(m_sh).H(dd))(
        shard_data(d0, mesh2))
    for b in range(3):
        x = np.asarray(a0.getblock(b))
        s = np.asarray(a_sh.getblock(b))
        sc = float(np.max(np.abs(x)))
        assert sc > 0.0, f"vacuous adjoint block {b}"
        np.testing.assert_allclose(s / sc, x / sc, rtol=0, atol=1e-5)
