"""Gates for the deepened wave-equation pack (JetPackWaveFD-depth physics:
higher-order stencils, CPML boundaries, variable density, ginsu windows).

Every new operator passes the framework's mandatory gates
(dot-product / linearization, reference ``src/Jets.jl:1211-1266``) plus a
physics check specific to the feature (accuracy order, boundary
reflectivity, flux symmetry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.core.verify import materialize
from jets_tpu.ops.stencil import laplacian_nd, laplacian_operator
from jets_tpu.ops.wave import (
    born_operator,
    cpml_wave_propagator,
    multishot_wave_operator,
    vd_wave_propagator,
    wave_propagator,
)


# ---------------------------------------------------------------------- #
# higher-order Laplacians
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("order", [4, 8])
def test_high_order_laplacian_self_adjoint(order):
    A = laplacian_operator((12, 13), jnp.float64, order=order)
    m = A.dom.randn(jax.random.PRNGKey(0))
    d = A.rng.randn(jax.random.PRNGKey(1))
    lhs, rhs = jt.dot_product_test(A, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)
    # symmetric taps + zero boundary => the dense matrix is symmetric
    M = np.asarray(materialize(A))
    np.testing.assert_allclose(M, M.T, rtol=0, atol=0)


def test_laplacian_order_of_accuracy():
    n = 400
    h = 1.0 / n
    t = (jnp.arange(n, dtype=jnp.float64) + 0.5) * h
    g = lambda t: jnp.exp(-(((t - 0.5) / 0.1) ** 2))  # noqa: E731
    f = g(t)
    exact = jax.vmap(jax.grad(jax.grad(g)))(t)
    errs = {}
    for order, hw in [(2, 1), (4, 2), (8, 4)]:
        num = laplacian_nd(f, order=order) / h**2
        sl = slice(hw + 4, -(hw + 4))
        errs[order] = float(jnp.max(jnp.abs(num[sl] - exact[sl])))
    assert errs[4] < 1e-2 * errs[2]
    assert errs[8] < 1e-4 * errs[4]


def test_order2_default_unchanged():
    # the flagship's fused/composed bit-exactness depends on the default
    # path producing the exact original floating-point summation order
    x = jax.random.normal(jax.random.PRNGKey(0), (17, 23))
    xp = jnp.pad(x, 1)
    old = (-2.0 * 2) * x
    for ax in range(2):
        lo = tuple(slice(0, -2) if i == ax else slice(1, -1)
                   for i in range(2))
        hi = tuple(slice(2, None) if i == ax else slice(1, -1)
                   for i in range(2))
        old = old + xp[lo] + xp[hi]
    assert bool(jnp.all(old == laplacian_nd(x)))


def test_high_order_propagator_gates():
    F = wave_propagator(
        (24, 24), nt=48, dt=0.0006, dx=10.0, freq=18.0,
        src_idx=24 * 12 + 12, sponge_width=4, space_order=8,
        dtype=jnp.float64,
    )
    c0 = jnp.full((24, 24), 2000.0, jnp.float64)
    assert float(jnp.max(jnp.abs(F(c0)))) > 0
    J = born_operator(F, c0)
    m = J.dom.randn(jax.random.PRNGKey(0))
    d = J.rng.randn(jax.random.PRNGKey(1))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


# ---------------------------------------------------------------------- #
# CPML absorbing boundaries
# ---------------------------------------------------------------------- #


def _boundary_energy(prop_kind, grid=(64, 64), width=10):
    """Fire a pulse at the center, run long enough for the wavefront to hit
    the boundary and reflect back, then measure the energy left in the
    interior — pure leftover = reflections (+ residual coda)."""
    n = grid[0]
    kw = dict(nt=300, dt=0.001, dx=10.0, freq=15.0,
              src_idx=n * (n // 2) + n // 2,
              rcv_idx=jnp.arange(n * n, dtype=jnp.int32),
              dtype=jnp.float64)
    if prop_kind == "cpml":
        F = cpml_wave_propagator(grid, pml_width=width, cmax=2000.0, **kw)
    else:
        F = wave_propagator(grid, sponge_width=width, **kw)
    c = jnp.full(grid, 2000.0, jnp.float64)
    traces = F(c)  # (nt, n*n) full wavefield snapshots
    # incident amplitude: the strongest wavefield value ever seen
    peak = float(jnp.max(jnp.abs(traces)))
    # after ~2 crossings everything should have left the domain
    final = traces[-1].reshape(grid)
    inner = final[width + 4:-(width + 4), width + 4:-(width + 4)]
    return float(jnp.max(jnp.abs(inner))) / peak


def test_cpml_absorbs_better_than_sponge():
    # measured: cpml 0.0014, sponge 0.148 at these settings
    r_cpml = _boundary_energy("cpml")
    r_sponge = _boundary_energy("sponge")
    assert r_cpml < 5e-3              # <0.5% residual reflection amplitude
    assert r_cpml < 0.05 * r_sponge   # and beats the sponge by >20x


def test_cpml_born_dot_product_gate():
    F = cpml_wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, pml_width=4, cmax=2500.0, dtype=jnp.float64,
    )
    c0 = jnp.full((20, 20), 2000.0, jnp.float64)
    J = born_operator(F, c0)
    m = J.dom.randn(jax.random.PRNGKey(2))
    d = J.rng.randn(jax.random.PRNGKey(3))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_cpml_linearization_taylor_decay():
    F = cpml_wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, pml_width=4, cmax=2500.0, dtype=jnp.float64,
    )
    c0 = jnp.full((20, 20), 2000.0, jnp.float64)
    dm = 50.0 * jt.Space((20, 20), jnp.float64).randn(jax.random.PRNGKey(4))
    obs, exp = jt.linearization_test(F, c0, delta_m=dm,
                                     mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(np.asarray(obs), np.asarray(exp), rtol=0.35)


# ---------------------------------------------------------------------- #
# variable density (two-parameter block domain)
# ---------------------------------------------------------------------- #


def _vd_propagator():
    return vd_wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64,
    )


def _vd_point():
    c = jnp.full((20, 20), 2000.0, jnp.float64)
    b = jnp.full((20, 20), 1.0 / 1000.0, jnp.float64)  # rho = 1000
    m = _vd_propagator().dom.zeros()
    return m.setblock(0, c).setblock(1, b)


def test_vd_block_domain_and_signal():
    F = _vd_propagator()
    from jets_tpu.core.blockspace import BlockSpace

    assert isinstance(F.dom, BlockSpace)
    d = F(_vd_point())
    assert d.shape == F.rng.shape
    assert float(jnp.max(jnp.abs(d))) > 0


def test_vd_jacobian_dot_product_gate():
    F = _vd_propagator()
    J = F.linearize(_vd_point())
    m = J.dom.randn(jax.random.PRNGKey(5))
    d = J.rng.randn(jax.random.PRNGKey(6))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_vd_linearization_taylor_decay():
    F = _vd_propagator()
    m0 = _vd_point()
    dm = F.dom.randn(jax.random.PRNGKey(7))
    dm = dm.setblock(0, 50.0 * dm.getblock(0))
    dm = dm.setblock(1, 1e-5 * dm.getblock(1))
    obs, exp = jt.linearization_test(F, m0, delta_m=dm,
                                     mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(np.asarray(obs), np.asarray(exp), rtol=0.35)


def test_div_b_grad_is_symmetric():
    """The pinned-b spatial operator -(D+)^T diag(b)(D+) materializes to a
    symmetric (negative semidefinite) matrix."""
    from jets_tpu.core.jet import Jet, LinearOperator
    from jets_tpu.ops.wave import _div_b_grad

    sp = jt.Space((6, 7), jnp.float64)
    b = 0.5 + jt.Space((6, 7), jnp.float64).rand(jax.random.PRNGKey(8))

    def _df(dm, m0, state):
        return _div_b_grad(dm, state["b"], jnp.float64(1.0))

    A = LinearOperator(Jet(dom=sp, rng=sp, df=_df, dft="self",
                           state={"b": b}))
    M = np.asarray(materialize(A))
    np.testing.assert_allclose(M, M.T, rtol=0, atol=1e-14)
    w = np.linalg.eigvalsh(M)
    assert w.max() <= 1e-12  # negative semidefinite


# ---------------------------------------------------------------------- #
# ginsu windows (per-shot model subsetting)
# ---------------------------------------------------------------------- #


def test_ginsu_matches_explicit_slice_and_gates():
    grid = (24, 24)
    win = (12, 12)
    corners = jnp.array([[0, 0], [0, 12], [12, 0], [12, 12]], jnp.int32)
    src = jnp.full((4,), 12 * 6 + 6, jnp.int32)  # window-relative center
    rcv = jnp.arange(0, 144, 3, dtype=jnp.int32)
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float64)
    F = multishot_wave_operator(
        grid, src, rcv_idx=rcv, window_corners=corners, window_shape=win,
        **kw)
    c = 2000.0 + 100.0 * jt.Space(grid, jnp.float64).rand(
        jax.random.PRNGKey(9))
    d = F(c)
    assert d.shape[0] == 4
    # each shot must equal a single propagator run on the sliced window
    for k in range(4):
        i0, j0 = (int(corners[k, 0]), int(corners[k, 1]))
        Fw = wave_propagator(
            win, src_idx=12 * 6 + 6, rcv_idx=rcv, sponge_width=3,
            nt=24, dt=0.0008, freq=18.0, dtype=jnp.float64)
        dw = Fw(c[i0:i0 + 12, j0:j0 + 12])
        np.testing.assert_allclose(np.asarray(d[k]), np.asarray(dw),
                                   rtol=1e-12)
    # adjoint gate through the windowed stack (scatter-add placement)
    J = F.linearize(c)
    m = J.dom.randn(jax.random.PRNGKey(10))
    dd = J.rng.randn(jax.random.PRNGKey(11))
    lhs, rhs = jt.dot_product_test(J, m, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


# ---------------------------------------------------------------------- #
# off-grid acquisition (Kaiser-sinc source/receiver geometry)
# ---------------------------------------------------------------------- #


def test_offgrid_integer_positions_match_ongrid():
    """Integer src/rcv coordinates collapse the sinc stamps to one-hots, so
    the off-grid propagator must reproduce the on-grid one exactly."""
    from jets_tpu.ops.wave import offgrid_wave_propagator

    n = 24
    kw = dict(nt=40, dt=0.0008, dx=10.0, freq=18.0, sponge_width=4,
              dtype=jnp.float64)
    rcv_cols = np.arange(4, 20, 2)
    Foff = offgrid_wave_propagator(
        (n, n), src_pos=(12.0, 12.0), rcv_depth=6.0,
        rcv_coords=rcv_cols.astype(np.float64), **kw)
    Fon = wave_propagator(
        (n, n), src_idx=n * 12 + 12,
        rcv_idx=jnp.asarray(n * 6 + rcv_cols, jnp.int32), **kw)
    c = jnp.full((n, n), 2000.0, jnp.float64)
    np.testing.assert_allclose(np.asarray(Foff(c)), np.asarray(Fon(c)),
                               rtol=1e-12, atol=1e-18)


def test_offgrid_born_gate_and_fractional_signal():
    from jets_tpu.ops.wave import offgrid_wave_propagator

    n = 24
    F = offgrid_wave_propagator(
        (n, n), src_pos=(11.3, 12.6), rcv_depth=5.45,
        rcv_coords=np.linspace(4.2, 19.7, 9), nt=40, dt=0.0008, dx=10.0,
        freq=18.0, sponge_width=4, dtype=jnp.float64)
    c0 = jnp.full((n, n), 2000.0, jnp.float64)
    d = F(c0)
    assert d.shape == (40, 9)
    assert float(jnp.max(jnp.abs(d))) > 0
    J = born_operator(F, c0)
    m = J.dom.randn(jax.random.PRNGKey(12))
    dd = J.rng.randn(jax.random.PRNGKey(13))
    lhs, rhs = jt.dot_product_test(J, m, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_offgrid_3d_plane():
    from jets_tpu.ops.wave import offgrid_wave_propagator

    F = offgrid_wave_propagator(
        (12, 14, 16), src_pos=(6.5, 7.25, 8.0), rcv_depth=3.5,
        rcv_coords=(np.array([4.5, 7.0, 9.5]), np.array([5.25, 10.75])),
        nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
        dtype=jnp.float64)
    c0 = jnp.full((12, 14, 16), 2000.0, jnp.float64)
    d = F(c0)
    assert d.shape == (24, 3, 2)
    J = born_operator(F, c0)
    m = J.dom.randn(jax.random.PRNGKey(14))
    dd = J.rng.randn(jax.random.PRNGKey(15))
    lhs, rhs = jt.dot_product_test(J, m, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


# ---------------------------------------------------------------------- #
# blocked rematerialization (wavefield-storage stand-in)
# ---------------------------------------------------------------------- #


def test_remat_blocks_value_and_gradient_equivalence():
    """Blocked checkpointing changes memory, not values: forward traces are
    bit-identical and the FWI gradient matches to roundoff."""
    kw = dict(nt=48, dt=0.0008, dx=10.0, freq=18.0, src_idx=24 * 12 + 12,
              sponge_width=4, dtype=jnp.float64)
    F1 = wave_propagator((24, 24), remat_blocks=1, **kw)
    F6 = wave_propagator((24, 24), remat_blocks=6, **kw)
    c0 = 2000.0 + 50.0 * jt.Space((24, 24), jnp.float64).rand(
        jax.random.PRNGKey(16))
    d1, d6 = F1(c0), F6(c0)
    assert bool(jnp.all(d1 == d6))

    d_obs = d1 + 0.01 * jnp.std(d1)

    def loss(F, c):
        r = F(c) - d_obs
        return 0.5 * jnp.vdot(r, r).real

    g1 = jax.grad(lambda c: loss(F1, c))(c0)
    g6 = jax.grad(lambda c: loss(F6, c))(c0)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g6), rtol=1e-12)


# ---------------------------------------------------------------------- #
# VTI anisotropy (three-parameter block domain)
# ---------------------------------------------------------------------- #


def _vti_propagator():
    from jets_tpu.ops.wave import vti_wave_propagator

    return vti_wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64,
    )


def _vti_point(eps=0.1, delta=0.05):
    F = _vti_propagator()
    m = F.dom.zeros()
    m = m.setblock(0, jnp.full((20, 20), 2000.0, jnp.float64))
    m = m.setblock(1, jnp.full((20, 20), eps, jnp.float64))
    return m.setblock(2, jnp.full((20, 20), delta, jnp.float64))


def test_vti_reduces_to_isotropic():
    """epsilon = delta = 0 collapses the coupled system to the isotropic
    wave equation: traces must match wave_propagator to roundoff."""
    F = _vti_propagator()
    d_vti = F(_vti_point(eps=0.0, delta=0.0))
    Fi = wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64)
    d_iso = Fi(jnp.full((20, 20), 2000.0, jnp.float64))
    np.testing.assert_allclose(np.asarray(d_vti), np.asarray(d_iso),
                               rtol=1e-10, atol=1e-22)


def test_vti_anisotropy_changes_kinematics():
    d0 = _vti_propagator()(_vti_point(eps=0.0, delta=0.0))
    d1 = _vti_propagator()(_vti_point(eps=0.2, delta=0.1))
    assert float(jnp.max(jnp.abs(d1 - d0))) > 1e-3 * float(
        jnp.max(jnp.abs(d0)))


def test_vti_jacobian_dot_product_gate():
    F = _vti_propagator()
    J = F.linearize(_vti_point())
    m = J.dom.randn(jax.random.PRNGKey(17))
    d = J.rng.randn(jax.random.PRNGKey(18))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_vti_linearization_taylor_decay():
    F = _vti_propagator()
    m0 = _vti_point()
    dm = F.dom.randn(jax.random.PRNGKey(19))
    dm = dm.setblock(0, 50.0 * dm.getblock(0))
    dm = dm.setblock(1, 0.02 * dm.getblock(1))
    dm = dm.setblock(2, 0.02 * dm.getblock(2))
    obs, exp = jt.linearization_test(F, m0, delta_m=dm,
                                     mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(np.asarray(obs), np.asarray(exp), rtol=0.35)


# ---------------------------------------------------------------------- #
# TTI anisotropy (four-parameter block domain, 2-D)
# ---------------------------------------------------------------------- #


def _tti_propagator():
    from jets_tpu.ops.wave import tti_wave_propagator

    return tti_wave_propagator(
        (20, 20), nt=40, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64,
    )


def _tti_point(eps=0.1, delta=0.05, theta=0.0):
    F = _tti_propagator()
    m = F.dom.zeros()
    m = m.setblock(0, jnp.full((20, 20), 2000.0, jnp.float64))
    m = m.setblock(1, jnp.full((20, 20), eps, jnp.float64))
    m = m.setblock(2, jnp.full((20, 20), delta, jnp.float64))
    return m.setblock(3, jnp.full((20, 20), theta, jnp.float64))


def test_tti_reduces_to_vti_at_zero_tilt():
    d_tti = _tti_propagator()(_tti_point(theta=0.0))
    d_vti = _vti_propagator()(_vti_point(eps=0.1, delta=0.05))
    np.testing.assert_allclose(np.asarray(d_tti), np.asarray(d_vti),
                               rtol=1e-12, atol=1e-24)


def test_tti_tilt_changes_kinematics():
    d0 = _tti_propagator()(_tti_point(theta=0.0))
    d1 = _tti_propagator()(_tti_point(theta=0.5))
    assert float(jnp.max(jnp.abs(d1 - d0))) > 1e-3 * float(
        jnp.max(jnp.abs(d0)))


def test_tti_jacobian_dot_product_gate():
    F = _tti_propagator()
    J = F.linearize(_tti_point(theta=0.3))
    m = J.dom.randn(jax.random.PRNGKey(20))
    d = J.rng.randn(jax.random.PRNGKey(21))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_tti_linearization_taylor_decay():
    F = _tti_propagator()
    m0 = _tti_point(theta=0.3)
    dm = F.dom.randn(jax.random.PRNGKey(22))
    dm = dm.setblock(0, 50.0 * dm.getblock(0))
    dm = dm.setblock(1, 0.02 * dm.getblock(1))
    dm = dm.setblock(2, 0.02 * dm.getblock(2))
    dm = dm.setblock(3, 0.02 * dm.getblock(3))
    obs, exp = jt.linearization_test(F, m0, delta_m=dm,
                                     mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(np.asarray(obs), np.asarray(exp), rtol=0.35)


def test_high_order_cpml_and_anisotropic_gates():
    """space_order=8 variants of CPML / VTI / TTI pass the adjoint gate."""
    from jets_tpu.ops.wave import tti_wave_propagator, vti_wave_propagator

    kw = dict(nt=32, dt=0.0006, dx=10.0, freq=18.0, src_idx=20 * 10 + 10,
              dtype=jnp.float64)
    Fc = cpml_wave_propagator((20, 20), pml_width=4, cmax=2500.0,
                              space_order=8, **kw)
    c0 = jnp.full((20, 20), 2000.0, jnp.float64)
    J = born_operator(Fc, c0)
    lhs, rhs = jt.dot_product_test(J, J.dom.randn(jax.random.PRNGKey(23)),
                                   J.rng.randn(jax.random.PRNGKey(24)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

    Fv = vti_wave_propagator((20, 20), sponge_width=4, space_order=8, **kw)
    m = Fv.dom.zeros()
    m = m.setblock(0, c0).setblock(
        1, jnp.full((20, 20), 0.1, jnp.float64)).setblock(
        2, jnp.full((20, 20), 0.05, jnp.float64))
    J = Fv.linearize(m)
    lhs, rhs = jt.dot_product_test(J, J.dom.randn(jax.random.PRNGKey(25)),
                                   J.rng.randn(jax.random.PRNGKey(26)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

    Ft = tti_wave_propagator((20, 20), sponge_width=4, space_order=8, **kw)
    mt = Ft.dom.zeros()
    mt = mt.setblock(0, c0).setblock(
        1, jnp.full((20, 20), 0.1, jnp.float64)).setblock(
        2, jnp.full((20, 20), 0.05, jnp.float64)).setblock(
        3, jnp.full((20, 20), 0.3, jnp.float64))
    J = Ft.linearize(mt)
    lhs, rhs = jt.dot_product_test(J, J.dom.randn(jax.random.PRNGKey(27)),
                                   J.rng.randn(jax.random.PRNGKey(28)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_d1_axis_order_of_accuracy():
    n = 400
    h = 1.0 / n
    t = (jnp.arange(n, dtype=jnp.float64) + 0.5) * h
    g = lambda t: jnp.exp(-(((t - 0.5) / 0.1) ** 2))  # noqa: E731
    f = g(t)
    exact = jax.vmap(jax.grad(g))(t)
    from jets_tpu.ops.wave import _d1_axis

    errs = {}
    for order, hw in [(2, 1), (4, 2), (8, 4)]:
        num = _d1_axis(f, 0, jnp.float64(1.0 / h), order)
        sl = slice(hw + 4, -(hw + 4))
        errs[order] = float(jnp.max(jnp.abs(num[sl] - exact[sl])))
    assert errs[4] < 1e-2 * errs[2]
    assert errs[8] < 1e-4 * errs[4]


# ---------------------------------------------------------------------- #
# multi-parameter FWI end-to-end (block-vector model through the solvers)
# ---------------------------------------------------------------------- #


def test_multiparameter_fwi_lbfgs_on_block_domain():
    """L-BFGS drives a (c, b) BlockVector model end-to-end: the whole
    nonlinear solver stack (objective, adjoint-state gradient, two-loop
    recursion, Armijo) must run on block-vector pytrees unchanged."""
    from jets_tpu.solvers import lbfgs, least_squares_objective

    F = _vd_propagator()
    m_true = _vd_point()
    # a velocity anomaly the inversion should reduce
    c_pert = m_true.getblock(0).at[8:12, 8:12].add(60.0)
    m_pert = m_true.setblock(0, c_pert)
    d_obs = F(m_pert)

    fg = least_squares_objective(F, d_obs)
    phi0, g0 = fg(m_true)
    from jets_tpu.core.blockspace import BlockVector

    assert isinstance(g0, BlockVector)  # gradient lives in the block domain
    res = lbfgs(fg, m_true, maxiter=8, mem=4, tol=0.0)
    phi1, _ = fg(res.m)
    assert float(phi1) < 0.5 * float(phi0)


# ---------------------------------------------------------------------- #
# free surface (marine pressure-release top boundary)
# ---------------------------------------------------------------------- #


def test_free_surface_ghost_and_gates():
    """With free_surface the top boundary reflects (surface ghost) while the
    other edges stay absorbing; without it the top absorbs too."""
    n = 48
    kw = dict(nt=160, dt=0.001, dx=10.0, freq=15.0,
              src_idx=n * 6 + n // 2,                   # source near the top
              rcv_idx=jnp.arange(n * n, dtype=jnp.int32),
              sponge_width=8, dtype=jnp.float64)
    F_fs = wave_propagator((n, n), free_surface=True, **kw)
    F_ab = wave_propagator((n, n), free_surface=False, **kw)
    c = jnp.full((n, n), 2000.0, jnp.float64)
    d_fs, d_ab = F_fs(c), F_ab(c)
    peak = float(jnp.max(jnp.abs(d_fs)))
    # the free-surface damping profile is exactly 1 along the whole top
    # row and still absorbs at the bottom and sides
    from jets_tpu.ops.wave import _sponge

    prof = np.asarray(_sponge((n, n), 8, free_surface=True))
    assert np.all(prof[0, 8:-8] == 1.0)
    assert np.all(prof[-1, :] < 1.0) and np.all(prof[:, 0] < 1.0)
    # late-time wavefield: the surface ghost keeps energy in the domain
    # that the absorbing-top run loses (measured ratio ~1.6 — the side
    # boundaries leak identically in both runs and dilute it)
    late_fs = float(jnp.linalg.norm(d_fs[120:]))
    late_ab = float(jnp.linalg.norm(d_ab[120:]))
    assert late_fs > 1.4 * late_ab
    assert peak > 0
    # gates still hold with the free surface on
    J = born_operator(F_fs, c)
    lhs, rhs = jt.dot_product_test(
        J, J.dom.randn(jax.random.PRNGKey(29)),
        J.rng.randn(jax.random.PRNGKey(30)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_free_surface_cpml():
    from jets_tpu.ops.wave import _cpml_profiles

    a_prof, b_prof = _cpml_profiles((32, 32), 6, 0.001, 10.0, 2000.0, 15.0,
                                    dtype=jnp.float64, free_surface=True)
    a0 = np.asarray(a_prof[0]).ravel()
    assert np.all(a0[:16] == 0.0)      # no PML at the top of axis 0
    assert np.any(a0[-6:] != 0.0)      # bottom PML intact
    a1 = np.asarray(a_prof[1]).ravel()
    assert np.any(a1[:6] != 0.0)       # lateral PML on both sides
    assert np.any(a1[-6:] != 0.0)


# ---------------------------------------------------------------------- #
# sharded anisotropic multishot
# ---------------------------------------------------------------------- #


def test_multishot_vti_sharded_parity_and_gate():
    """The BlockVector model replicates across the mesh like any pytree:
    sharded forward equals unsharded, and the derived psum adjoint passes
    the gate (returning the (dc, de, dd) triple)."""
    from jets_tpu.ops.wave import multishot_vti_wave_operator
    from jets_tpu.parallel.sharded import make_block_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    grid = (16, 16)
    srcs = jnp.array([16 * 4 + 4, 16 * 4 + 11, 16 * 11 + 4, 16 * 11 + 11,
                      16 * 8 + 8, 16 * 2 + 8, 16 * 8 + 2, 16 * 13 + 8])
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float64)
    F0 = multishot_vti_wave_operator(grid, srcs, **kw)
    F1 = multishot_vti_wave_operator(grid, srcs, mesh=make_block_mesh(8),
                                     **kw)
    m = F0.dom.zeros()
    m = m.setblock(0, jnp.full(grid, 2000.0, jnp.float64))
    m = m.setblock(1, jnp.full(grid, 0.12, jnp.float64))
    m = m.setblock(2, jnp.full(grid, 0.05, jnp.float64))
    d0, d1 = F0(m), F1(m)
    assert d0.shape[0] == 8
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-12)

    J = F1.linearize(m)
    mm = J.dom.randn(jax.random.PRNGKey(31))
    dd = J.rng.randn(jax.random.PRNGKey(32))
    lhs, rhs = jt.dot_product_test(J, mm, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


# ---------------------------------------------------------------------- #
# construction-time validation (round-3 advisor items)
# ---------------------------------------------------------------------- #


def test_invalid_space_order_raises_at_construction():
    """space_order outside {2,4,8} must raise a clear ValueError at operator
    construction, not a KeyError deep inside jit tracing."""
    from jets_tpu.ops.wave import tti_wave_propagator, vti_wave_propagator

    for ctor in (wave_propagator, cpml_wave_propagator,
                 vti_wave_propagator, tti_wave_propagator):
        with pytest.raises(ValueError, match="space_order"):
            ctor((8, 8), nt=4, space_order=6)
    with pytest.raises(ValueError, match="space_order"):
        multishot_wave_operator((8, 8), [0, 1], nt=4, space_order=3)


def test_ginsu_window_validation():
    """Ginsu windowing: both-or-neither args, and corners must keep the
    window inside the grid (dynamic_slice would clamp silently)."""
    grid = (16, 16)
    srcs = [5, 6]
    # exactly one of the pair
    with pytest.raises(ValueError, match="BOTH"):
        multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8))
    with pytest.raises(ValueError, match="BOTH"):
        multishot_wave_operator(grid, srcs, nt=4,
                                window_corners=[[0, 0], [1, 1]])
    # out-of-bounds corner (12 + 8 > 16) and negative corner
    with pytest.raises(ValueError, match="out of bounds"):
        multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                window_corners=[[0, 0], [12, 0]])
    with pytest.raises(ValueError, match="out of bounds"):
        multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                window_corners=[[-1, 0], [0, 0]])
    # valid corners still construct
    F = multishot_wave_operator(grid, srcs, nt=4, window_shape=(8, 8),
                                window_corners=[[0, 0], [8, 8]])
    assert F.dom.shape == grid


def test_remat_blocks_snaps_to_divisor():
    """A non-divisor remat_blocks warns and snaps to the nearest divisor of
    nt instead of silently losing the blocked-checkpoint memory saving."""
    F = wave_propagator((8, 8), nt=30, dt=5e-4, dx=10.0, sponge_width=2,
                        remat_blocks=7, dtype=jnp.float64)
    c0 = jnp.full((8, 8), 1500.0, jnp.float64)
    with pytest.warns(UserWarning, match="nearest divisor"):
        d = F(c0)
    assert d.shape[0] == 30
    # value must match the exactly-divisible path
    F6 = wave_propagator((8, 8), nt=30, dt=5e-4, dx=10.0, sponge_width=2,
                         remat_blocks=6, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(d), np.asarray(F6(c0)), rtol=1e-12)


# ---------------------------------------------------------------------- #
# visco-acoustic Q attenuation (JetPackWaveFD DenQ-family parity)
# ---------------------------------------------------------------------- #


def _q_propagator(**kw):
    from jets_tpu.ops.wave import q_wave_propagator

    args = dict(nt=60, dt=0.0008, dx=10.0, freq=18.0,
                src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64)
    args.update(kw)
    return q_wave_propagator((20, 20), **args)


def _q_point(Q=30.0):
    F = _q_propagator()
    m = F.dom.zeros()
    return (m.setblock(0, jnp.full((20, 20), 2000.0, jnp.float64))
            .setblock(1, jnp.full((20, 20), Q, jnp.float64)))


def test_q_infinite_reduces_to_lossless():
    """Q -> inf is exactly the lossless leapfrog (g = 0 folds every damping
    factor to 1.0, so the reduction is bit-level, not approximate)."""
    Fq = _q_propagator()
    F0 = wave_propagator((20, 20), nt=60, dt=0.0008, dx=10.0, freq=18.0,
                         src_idx=20 * 10 + 10, sponge_width=4,
                         dtype=jnp.float64)
    c = jnp.full((20, 20), 2000.0, jnp.float64)
    dq = Fq(_q_point(Q=jnp.inf))
    d0 = F0(c)
    np.testing.assert_array_equal(np.asarray(dq), np.asarray(d0))


def test_q_attenuates_monotonically():
    """Smaller Q = stronger absorption: trace energy decreases as Q drops."""
    Fq = _q_propagator(nt=200)

    def energy(Q):
        m = (Fq.dom.zeros()
             .setblock(0, jnp.full((20, 20), 2000.0, jnp.float64))
             .setblock(1, jnp.full((20, 20), Q, jnp.float64)))
        d = Fq(m)
        return float(jnp.sum(d * d))

    e_inf, e_100, e_20 = energy(1e9), energy(100.0), energy(20.0)
    assert e_inf > e_100 > e_20 > 0


def test_q_jacobian_dot_product_gate():
    F = _q_propagator()
    J = F.linearize(_q_point())
    m = J.dom.randn(jax.random.PRNGKey(15))
    d = J.rng.randn(jax.random.PRNGKey(16))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_q_linearization_taylor_decay():
    F = _q_propagator()
    m0 = _q_point()
    dm = F.dom.randn(jax.random.PRNGKey(17))
    dm = dm.setblock(0, 50.0 * dm.getblock(0))
    dm = dm.setblock(1, 2.0 * dm.getblock(1))
    obs, exp = jt.linearization_test(F, m0, delta_m=dm,
                                     mu=(1.0, 0.5, 0.25, 0.125))
    np.testing.assert_allclose(np.asarray(obs), np.asarray(exp), rtol=0.35)


def test_vdq_full_denq_physics():
    """IsoDenQ (c, b, Q) — Q=inf reduces bit-exactly to variable-density,
    finite Q attenuates, and the Jacobian passes the gate."""
    from jets_tpu.ops.wave import vdq_wave_propagator

    kw = dict(nt=60, dt=0.0008, dx=10.0, freq=18.0,
              src_idx=20 * 10 + 10, sponge_width=4, dtype=jnp.float64)
    Fq = vdq_wave_propagator((20, 20), **kw)
    Fvd = vd_wave_propagator((20, 20), **kw)
    c = jnp.full((20, 20), 2000.0, jnp.float64)
    b = jnp.full((20, 20), 1e-3, jnp.float64)

    m_inf = (Fq.dom.zeros().setblock(0, c).setblock(1, b)
             .setblock(2, jnp.full((20, 20), jnp.inf, jnp.float64)))
    m_vd = Fvd.dom.zeros().setblock(0, c).setblock(1, b)
    np.testing.assert_array_equal(np.asarray(Fq(m_inf)),
                                  np.asarray(Fvd(m_vd)))

    m_20 = (Fq.dom.zeros().setblock(0, c).setblock(1, b)
            .setblock(2, jnp.full((20, 20), 20.0, jnp.float64)))
    e_inf = float(jnp.sum(Fq(m_inf) ** 2))
    e_20 = float(jnp.sum(Fq(m_20) ** 2))
    assert e_inf > e_20 > 0

    J = Fq.linearize(m_20)
    mm = J.dom.randn(jax.random.PRNGKey(25))
    dd = J.rng.randn(jax.random.PRNGKey(26))
    lhs, rhs = jt.dot_product_test(J, mm, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_3d_iota_mask_and_sponge_factors_bit_exact():
    """The 3-D step's in-register source mask (iota compare) and per-axis
    sponge-factor product are BIT-identical to the stored dense mask /
    full-grid sponge they replace, checked at the single-jitted-step level
    (exact in f32 — same values, same product tree). The whole-propagator
    pin against an EAGER dense-reference loop is rtol-tight instead:
    lax.scan + jax.checkpoint round the carry differently from an eager
    Python loop at the few-ulp level, for old and new step forms alike
    (the old→new rewrite itself was verified output-bitwise before
    landing)."""
    from jets_tpu.ops.wave import (_iota_src_mask, _mul_sponge, _ricker,
                                   _sponge, _sponge_factors)

    # --- single-step bitwise guarantees
    grid = (10, 12, 14)
    size = 10 * 12 * 14
    sp_full = _sponge(grid, 3).astype(jnp.float32)
    factors = tuple(f.astype(jnp.float32) for f in _sponge_factors(grid, 3))
    e = jax.random.normal(jax.random.PRNGKey(9), grid, jnp.float32)
    a = jax.jit(lambda e: e * sp_full)(e)
    b = jax.jit(lambda e: _mul_sponge(e, factors))(e)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    m_dense = (jnp.zeros((size,), jnp.float32).at[123].set(2.5e-7)
               .reshape(grid))
    m_iota = jax.jit(
        lambda: _iota_src_mask(grid, 123, jnp.float32(2.5e-7)))()
    np.testing.assert_array_equal(np.asarray(m_dense), np.asarray(m_iota))

    # --- whole-propagator pin vs eager dense reference (rtol-tight)
    nt, dt, dx = 16, 5e-4, 10.0
    src = 3 * 12 * 14 + 5 * 14 + 6
    F = wave_propagator(grid, nt=nt, dt=dt, dx=dx, freq=18.0, src_idx=src,
                        sponge_width=3, dtype=jnp.float64)
    c = jnp.full(grid, 1800.0, jnp.float64) + 10.0 * jax.random.normal(
        jax.random.PRNGKey(0), grid, jnp.float64)
    d = F(c)
    sponge = _sponge(grid, 3).astype(jnp.float64)
    mask = jnp.zeros((size,), jnp.float64).at[src].set(dt * dt).reshape(grid)
    wav = _ricker(nt, dt, 18.0, jnp.float64)
    c2dt2 = (c * c) * (dt * dt) / (dx * dx)
    u_prev = u = jnp.zeros(grid, jnp.float64)
    recs = []
    n = F.rng.shape[1]
    rcv = jnp.arange(0, size, max(1, size // 128))[:128][:n]
    for t in range(nt):
        u_next = (2.0 * u - u_prev + c2dt2 * laplacian_nd(u)) * sponge \
            + wav[t] * mask
        recs.append(u_next.reshape(-1)[rcv])
        u_prev, u = u, u_next
    ref = jnp.stack(recs)
    np.testing.assert_allclose(np.asarray(d), np.asarray(ref),
                               rtol=3e-7, atol=0)


# ---------------------------------------------------------------------- #
# 3-D TTI anisotropy (five-parameter block domain: c, eps, delta, theta, phi)
# ---------------------------------------------------------------------- #

_TTI3D_SHAPE = (12, 10, 14)


def _tti3d_propagator():
    from jets_tpu.ops.wave import tti_wave_propagator

    return tti_wave_propagator(
        _TTI3D_SHAPE, nt=36, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=int(np.ravel_multi_index((6, 5, 7), _TTI3D_SHAPE)),
        sponge_width=3, dtype=jnp.float64,
    )


def _tti3d_point(eps=0.1, delta=0.05, theta=0.0, phi=0.0):
    F = _tti3d_propagator()
    full = lambda v: jnp.full(_TTI3D_SHAPE, v, jnp.float64)  # noqa: E731
    m = F.dom.zeros().setblock(0, full(2000.0)).setblock(1, full(eps))
    return (m.setblock(2, full(delta)).setblock(3, full(theta))
            .setblock(4, full(phi)))


def test_tti3d_reduces_to_vti_at_zero_tilt():
    """theta=0 makes every rotated-operator multiplier exactly 0 or 1, so
    the 3-D TTI step equals the 3-D VTI step to FMA-grouping noise (the
    same tolerance the 2-D pin uses — XLA fuses the bigger TTI graph into
    different multiply-add groupings)."""
    from jets_tpu.ops.wave import vti_wave_propagator

    d_tti = _tti3d_propagator()(_tti3d_point(theta=0.0, phi=0.7))
    Fv = vti_wave_propagator(
        _TTI3D_SHAPE, nt=36, dt=0.0008, dx=10.0, freq=18.0,
        src_idx=int(np.ravel_multi_index((6, 5, 7), _TTI3D_SHAPE)),
        sponge_width=3, dtype=jnp.float64,
    )
    full = lambda v: jnp.full(_TTI3D_SHAPE, v, jnp.float64)  # noqa: E731
    mv = (Fv.dom.zeros().setblock(0, full(2000.0))
          .setblock(1, full(0.1)).setblock(2, full(0.05)))
    d_vti = Fv(mv)
    np.testing.assert_allclose(np.asarray(d_tti), np.asarray(d_vti),
                               rtol=1e-12, atol=1e-20)


def test_tti3d_elliptic_isotropic_limit():
    """eps = delta = 0 with p == q collapses H + V to the plain Laplacian:
    any tilt/azimuth must then leave the wavefield (nearly) isotropic."""
    d0 = _tti3d_propagator()(_tti3d_point(eps=0.0, delta=0.0,
                                          theta=0.0, phi=0.0))
    d1 = _tti3d_propagator()(_tti3d_point(eps=0.0, delta=0.0,
                                          theta=0.6, phi=1.1))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0),
                               rtol=1e-9, atol=1e-18)


def test_tti3d_azimuth_changes_kinematics():
    d0 = _tti3d_propagator()(_tti3d_point(theta=0.5, phi=0.0))
    d1 = _tti3d_propagator()(_tti3d_point(theta=0.5, phi=1.2))
    assert float(jnp.max(jnp.abs(d1 - d0))) > 1e-4 * float(
        jnp.max(jnp.abs(d0)))


def test_tti3d_jacobian_dot_product_gate():
    F = _tti3d_propagator()
    J = F.linearize(_tti3d_point(theta=0.4, phi=0.9))
    m = J.dom.randn(jax.random.PRNGKey(40))
    d = J.rng.randn(jax.random.PRNGKey(41))
    lhs, rhs = jt.dot_product_test(J, m, d)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


# ---------------------------------------------------------------------- #
# dtmod/dtrec recording-grid time interpolation
# ---------------------------------------------------------------------- #


class TestDtrec:
    SHAPE = (24, 24)
    KW = dict(dt=1e-3, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
              sponge_width=4, dtype=jnp.float32)

    def test_integer_ratio_is_exact_subsampling(self):
        from jets_tpu.ops.wave import wave_propagator

        c = jnp.full(self.SHAPE, 1500.0, jnp.float32)
        F1 = wave_propagator(self.SHAPE, nt=41, **self.KW)
        F2 = wave_propagator(self.SHAPE, nt=41, dtrec=2e-3, **self.KW)
        d1, d2 = F1(c), F2(c)
        assert d2.shape[0] == 21
        # integer sample points carry weight exactly 0 → bitwise equality
        assert np.array_equal(np.asarray(d2), np.asarray(d1)[::2])

    def test_fractional_ratio_matches_numpy_interp(self):
        from jets_tpu.ops.wave import wave_propagator

        c = jnp.full(self.SHAPE, 1500.0, jnp.float32)
        F1 = wave_propagator(self.SHAPE, nt=40, **self.KW)
        Fr = wave_propagator(self.SHAPE, nt=40, dtrec=1.5e-3, **self.KW)
        d1 = np.asarray(F1(c), np.float64)
        dr = np.asarray(Fr(c))
        t_f = np.arange(40) * 1e-3
        t_r = np.arange(dr.shape[0]) * 1.5e-3
        want = np.stack(
            [np.interp(t_r, t_f, d1[:, k]) for k in range(d1.shape[1])],
            axis=1)
        np.testing.assert_allclose(dr, want, rtol=1e-5, atol=1e-7)

    def test_adjoint_gate_and_gradient(self):
        from jets_tpu.ops.wave import wave_propagator

        F = wave_propagator(self.SHAPE, nt=30, dtrec=2.5e-3, **self.KW)
        c0 = jnp.full(self.SHAPE, 1500.0, jnp.float32)
        J = F.linearize(c0)
        m = J.dom.randn(jax.random.PRNGKey(31)).astype(jnp.float32)
        d = J.rng.randn(jax.random.PRNGKey(32)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, m, d)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-5)

    def test_multishot_and_anisotropic_ranges(self):
        from jets_tpu.ops.wave import (multishot_wave_operator,
                                       vti_wave_propagator)

        kw = {k: v for k, v in self.KW.items() if k != "src_idx"}
        F = multishot_wave_operator(
            self.SHAPE, [100, 200], nt=21, dtrec=2e-3, **kw)
        assert F.rng.shape == (2, 11, F.rng.shape[2])
        c = jnp.full(self.SHAPE, 1500.0, jnp.float32)
        assert F(c).shape == F.rng.shape

        shape3 = (12, 8, 128)
        rcv3 = jnp.asarray(
            [np.ravel_multi_index((6, 4, x), shape3) for x in range(128)],
            jnp.int32)
        Fv = vti_wave_propagator(
            shape3, nt=21, dt=1e-3, dx=10.0, freq=18.0,
            src_idx=int(np.ravel_multi_index((6, 4, 64), shape3)),
            rcv_idx=rcv3, sponge_width=3, dtrec=2e-3, dtype=jnp.float32)
        assert Fv.rng.shape[0] == 11

    def test_dtrec_validation(self):
        from jets_tpu.ops.wave import wave_propagator

        with pytest.raises(ValueError, match="dtrec"):
            wave_propagator(self.SHAPE, nt=8, dtrec=1e-4, **self.KW)


# ---------------------------------------------------------------------- #
# stored (compressed) forward-wavefield adjoint — the CvxCompress slot
# ---------------------------------------------------------------------- #


class TestStoredAdjoint:
    SHAPE2 = (24, 24)
    KW2 = dict(nt=36, dt=1e-3, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
               sponge_width=4, dtype=jnp.float32)
    SHAPE3 = (12, 8, 128)
    # receivers along the x-line through the source — the default strided
    # set degenerates to the (unreachable) x=0 plane for W=128 shapes
    RCV3 = jnp.asarray(
        [np.ravel_multi_index((6, 4, x), (12, 8, 128)) for x in range(128)],
        jnp.int32)
    KW3 = dict(nt=24, dt=6e-4, dx=10.0, freq=16.0,
               src_idx=int(np.ravel_multi_index((6, 4, 64), (12, 8, 128))),
               rcv_idx=RCV3, sponge_width=3, dtype=jnp.float32)

    def _grad(self, F, c0, d):
        J = F.linearize(c0)
        return np.asarray(J.H(d))

    @pytest.mark.parametrize("dim", ["2d", "3d"])
    def test_f32_storage_matches_autodiff_adjoint(self, dim):
        from jets_tpu.ops.wave import wave_propagator

        shape, kw = ((self.SHAPE2, self.KW2) if dim == "2d"
                     else (self.SHAPE3, self.KW3))
        Fa = wave_propagator(shape, **kw)
        Fs = wave_propagator(shape, store_adjoint="f32", **kw)
        c0 = jnp.full(shape, 1500.0, jnp.float32)
        d = Fa.rng.randn(jax.random.PRNGKey(41)).astype(jnp.float32)
        ga, gs = self._grad(Fa, c0, d), self._grad(Fs, c0, d)
        assert float(np.max(np.abs(ga))) > 0.0, "vacuous: zero adjoint"
        scale = float(np.max(np.abs(ga))) or 1.0
        np.testing.assert_allclose(gs / scale, ga / scale,
                                   rtol=1e-5, atol=1e-6)

    def test_f32_dot_product_gate(self):
        from jets_tpu.ops.wave import wave_propagator

        F = wave_propagator(self.SHAPE2, store_adjoint="f32", **self.KW2)
        J = F.linearize(jnp.full(self.SHAPE2, 1500.0, jnp.float32))
        m = J.dom.randn(jax.random.PRNGKey(42)).astype(jnp.float32)
        d = J.rng.randn(jax.random.PRNGKey(43)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, m, d)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-5)

    @pytest.mark.parametrize("store,tol", [("bf16", 2e-2), ("int8", 5e-2)])
    def test_lossy_storage_preserves_gradient_direction(self, store, tol):
        from jets_tpu.ops.wave import wave_propagator

        Fa = wave_propagator(self.SHAPE2, **self.KW2)
        Fs = wave_propagator(self.SHAPE2, store_adjoint=store, **self.KW2)
        c0 = jnp.full(self.SHAPE2, 1500.0, jnp.float32)
        # physical cotangent (modeled data), not white noise: the gradient
        # direction is what FWI needs preserved
        d = Fa(c0 * 1.02) - Fa(c0)
        ga, gs = self._grad(Fa, c0, d), self._grad(Fs, c0, d)
        cos = float(np.dot(ga.ravel(), gs.ravel())
                    / (np.linalg.norm(ga) * np.linalg.norm(gs) + 1e-30))
        assert cos > 1.0 - tol, f"{store}: cosine {cos}"
        rel = np.linalg.norm(gs - ga) / (np.linalg.norm(ga) + 1e-30)
        assert rel < 10 * tol, f"{store}: rel err {rel}"

    def test_stored_composes_with_dtrec(self):
        from jets_tpu.ops.wave import wave_propagator

        kw = dict(self.KW2)
        Fa = wave_propagator(self.SHAPE2, dtrec=2e-3, **kw)
        Fs = wave_propagator(self.SHAPE2, dtrec=2e-3, store_adjoint="f32",
                             **kw)
        c0 = jnp.full(self.SHAPE2, 1500.0, jnp.float32)
        d = Fa.rng.randn(jax.random.PRNGKey(44)).astype(jnp.float32)
        ga, gs = self._grad(Fa, c0, d), self._grad(Fs, c0, d)
        scale = float(np.max(np.abs(ga))) or 1.0
        np.testing.assert_allclose(gs / scale, ga / scale,
                                   rtol=1e-5, atol=1e-6)

    def test_store_validation(self):
        from jets_tpu.ops.wave import wave_propagator

        with pytest.raises(ValueError, match="store_adjoint"):
            wave_propagator(self.SHAPE2, store_adjoint="int4", **self.KW2)


def test_multishot_tti_sharded_parity_and_gate():
    """Sharded TTI shots: forward parity vs unsharded and the adjoint gate
    through the tilt block (the derived psum adjoint returns the FULL
    4-parameter gradient tuple)."""
    from jets_tpu.ops.wave import multishot_tti_wave_operator
    from jets_tpu.parallel.sharded import make_block_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    grid = (16, 16)
    srcs = jnp.array([16 * 4 + 4, 16 * 4 + 11, 16 * 11 + 4, 16 * 11 + 11,
                      16 * 8 + 8, 16 * 2 + 8, 16 * 8 + 2, 16 * 13 + 8])
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float64)
    F0 = multishot_tti_wave_operator(grid, srcs, **kw)
    F1 = multishot_tti_wave_operator(grid, srcs, mesh=make_block_mesh(8),
                                     **kw)
    m = F0.dom.zeros()
    m = m.setblock(0, jnp.full(grid, 2000.0, jnp.float64))
    m = m.setblock(1, jnp.full(grid, 0.12, jnp.float64))
    m = m.setblock(2, jnp.full(grid, 0.05, jnp.float64))
    m = m.setblock(3, jnp.full(grid, 0.3, jnp.float64))
    d0, d1 = F0(m), F1(m)
    assert d0.shape[0] == 8
    assert float(jnp.max(jnp.abs(d0))) > 0
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-12)

    J = F1.linearize(m)
    mm = J.dom.randn(jax.random.PRNGKey(33))
    dd = J.rng.randn(jax.random.PRNGKey(34))
    lhs, rhs = jt.dot_product_test(J, mm, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

    # the sharded tilt-at-zero reduces to the sharded VTI multishot
    from jets_tpu.ops.wave import multishot_vti_wave_operator
    Fv = multishot_vti_wave_operator(grid, srcs, mesh=make_block_mesh(8),
                                     **kw)
    mv = Fv.dom.zeros()
    for i in range(3):
        mv = mv.setblock(i, m.getblock(i))
    d_tti0 = F1(m.setblock(3, jnp.zeros(grid, jnp.float64)))
    np.testing.assert_allclose(np.asarray(d_tti0), np.asarray(Fv(mv)),
                               rtol=1e-12)


# ---------------------------------------------------------------------- #
# static-Q attenuation on the anisotropic propagators (the DenQ slot)
# ---------------------------------------------------------------------- #


class TestAnisotropicStaticQ:
    GRID = (20, 20)
    KW = dict(nt=60, dt=0.0008, dx=10.0, freq=18.0,
              src_idx=20 * 10 + 10, sponge_width=3, dtype=jnp.float64)

    def _vti_point(self, F):
        full = lambda v: jnp.full(self.GRID, v, jnp.float64)  # noqa: E731
        return (F.dom.zeros().setblock(0, full(2000.0))
                .setblock(1, full(0.1)).setblock(2, full(0.05)))

    def test_infinite_q_is_lossless(self):
        """q=inf gives og=ig=1 exactly; equality is to FMA-contraction
        noise (the extra multiplies change XLA's fusion groupings even
        when they are by 1.0) — same tolerance family as the TTI-at-zero
        -tilt pins."""
        from jets_tpu.ops.wave import vti_wave_propagator

        F0 = vti_wave_propagator(self.GRID, **self.KW)
        Fq = vti_wave_propagator(self.GRID, q=jnp.inf, **self.KW)
        m = self._vti_point(F0)
        d0, dq = np.asarray(F0(m)), np.asarray(Fq(m))
        assert np.max(np.abs(d0)) > 0
        np.testing.assert_allclose(dq, d0, rtol=1e-10,
                                   atol=1e-14 * np.max(np.abs(d0)))

    def test_finite_q_attenuates(self):
        from jets_tpu.ops.wave import tti_wave_propagator, \
            vti_wave_propagator

        for ctor, nblk in ((vti_wave_propagator, 3),
                           (tti_wave_propagator, 4)):
            F0 = ctor(self.GRID, **self.KW)
            Fq = ctor(self.GRID, q=8.0, **self.KW)
            full = lambda v: jnp.full(self.GRID, v, jnp.float64)  # noqa
            m = F0.dom.zeros().setblock(0, full(2000.0)) \
                .setblock(1, full(0.1)).setblock(2, full(0.05))
            if nblk == 4:
                m = m.setblock(3, full(0.2))
            d0, dq = F0(m), Fq(m)
            tail = slice(40, None)   # late arrivals carry the decay
            e0 = float(jnp.linalg.norm(d0[tail]))
            eq = float(jnp.linalg.norm(dq[tail]))
            assert e0 > 0 and eq < 0.9 * e0, (ctor.__name__, e0, eq)

    def test_q_jacobian_gate_and_fused_rejection(self):
        from jets_tpu.ops.wave import tti_wave_propagator, \
            vti_wave_propagator

        F = vti_wave_propagator(self.GRID, q=30.0, **self.KW)
        J = F.linearize(self._vti_point(F))
        mm = J.dom.randn(jax.random.PRNGKey(51))
        dd = J.rng.randn(jax.random.PRNGKey(52))
        lhs, rhs = jt.dot_product_test(J, mm, dd)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)

        kw3 = dict(nt=4, dt=6e-4, dx=10.0, freq=16.0, src_idx=0,
                   sponge_width=2, dtype=jnp.float32)
        # the retired fused-kernel option fails loudly, never silently
        with pytest.raises(TypeError, match="fused"):
            vti_wave_propagator((16, 8, 128), q=30.0, fused=True, **kw3)
        with pytest.raises(TypeError, match="fused"):
            tti_wave_propagator((16, 8, 128), q=30.0, fused=True, **kw3)


def test_multishot_stored_adjoint_matches_derived():
    """Per-shot stored-wavefield adjoints through the stacked machinery:
    the explicit child dft (summed + psum'd over shots) must match the
    jet-level derived adjoint, unsharded and sharded, windowed or not."""
    from jets_tpu.ops.wave import multishot_wave_operator
    from jets_tpu.parallel.sharded import make_block_mesh

    grid = (20, 20)
    srcs = jnp.array([20 * 5 + 5, 20 * 5 + 14, 20 * 14 + 5, 20 * 14 + 14])
    kw = dict(nt=24, dt=0.0008, dx=10.0, freq=18.0, sponge_width=3,
              dtype=jnp.float32)
    c0 = jnp.full(grid, 1500.0, jnp.float32)

    Fd = multishot_wave_operator(grid, srcs, **kw)
    Fs = multishot_wave_operator(grid, srcs, store_adjoint="f32", **kw)
    d = Fd.rng.randn(jax.random.PRNGKey(51)).astype(jnp.float32)
    gd = np.asarray(Fd.linearize(c0).H(d))
    gs = np.asarray(Fs.linearize(c0).H(d))
    scale = float(np.max(np.abs(gd)))
    assert scale > 0.0, "vacuous: zero adjoint"
    np.testing.assert_allclose(gs / scale, gd / scale, rtol=1e-5, atol=1e-6)

    # dot-product gate on the stored-adjoint operator
    J = Fs.linearize(c0)
    mm = J.dom.randn(jax.random.PRNGKey(52)).astype(jnp.float32)
    dd = J.rng.randn(jax.random.PRNGKey(53)).astype(jnp.float32)
    lhs, rhs = jt.dot_product_test(J, mm, dd)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

    # sharded (both shot_map modes): explicit child dft + stacked psum
    if len(jax.devices()) >= 4:
        for sm in ("vmap", "map"):
            Fp = multishot_wave_operator(
                grid, srcs, store_adjoint="f32", mesh=make_block_mesh(4),
                shot_map=sm, **kw)
            gp = np.asarray(Fp.linearize(c0).H(d))
            np.testing.assert_allclose(gp / scale, gd / scale,
                                       rtol=1e-5, atol=1e-6)

    # ginsu windows: stored adjoint places contributions back through the
    # transposed slice
    corners = jnp.array([[0, 0], [0, 4], [4, 0], [4, 4]], jnp.int32)
    wsrcs = jnp.array([16 * 8 + 8] * 4)
    kww = dict(kw, window_shape=(16, 16), window_corners=corners)
    Fwd = multishot_wave_operator(grid, wsrcs, **kww)
    Fws = multishot_wave_operator(grid, wsrcs, store_adjoint="f32", **kww)
    dw = Fwd.rng.randn(jax.random.PRNGKey(54)).astype(jnp.float32)
    gwd = np.asarray(Fwd.linearize(c0).H(dw))
    gws = np.asarray(Fws.linearize(c0).H(dw))
    sw = float(np.max(np.abs(gwd)))
    assert sw > 0.0
    np.testing.assert_allclose(gws / sw, gwd / sw, rtol=1e-5, atol=1e-6)

    # int8 storage: direction preserved
    Fi = multishot_wave_operator(grid, srcs, store_adjoint="int8", **kw)
    dres = Fd(c0 * 1.02) - Fd(c0)
    gdi = np.asarray(Fd.linearize(c0).H(dres))
    gsi = np.asarray(Fi.linearize(c0).H(dres))
    cos = float(np.dot(gdi.ravel(), gsi.ravel())
                / (np.linalg.norm(gdi) * np.linalg.norm(gsi) + 1e-30))
    assert cos > 0.95, f"int8 multishot cosine {cos}"


class TestStoredAdjointVTI:
    SHAPE3 = (12, 8, 128)
    RCV3 = jnp.asarray(
        [np.ravel_multi_index((6, 4, x), (12, 8, 128)) for x in range(128)],
        jnp.int32)
    KW3 = dict(nt=24, dt=6e-4, dx=10.0, freq=16.0,
               src_idx=int(np.ravel_multi_index((6, 4, 64), (12, 8, 128))),
               rcv_idx=RCV3, sponge_width=3, dtype=jnp.float32)
    SHAPE2 = (24, 24)
    KW2 = dict(nt=30, dt=8e-4, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
               sponge_width=4, dtype=jnp.float32)

    def _model(self, F, shape):
        full = lambda v: jnp.full(shape, v, jnp.float32)  # noqa: E731
        return (F.dom.zeros().setblock(0, full(1500.0))
                .setblock(1, full(0.1)).setblock(2, full(0.05)))

    @pytest.mark.parametrize("dim", ["2d", "3d"])
    def test_f32_storage_matches_autodiff_adjoint(self, dim):
        from jets_tpu.ops.wave import vti_wave_propagator

        shape, kw = ((self.SHAPE2, self.KW2) if dim == "2d"
                     else (self.SHAPE3, self.KW3))
        Fa = vti_wave_propagator(shape, **kw)
        Fs = vti_wave_propagator(shape, store_adjoint="f32", **kw)
        m0 = self._model(Fa, shape)
        d = Fa.rng.randn(jax.random.PRNGKey(61)).astype(jnp.float32)
        ga = Fa.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(3):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous: zero adjoint block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-5, atol=2e-5)

    def test_dot_product_gate_and_lossy_direction(self):
        from jets_tpu.ops.wave import vti_wave_propagator

        Fs = vti_wave_propagator(self.SHAPE2, store_adjoint="f32",
                                 **self.KW2)
        m0 = self._model(Fs, self.SHAPE2)
        J = Fs.linearize(m0)
        mm = J.dom.randn(jax.random.PRNGKey(62))
        dd = J.rng.randn(jax.random.PRNGKey(63)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, mm, dd)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

        # int8 history preserves the gradient direction on a physical
        # residual (per block)
        Fa = vti_wave_propagator(self.SHAPE2, **self.KW2)
        Fi = vti_wave_propagator(self.SHAPE2, store_adjoint="int8",
                                 **self.KW2)
        d = Fa(self._model(Fa, self.SHAPE2).setblock(
            0, jnp.full(self.SHAPE2, 1530.0, jnp.float32))) - Fa(m0)
        _assert = float(jnp.max(jnp.abs(d)))
        assert _assert > 0.0
        ga = Fa.linearize(m0).H(d)
        gi = Fi.linearize(m0).H(d)
        for b in range(3):
            a = np.asarray(ga.getblock(b)).ravel()
            i = np.asarray(gi.getblock(b)).ravel()
            cos = float(np.dot(a, i)
                        / (np.linalg.norm(a) * np.linalg.norm(i) + 1e-30))
            assert cos > 0.95, f"block {b} cosine {cos}"

    def test_store_validation(self):
        from jets_tpu.ops.wave import vti_wave_propagator

        with pytest.raises(ValueError, match="store_adjoint"):
            vti_wave_propagator(self.SHAPE2, store_adjoint="int4",
                                **self.KW2)

    def test_static_q_stored_matches_autodiff(self):
        """store_adjoint composes with static Kosloff Q (the attenuating
        DenQ variant): the transposed recurrence carries the same og/ig
        factors, pinned against autodiff through the Q'ed scan."""
        from jets_tpu.ops.wave import vti_wave_propagator

        Fa = vti_wave_propagator(self.SHAPE2, q=25.0, **self.KW2)
        Fs = vti_wave_propagator(self.SHAPE2, q=25.0, store_adjoint="f32",
                                 **self.KW2)
        m0 = self._model(Fa, self.SHAPE2)
        d = Fa.rng.randn(jax.random.PRNGKey(66)).astype(jnp.float32)
        ga = Fa.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(3):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous: zero adjoint block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-5, atol=2e-5)


class TestStoredAdjointTTI3D:
    SHAPE = (12, 8, 128)
    RCV = jnp.asarray(
        [np.ravel_multi_index((6, 4, x), (12, 8, 128)) for x in range(128)],
        jnp.int32)
    KW = dict(nt=24, dt=6e-4, dx=10.0, freq=16.0,
              src_idx=int(np.ravel_multi_index((6, 4, 64), (12, 8, 128))),
              rcv_idx=RCV, sponge_width=3, dtype=jnp.float32)

    def _model(self, F):
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m = F.dom.zeros()
        for b, v in enumerate((1500.0, 0.1, 0.05, 0.2, 0.7)):
            m = m.setblock(b, full(v))
        return m

    def test_f32_storage_matches_autodiff_adjoint(self):
        from jets_tpu.ops.wave import tti_wave_propagator

        Fa = tti_wave_propagator(self.SHAPE, **self.KW)
        Fs = tti_wave_propagator(self.SHAPE, store_adjoint="f32",
                                 **self.KW)
        m0 = self._model(Fa)
        d = Fa.rng.randn(jax.random.PRNGKey(71)).astype(jnp.float32)
        ga = Fa.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(5):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous: zero adjoint block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-4, atol=5e-5)

    def test_bf16_coeff_mode_matches_autodiff(self):
        """Stored sweep under the reduced-precision coefficient mode must
        match autodiff through the SAME rounded primal."""
        from jets_tpu.ops.wave import tti_wave_propagator

        kw = dict(self.KW)
        Fa = tti_wave_propagator(self.SHAPE, coeff_dtype=jnp.bfloat16,
                                 **kw)
        Fs = tti_wave_propagator(self.SHAPE, coeff_dtype=jnp.bfloat16,
                                 store_adjoint="f32", **kw)
        m0 = self._model(Fa)
        d = Fa.rng.randn(jax.random.PRNGKey(72)).astype(jnp.float32)
        ga = Fa.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(5):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-4, atol=5e-5)

    def test_gate_int8_direction_and_validation(self):
        from jets_tpu.ops.wave import tti_wave_propagator

        Fs = tti_wave_propagator(self.SHAPE, store_adjoint="f32",
                                 **self.KW)
        m0 = self._model(Fs)
        J = Fs.linearize(m0)
        mm = J.dom.randn(jax.random.PRNGKey(73))
        dd = J.rng.randn(jax.random.PRNGKey(74)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, mm, dd)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

        Fa = tti_wave_propagator(self.SHAPE, **self.KW)
        Fi = tti_wave_propagator(self.SHAPE, store_adjoint="int8",
                                 **self.KW)
        d = Fa(m0.setblock(0, jnp.full(self.SHAPE, 1530.0,
                                       jnp.float32))) - Fa(m0)
        assert float(jnp.max(jnp.abs(d))) > 0.0
        ga = Fa.linearize(m0).H(d)
        gi = Fi.linearize(m0).H(d)
        for b in range(5):
            a = np.asarray(ga.getblock(b)).ravel()
            i = np.asarray(gi.getblock(b)).ravel()
            cos = float(np.dot(a, i)
                        / (np.linalg.norm(a) * np.linalg.norm(i) + 1e-30))
            assert cos > 0.95, f"block {b} cosine {cos}"

        with pytest.raises(ValueError, match="3-D only"):
            tti_wave_propagator((24, 24), store_adjoint="f32", nt=8)

    def test_static_q_stored_matches_autodiff(self):
        """TTI static-Q stored sweep vs autodiff through the Q'ed scan."""
        from jets_tpu.ops.wave import tti_wave_propagator

        Fa = tti_wave_propagator(self.SHAPE, q=25.0, **self.KW)
        Fs = tti_wave_propagator(self.SHAPE, q=25.0, store_adjoint="f32",
                                 **self.KW)
        m0 = self._model(Fa)
        d = Fa.rng.randn(jax.random.PRNGKey(76)).astype(jnp.float32)
        ga = Fa.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(5):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous: zero adjoint block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-4, atol=5e-5)


def test_multishot_anisotropic_stored_adjoint_matches_derived():
    """VTI/TTI multishot with per-shot stored sweeps: the explicit child
    dft (+ stacked psum when sharded) matches the derived adjoint."""
    from jets_tpu.ops.wave import (multishot_tti_wave_operator,
                                   multishot_vti_wave_operator)
    from jets_tpu.parallel.sharded import make_block_mesh

    grid = (12, 8, 128)
    rcv = jnp.asarray([np.ravel_multi_index((6, 4, x), grid)
                       for x in range(128)], jnp.int32)
    srcs = jnp.asarray([np.ravel_multi_index((6, 4, 40), grid),
                        np.ravel_multi_index((6, 4, 88), grid)], jnp.int32)
    kw = dict(nt=16, dt=6e-4, dx=10.0, freq=16.0, rcv_idx=rcv,
              sponge_width=3, dtype=jnp.float32)
    full = lambda v: jnp.full(grid, v, jnp.float32)  # noqa: E731

    for make, nb, vals in (
            (multishot_vti_wave_operator, 3, (1500.0, 0.1, 0.05)),
            (multishot_tti_wave_operator, 5,
             (1500.0, 0.1, 0.05, 0.2, 0.7))):
        Fd = make(grid, srcs, **kw)
        Fs = make(grid, srcs, store_adjoint="f32", **kw)
        m0 = Fd.dom.zeros()
        for b, v in enumerate(vals):
            m0 = m0.setblock(b, full(v))
        d = Fd.rng.randn(jax.random.PRNGKey(81)).astype(jnp.float32)
        gd = Fd.linearize(m0).H(d)
        gs = Fs.linearize(m0).H(d)
        for b in range(nb):
            a = np.asarray(gd.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=1e-4, atol=5e-5)
        # sharded map-mode
        if len(jax.devices()) >= 2:
            Fp = make(grid, srcs, store_adjoint="f32",
                      mesh=make_block_mesh(2), shot_map="map", **kw)
            gp = Fp.linearize(m0).H(d)
            for b in range(nb):
                a = np.asarray(gd.getblock(b))
                p = np.asarray(gp.getblock(b))
                scale = float(np.max(np.abs(a)))
                np.testing.assert_allclose(p / scale, a / scale,
                                           rtol=1e-4, atol=5e-5)


# ---------------------------------------------------------------------- #
# stored adjoints for the DenQ family (q / vd / vdq) — the production
# Prop*AcoIsoDenQ imaging path: compressed stored wavefields, no recompute
# ---------------------------------------------------------------------- #


class TestStoredAdjointDenQ:
    SHAPE = (24, 24)
    KW = dict(nt=36, dt=8e-4, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
              sponge_width=4, dtype=jnp.float32)

    def _cmp_blocks(self, ga, gs, nblk, rtol=1e-5, atol=2e-5):
        for b in range(nblk):
            a = np.asarray(ga.getblock(b))
            s = np.asarray(gs.getblock(b))
            scale = float(np.max(np.abs(a)))
            assert scale > 0.0, f"vacuous: zero adjoint block {b}"
            np.testing.assert_allclose(s / scale, a / scale,
                                       rtol=rtol, atol=atol,
                                       err_msg=f"block {b}")

    def test_q_f32_storage_matches_autodiff(self):
        from jets_tpu.ops.wave import q_wave_propagator

        Fa = q_wave_propagator(self.SHAPE, **self.KW)
        Fs = q_wave_propagator(self.SHAPE, store_adjoint="f32", **self.KW)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = Fa.dom.zeros().setblock(0, full(1500.0)).setblock(1, full(25.0))
        d = Fa.rng.randn(jax.random.PRNGKey(81)).astype(jnp.float32)
        self._cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), 2)

    def test_q_dot_gate_and_int8_direction(self):
        from jets_tpu.ops.wave import q_wave_propagator

        Fs = q_wave_propagator(self.SHAPE, store_adjoint="f32", **self.KW)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = Fs.dom.zeros().setblock(0, full(1500.0)).setblock(1, full(25.0))
        J = Fs.linearize(m0)
        mm = J.dom.randn(jax.random.PRNGKey(82))
        dd = J.rng.randn(jax.random.PRNGKey(83)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, mm, dd)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

        Fa = q_wave_propagator(self.SHAPE, **self.KW)
        Fi = q_wave_propagator(self.SHAPE, store_adjoint="int8", **self.KW)
        d = Fa(m0.setblock(0, full(1530.0))) - Fa(m0)
        assert float(jnp.max(jnp.abs(d))) > 0.0
        ga = Fa.linearize(m0).H(d)
        gi = Fi.linearize(m0).H(d)
        for b in range(2):
            a = np.asarray(ga.getblock(b)).ravel()
            i = np.asarray(gi.getblock(b)).ravel()
            cos = float(np.dot(a, i)
                        / (np.linalg.norm(a) * np.linalg.norm(i) + 1e-30))
            assert cos > 0.95, f"block {b} cosine {cos}"

    def test_q_bf16_coeff_mode_matches_autodiff(self):
        from jets_tpu.ops.wave import q_wave_propagator

        kw = dict(self.KW, coeff_dtype=jnp.bfloat16)
        Fa = q_wave_propagator(self.SHAPE, **kw)
        Fs = q_wave_propagator(self.SHAPE, store_adjoint="f32", **kw)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = Fa.dom.zeros().setblock(0, full(1500.0)).setblock(1, full(25.0))
        d = Fa.rng.randn(jax.random.PRNGKey(84)).astype(jnp.float32)
        self._cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), 2)

    def test_vd_f32_storage_matches_autodiff(self):
        Fa = vd_wave_propagator(self.SHAPE, **self.KW)
        from jets_tpu.ops.wave import vd_wave_propagator as mk
        Fs = mk(self.SHAPE, store_adjoint="f32", **self.KW)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = Fa.dom.zeros().setblock(0, full(2000.0)).setblock(1, full(1e-3))
        d = Fa.rng.randn(jax.random.PRNGKey(85)).astype(jnp.float32)
        self._cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), 2)

    def test_vd_heterogeneous_b_matches_autodiff(self):
        """Non-constant buoyancy exercises the hand-derived L_b
        b-transpose (_div_b_grad_bbar) nontrivially."""
        from jets_tpu.ops.wave import vd_wave_propagator as mk

        Fa = mk(self.SHAPE, **self.KW)
        Fs = mk(self.SHAPE, store_adjoint="f32", **self.KW)
        key = jax.random.PRNGKey(86)
        b = 1e-3 * (1.0 + 0.3 * jax.random.uniform(key, self.SHAPE))
        m0 = (Fa.dom.zeros()
              .setblock(0, jnp.full(self.SHAPE, 2000.0, jnp.float32))
              .setblock(1, b.astype(jnp.float32)))
        d = Fa.rng.randn(jax.random.PRNGKey(87)).astype(jnp.float32)
        self._cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), 2)

    def test_vdq_f32_storage_matches_autodiff(self):
        from jets_tpu.ops.wave import vdq_wave_propagator

        Fa = vdq_wave_propagator(self.SHAPE, **self.KW)
        Fs = vdq_wave_propagator(self.SHAPE, store_adjoint="f32",
                                 **self.KW)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = (Fa.dom.zeros().setblock(0, full(2000.0))
              .setblock(1, full(1e-3)).setblock(2, full(25.0)))
        d = Fa.rng.randn(jax.random.PRNGKey(88)).astype(jnp.float32)
        self._cmp_blocks(Fa.linearize(m0).H(d), Fs.linearize(m0).H(d), 3)

    def test_vdq_dot_gate_and_dtrec(self):
        from jets_tpu.ops.wave import vdq_wave_propagator

        kw = dict(self.KW, dtrec=1.6e-3)
        Fs = vdq_wave_propagator(self.SHAPE, store_adjoint="f32", **kw)
        full = lambda v: jnp.full(self.SHAPE, v, jnp.float32)  # noqa: E731
        m0 = (Fs.dom.zeros().setblock(0, full(2000.0))
              .setblock(1, full(1e-3)).setblock(2, full(25.0)))
        J = Fs.linearize(m0)
        mm = J.dom.randn(jax.random.PRNGKey(89))
        dd = J.rng.randn(jax.random.PRNGKey(90)).astype(jnp.float32)
        lhs, rhs = jt.dot_product_test(J, mm, dd)
        np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

    def test_store_validation(self):
        from jets_tpu.ops.wave import q_wave_propagator, \
            vdq_wave_propagator

        with pytest.raises(ValueError, match="store_adjoint"):
            q_wave_propagator(self.SHAPE, store_adjoint="int4", **self.KW)
        with pytest.raises(ValueError, match="store_adjoint"):
            vdq_wave_propagator(self.SHAPE, store_adjoint="fp8", **self.KW)


def test_multishot_boundary_options():
    """free_surface and CPML on the multishot operator (marine production
    multishot): free-surface physics matches the single-shot propagator
    per shot, the stored free-surface gradient matches autodiff, and CPML
    shots run with the autodiff adjoint + gate."""
    from jets_tpu.ops.wave import (cpml_wave_propagator,
                                   multishot_wave_operator,
                                   wave_propagator)

    grid = (20, 20)
    srcs = jnp.array([20 * 6 + 6, 20 * 6 + 13], jnp.int32)
    kw = dict(nt=30, dt=8e-4, dx=10.0, freq=18.0, sponge_width=4,
              dtype=jnp.float32)
    c0 = jnp.full(grid, 1500.0, jnp.float32)

    # free surface: per-shot parity vs the single-shot propagator
    Fms = multishot_wave_operator(grid, srcs, free_surface=True, **kw)
    d = Fms(c0)
    assert float(jnp.max(jnp.abs(d))) > 0.0
    for k in range(2):
        F1 = wave_propagator(grid, src_idx=int(srcs[k]),
                             free_surface=True, **kw)
        np.testing.assert_allclose(np.asarray(d[k]), np.asarray(F1(c0)),
                                   rtol=1e-6, atol=1e-12)
    # and it differs from the all-absorbing default (the surface ghost)
    d_abs = multishot_wave_operator(grid, srcs, **kw)(c0)
    assert float(jnp.max(jnp.abs(d - d_abs))) > 1e-3 * float(
        jnp.max(jnp.abs(d)))

    # free-surface stored adjoint matches autodiff
    Fs = multishot_wave_operator(grid, srcs, free_surface=True,
                                 store_adjoint="f32", **kw)
    dd = Fms.rng.randn(jax.random.PRNGKey(91)).astype(jnp.float32)
    ga = np.asarray(Fms.linearize(c0).H(dd))
    gs = np.asarray(Fs.linearize(c0).H(dd))
    scale = float(np.max(np.abs(ga)))
    assert scale > 0.0
    np.testing.assert_allclose(gs / scale, ga / scale, rtol=1e-5,
                               atol=2e-5)

    # CPML: per-shot parity vs the single-shot CPML propagator + gate
    Fc = multishot_wave_operator(grid, srcs, boundary="cpml", **kw)
    dc = Fc(c0)
    for k in range(2):
        F1 = cpml_wave_propagator(grid, src_idx=int(srcs[k]),
                                  pml_width=4, nt=30, dt=8e-4, dx=10.0,
                                  freq=18.0, dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(dc[k]), np.asarray(F1(c0)),
                                   rtol=1e-6, atol=1e-12)
    J = Fc.linearize(c0)
    mm = J.dom.randn(jax.random.PRNGKey(92)).astype(jnp.float32)
    rr = J.rng.randn(jax.random.PRNGKey(93)).astype(jnp.float32)
    lhs, rhs = jt.dot_product_test(J, mm, rr)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=2e-4)

    with pytest.raises(ValueError, match="boundary"):
        multishot_wave_operator(grid, srcs, boundary="pml", **kw)
    with pytest.raises(ValueError, match="CPML"):
        multishot_wave_operator(grid, srcs, boundary="cpml",
                                store_adjoint="f32", **kw)


def test_offgrid_stored_adjoint_matches_autodiff():
    """Off-grid acquisition + stored-history adjoint: the fractional
    source mask rides the forward sweep and the reverse injection is the
    derived transpose of the Kaiser-sinc extraction."""
    from jets_tpu.ops.wave import offgrid_wave_propagator

    n = 24
    kw = dict(src_pos=(11.3, 12.6), rcv_depth=5.45,
              rcv_coords=np.linspace(4.2, 19.7, 9), nt=40, dt=0.0008,
              dx=10.0, freq=18.0, sponge_width=4, dtype=jnp.float32)
    Fa = offgrid_wave_propagator((n, n), **kw)
    Fs = offgrid_wave_propagator((n, n), store_adjoint="f32", **kw)
    c0 = jnp.full((n, n), 2000.0, jnp.float32)
    d = Fa.rng.randn(jax.random.PRNGKey(95)).astype(jnp.float32)
    ga = np.asarray(Fa.linearize(c0).H(d))
    gs = np.asarray(Fs.linearize(c0).H(d))
    scale = float(np.max(np.abs(ga)))
    assert scale > 0.0, "vacuous: zero adjoint"
    np.testing.assert_allclose(gs / scale, ga / scale, rtol=1e-5,
                               atol=2e-5)

    # composes with dtrec (unresample before the sweep)
    kwr = dict(kw, dtrec=1.6e-3)
    Far = offgrid_wave_propagator((n, n), **kwr)
    Fsr = offgrid_wave_propagator((n, n), store_adjoint="f32", **kwr)
    dr = Far.rng.randn(jax.random.PRNGKey(96)).astype(jnp.float32)
    gar = np.asarray(Far.linearize(c0).H(dr))
    gsr = np.asarray(Fsr.linearize(c0).H(dr))
    sc = float(np.max(np.abs(gar)))
    assert sc > 0.0
    np.testing.assert_allclose(gsr / sc, gar / sc, rtol=1e-5, atol=2e-5)
