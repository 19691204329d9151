"""The XLA wave paths against independent references.

Forward steps (isotropic and Kosloff-Q) are checked against a small numpy
float64 leapfrog written here; stored-wavefield adjoints against the
autodiff adjoint of the same propagator. Every comparison is guarded
against a vacuous (identically zero) signal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import jets_tpu as jt
from jets_tpu.ops.wave import (q_wave_propagator, tti_wave_propagator,
                               vti_wave_propagator, wave_propagator)

SHAPE = (10, 8, 12)
SRC_ZYX = (5, 4, 6)
SRC = int(np.ravel_multi_index(SRC_ZYX, SHAPE))
# receivers on the x-line through the source: reached in the first steps
RCV = np.asarray([np.ravel_multi_index((5, 4, x), SHAPE)
                  for x in range(SHAPE[2])], np.int32)
KW = dict(dt=6e-4, dx=10.0, freq=16.0, src_idx=SRC, rcv_idx=RCV,
          sponge_width=3)
F0 = 25.0
Q = 40.0

# second-derivative taps (c0; c1, c2, ...) — standard Taylor tables
D2 = {
    2: (-2.0, (1.0,)),
    4: (-2.5, (4.0 / 3.0, -1.0 / 12.0)),
    8: (-205.0 / 72.0, (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)),
}


def _assert_live(x):
    assert float(np.max(np.abs(np.asarray(x)))) > 0.0, \
        "signal is identically zero — the comparison would be vacuous"


def np_laplacian(u, order):
    c0, cs = D2[order]
    hw = len(cs)
    p = np.pad(u, hw)
    core = tuple(slice(hw, -hw) for _ in u.shape)
    out = u.ndim * c0 * u
    for ax in range(u.ndim):
        for s, c in enumerate(cs, start=1):
            lo, hi = list(core), list(core)
            lo[ax] = slice(hw - s, p.shape[ax] - hw - s)
            hi[ax] = slice(hw + s, p.shape[ax] - hw + s)
            out = out + c * (p[tuple(lo)] + p[tuple(hi)])
    return out


def np_sponge(shape, width, strength=0.015):
    s = np.ones(shape)
    for ax, n in enumerate(shape):
        x = np.arange(n)
        edge = np.minimum(x, n - 1 - x)
        damp = np.where(edge < width,
                        np.exp(-strength * (width - edge) ** 2 / width), 1.0)
        s = s * damp.reshape([n if i == ax else 1 for i in range(len(shape))])
    return s


def np_ricker(nt, dt, freq):
    t0 = min(1.0 / freq, 0.25 * nt * dt)
    a = (np.pi * freq * (np.arange(nt) * dt - t0)) ** 2
    return (1.0 - 2.0 * a) * np.exp(-a)


def np_leapfrog(c, nt, *, order, q=None, g_round=None):
    """Sponge-damped leapfrog with optional Kosloff friction
    ``g = π f0 dt / Q``: u⁺ = S·(2u − (1−g)u⁻ + (c dt/dx)²∇²u)/(1+g)
    + s_k dt² δ_src; returns the receiver rows (nt, nrcv)."""
    dt, dx = KW["dt"], KW["dx"]
    C = (c * dt / dx) ** 2
    g = 0.0 if q is None else np.pi * F0 * dt / q
    if g_round is not None:
        g = g_round(g)
    S = np_sponge(c.shape, KW["sponge_width"])
    wav = np_ricker(nt, dt, KW["freq"])
    u_prev = np.zeros(c.shape)
    u = np.zeros(c.shape)
    rows = []
    for k in range(nt):
        e = (2.0 * u - (1.0 - g) * u_prev + C * np_laplacian(u, order)) \
            / (1.0 + g)
        u_next = e * S
        u_next.flat[SRC] += wav[k] * dt * dt
        rows.append(u_next.reshape(-1)[RCV])
        u_prev, u = u, u_next
    return np.stack(rows)


def _velocity():
    return 1500.0 + 30.0 * np.asarray(
        jax.random.normal(jax.random.PRNGKey(3), SHAPE, jnp.float64))


def _apply(physics, c, nt, order, **extra):
    cj = jnp.asarray(c)
    if physics == "iso":
        F = wave_propagator(SHAPE, nt=nt, space_order=order,
                            dtype=jnp.float64, **KW, **extra)
        return F(cj)
    F = q_wave_propagator(SHAPE, nt=nt, space_order=order, f0=F0,
                          dtype=jnp.float64, **KW, **extra)
    m = F.dom.zeros().setblock(0, cj).setblock(
        1, jnp.full(SHAPE, Q, jnp.float64))
    return F(m)


@pytest.mark.parametrize("nt", [20, 21])
@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("physics", ["iso", "q"])
def test_forward_matches_numpy_leapfrog(physics, order, nt):
    c = _velocity()
    got = np.asarray(_apply(physics, c, nt, order))
    want = np_leapfrog(c, nt, order=order, q=Q if physics == "q" else None)
    _assert_live(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("physics", ["iso", "q"])
def test_forward_remat_matches_numpy_leapfrog(physics):
    c = _velocity()
    got = np.asarray(_apply(physics, c, 24, 2, remat_blocks=4))
    want = np_leapfrog(c, 24, order=2, q=Q if physics == "q" else None)
    _assert_live(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))


@pytest.mark.parametrize("physics", ["iso", "q"])
def test_forward_dtrec_matches_numpy_interpolation(physics):
    nt, dtrec = 21, 2.5 * KW["dt"]
    c = _velocity()
    got = np.asarray(_apply(physics, c, nt, 2, dtrec=dtrec))
    fine = np_leapfrog(c, nt, order=2, q=Q if physics == "q" else None)
    _assert_live(fine)
    t_rec = np.arange(got.shape[0]) * dtrec
    t_fine = np.arange(nt) * KW["dt"]
    want = np.stack([np.interp(t_rec, t_fine, fine[:, j])
                     for j in range(fine.shape[1])], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))


def test_q_bf16_coeff_rounds_the_friction_field():
    """``coeff_dtype=bfloat16`` runs the forward with g = π f0 dt/Q rounded
    to bf16 and nothing else changed."""
    import ml_dtypes  # noqa: F401 — bf16 for numpy, shipped with jax

    def to_bf16(g):
        return float(np.asarray(g, np.float32).astype("bfloat16")
                     .astype(np.float64))

    c = _velocity()
    got = np.asarray(_apply("q", c, 20, 2, coeff_dtype=jnp.bfloat16))
    want = np_leapfrog(c, 20, order=2, q=Q, g_round=to_bf16)
    exact = np_leapfrog(c, 20, order=2, q=Q)
    _assert_live(want)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(want)))
    assert np.max(np.abs(want - exact)) > 0.0, "rounding changed nothing"


# --------------------------------------------------------------------------
# stored-wavefield adjoints against the autodiff adjoint
# --------------------------------------------------------------------------

ANISO = {"vti": (vti_wave_propagator, (1500.0, 0.1, 0.05)),
         "tti": (tti_wave_propagator, (1500.0, 0.1, 0.05, 0.2, 0.7))}


def _ops(physics, nt, order, store):
    kw = dict(nt=nt, space_order=order, dtype=jnp.float64, **KW)
    if physics == "iso":
        mk = wave_propagator
    elif physics == "q":
        mk = q_wave_propagator
        kw["f0"] = F0
    else:
        mk = ANISO[physics][0]
    Fa = mk(SHAPE, **kw)
    Fs = mk(SHAPE, store_adjoint=store, **kw)
    c = jnp.asarray(_velocity())
    if physics == "iso":
        return Fa, Fs, c, lambda m, s: m * s
    if physics == "q":
        m = Fa.dom.zeros().setblock(0, c).setblock(
            1, jnp.full(SHAPE, Q, jnp.float64))
    else:
        m = Fa.dom.zeros().setblock(0, c)
        for b, v in enumerate(ANISO[physics][1][1:], start=1):
            m = m.setblock(b, jnp.full(SHAPE, v, jnp.float64))
    return Fa, Fs, m, lambda m, s: m.setblock(0, m.getblock(0) * s)


def _blocks(g):
    if isinstance(g, jax.Array):
        return [np.asarray(g)]
    return [np.asarray(b) for b in g.blocks]


@pytest.mark.parametrize("order,store", [(4, "f32"), (8, "f32"),
                                         (2, "bf16")])
@pytest.mark.parametrize("physics", ["iso", "vti", "tti", "q"])
def test_stored_adjoint_matches_autodiff(physics, order, store):
    """Odd ``nt``, higher orders and the bf16 history: exact to roundoff
    for the lossless store, gradient direction for the lossy one."""
    Fa, Fs, m, scale_c = _ops(physics, 23, order, store)
    d = Fa(scale_c(m, 1.02)) - Fa(m)      # a physical residual
    _assert_live(d)
    ga = _blocks(Fa.linearize(m).H(d))
    gs = _blocks(Fs.linearize(m).H(d))
    for b, (a, s) in enumerate(zip(ga, gs)):
        _assert_live(a)
        if store == "f32":
            np.testing.assert_allclose(s, a, rtol=1e-9,
                                       atol=1e-9 * np.max(np.abs(a)),
                                       err_msg=f"block {b}")
        else:
            cos = float(a.ravel() @ s.ravel()
                        / (np.linalg.norm(a) * np.linalg.norm(s)))
            assert cos > 0.999, f"block {b}: cosine {cos}"


def test_tti_bf16_coeff_primal_rounded_tangent_exact():
    """bf16 coefficient mode: the primal differs from the f32 mode by the
    coefficient rounding only, and the straight-through linearization
    still passes the dot-product gate to roundoff."""
    kw = dict(nt=16, dtype=jnp.float64, **KW)
    F32 = tti_wave_propagator(SHAPE, **kw)
    F16 = tti_wave_propagator(SHAPE, coeff_dtype=jnp.bfloat16, **kw)
    m = F32.dom.zeros().setblock(0, jnp.asarray(_velocity()))
    for b, v in enumerate((0.1, 0.05, 0.2, 0.7), start=1):
        m = m.setblock(b, jnp.full(SHAPE, v, jnp.float64))
    d32, d16 = np.asarray(F32(m)), np.asarray(F16(m))
    _assert_live(d32)
    rel = np.linalg.norm(d16 - d32) / np.linalg.norm(d32)
    assert 0.0 < rel < 1e-2, rel
    J = F16.linearize(m)
    lhs, rhs = jt.dot_product_test(J, J.dom.randn(jax.random.PRNGKey(5)),
                                   J.rng.randn(jax.random.PRNGKey(6)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-9)


def test_bf16_coeff_validation():
    with pytest.raises(ValueError, match="3-D only"):
        tti_wave_propagator((16, 16), nt=4, coeff_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="coeff_dtype"):
        tti_wave_propagator(SHAPE, nt=4, coeff_dtype=jnp.float16)
    with pytest.raises(ValueError, match="coeff_dtype"):
        q_wave_propagator(SHAPE, nt=4, coeff_dtype=jnp.int8)
