"""Example 6 — DSP + wavelet processing chain as one operator.

A seismic-trace processing workflow built entirely from the operator
algebra: taper → bandpass → fractional shift, solved BACKWARDS by damped
LSQR (deprocessing = least-squares inversion of the chain), plus a
wavelet-domain view of the result. Everything is one fused XLA program
under jit; the chain passes the dot-product gate like any single operator.

Run: ``python examples/06_dsp_wavelet_processing.py``
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import jets_tpu as jt
from jets_tpu.ops import (
    bandpass_operator,
    shift_operator,
    taper_operator,
    wavelet_operator,
)
from jets_tpu.solvers import lsqr


def main():
    ntr, nt, dt = 16, 512, 0.004
    sp = jt.Space((ntr, nt), jnp.float64)

    # the processing chain, composed like matrices
    T = taper_operator(sp, (0, 32))
    B = bandpass_operator(sp, dt, 8.0, 45.0, f_taper=4.0, axis=-1)
    S = shift_operator(sp, 3.5 * dt, dt=dt, axis=-1)
    A = S @ B @ T

    # verify the whole chain as one operator
    m = sp.randn(jax.random.PRNGKey(0))
    d = sp.randn(jax.random.PRNGKey(1))
    lhs, rhs = jt.dot_product_test(A, m, d)
    print(f"chain dot-product test: {float(lhs):+.6e} vs {float(rhs):+.6e}")

    # synthesize data: band-limited reflectivity-ish traces
    key = jax.random.PRNGKey(7)
    m_true = bandpass_operator(sp, dt, 2.0, 18.0)(sp.randn(key))
    d_obs = A(m_true)

    # invert the processing (damped LS — the chain kills out-of-band energy,
    # damping keeps the nullspace quiet)
    res = lsqr(A, d_obs, maxiter=200, tol=1e-10, damp=1e-4)
    rel = float(A.rng.norm(A(res.x) - d_obs) / A.rng.norm(d_obs))
    print(f"lsqr deprocessing: {int(res.iterations)} iters, "
          f"relative data misfit {rel:.2e}")

    # wavelet-domain compression of the recovered section
    W = wavelet_operator(sp, "db2", levels=3, axes=(1,))
    c = W(res.x)
    thresh = jnp.quantile(jnp.abs(c), 0.90)
    c_sparse = jnp.where(jnp.abs(c) > thresh, c, 0.0)
    x_compressed = jt.adjoint(W)(c_sparse)
    err = float(sp.norm(x_compressed - res.x) / sp.norm(res.x))
    print(f"wavelet 10%-coefficient reconstruction error: {err:.1%}")


if __name__ == "__main__":
    main()
