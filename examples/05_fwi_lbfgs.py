"""Example 5 — FWI with L-BFGS (adjoint-state gradients).

The same miniature full-waveform inversion as example 3, solved with the
gradient-based nonlinear path instead of Gauss–Newton: the objective
``phi(c) = 1/2 ||F(c) - d||^2`` gets its gradient from the framework's
adjoint machinery (``least_squares_objective``), and the whole L-BFGS
optimization — Armijo line searches included — runs as ONE compiled
``lax.while_loop``.

Run: ``python examples/05_fwi_lbfgs.py``
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from jets_tpu.ops.wave import wave_propagator
from jets_tpu.solvers import lbfgs, least_squares_objective


def main():
    grid = (32, 32)
    F = wave_propagator(grid, nt=200, dt=0.0022, dx=10.0, freq=12.0,
                        src_idx=32 * 16 + 16, sponge_width=5,
                        dtype=jnp.float64)
    c_true = jnp.full(grid, 2000.0, jnp.float64).at[18:24, 18:24].add(150.0)
    d_obs = F(c_true)
    dnorm = float(F.rng.norm(d_obs))

    fg = least_squares_objective(F, d_obs)
    c0 = jnp.full(grid, 2000.0, jnp.float64)
    phi0 = float(fg(c0)[0])

    res = lbfgs(fg, c0, maxiter=80, mem=10, tol=1e-6)
    err = float(jnp.abs(res.m - c_true).max())
    print(f"phi: {phi0:.3e} -> {float(res.phi):.3e} "
          f"in {int(res.iterations)} L-BFGS iterations")
    print(f"relative data residual: "
          f"{(2.0 * float(res.phi)) ** 0.5 / dnorm:.3e}")
    print(f"max velocity error: {err:.1f} m/s (anomaly is 150 m/s)")


if __name__ == "__main__":
    main()
