"""Example 3 — miniature full-waveform inversion (FWI).

A nonlinear wave propagator jet, linearized per Gauss–Newton iteration
(``upstate`` machinery at work), with CGLS inner solves on the Born
operator. This is the reference family's flagship nonlinear workflow
(COFII FWI) end-to-end in ~30 lines.

Run: ``python examples/03_fwi_gauss_newton.py``
"""

import jax

# FWI in physical units needs f64: squared gradient norms underflow f32
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from jets_tpu.ops.wave import wave_propagator
from jets_tpu.solvers import gauss_newton


def main():
    grid = (32, 32)
    # dt sized for CFL ~0.45 so the wavefront crosses the grid in ~nt steps
    F = wave_propagator(grid, nt=200, dt=0.0022, dx=10.0, freq=12.0,
                        src_idx=32 * 16 + 16, sponge_width=5,
                        dtype=jnp.float64)
    c_true = jnp.full(grid, 2000.0, jnp.float64).at[18:24, 18:24].add(150.0)
    d_obs = F(c_true)
    dnorm = float(F.rng.norm(d_obs))

    c0 = jnp.full(grid, 2000.0, jnp.float64)
    res = gauss_newton(F, d_obs, c0, outer_iters=4, inner_iters=15,
                       inner_tol=1e-8)
    print("relative data residual per outer iteration:",
          [f"{r / dnorm:.3e}" for r in res.residuals])


if __name__ == "__main__":
    main()
