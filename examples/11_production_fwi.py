"""Example 11 — production-style FWI: velocity bounds, recording-grid
data, stored compressed-wavefield gradients.

Three round-3 features together, the way a production inversion uses them:

* ``dtrec=`` — the FD scheme steps at the CFL-limited modeling ``dt``
  while the observed data live on a coarser recording grid (the reference
  family's dtmod/dtrec split); the operator's range IS the recording grid,
  so observed data plug in directly;
* ``store_adjoint="int8"`` — gradients come from an on-device
  per-snapshot-scaled int8 copy of the forward wavefield (4× less adjoint
  memory, no recompute — the CvxCompress trade of JetPackWaveFD's
  production imaging);
* ``bounds=(lo, hi)`` on L-BFGS — trial models are projected onto the
  velocity box every line-search step, and convergence is measured by the
  projected gradient.

Run: ``python examples/11_production_fwi.py``
"""

import jax
import jax.numpy as jnp

from jets_tpu.solvers import lbfgs, least_squares_objective


def main():
    from jets_tpu.ops.wave import wave_propagator

    grid = (32, 32)
    lo, hi = 1400.0, 1700.0
    F = wave_propagator(
        grid, nt=240, dt=1e-3, dx=10.0, freq=12.0, src_idx=32 * 4 + 16,
        sponge_width=5,
        dtrec=4e-3,               # record every 4 ms, model at 1 ms
        store_adjoint="int8",     # compressed stored-wavefield gradient
        dtype=jnp.float32,
    )
    print(f"modeling steps: 240 @ 1 ms; recording grid: {F.rng.shape[0]} "
          f"samples @ 4 ms")

    key = jax.random.PRNGKey(0)
    c_true = jnp.clip(
        1500.0 + 60.0 * jax.random.normal(key, grid, jnp.float32), lo, hi)
    d_obs = F(c_true)

    fg = least_squares_objective(F, d_obs)
    c0 = jnp.full(grid, 1500.0, jnp.float32)
    res = lbfgs(fg, c0, maxiter=15, mem=5, tol=1e-8, bounds=(lo, hi))

    phi0 = float(fg(c0)[0])
    print(f"phi: {phi0:.3e} -> {float(res.phi):.3e} "
          f"({int(res.iterations)} iterations)")
    m = res.m
    print(f"model range: [{float(m.min()):.1f}, {float(m.max()):.1f}] "
          f"(box [{lo}, {hi}])")
    assert float(m.min()) >= lo - 1e-3 and float(m.max()) <= hi + 1e-3
    assert float(res.phi) < 0.2 * phi0
    err0 = float(jnp.linalg.norm(c0 - c_true))
    err = float(jnp.linalg.norm(m - c_true))
    print(f"model error: {err0:.1f} -> {err:.1f}")
    assert err < err0
    print("ok")


if __name__ == "__main__":
    main()
