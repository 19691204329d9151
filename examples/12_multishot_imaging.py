"""Example 12 — multishot imaging gradients at production settings: the
BASELINE config-#5 workload shape, scaled down to run anywhere.

Round-4 features together, the way a production RTM/FWI driver uses them:

* ``multishot_wave_operator(store_adjoint="int8", shot_map="map")`` —
  every shot's gradient is a STORED-wavefield adjoint sweep, shots scan
  sequentially per device (one shot's wavefields in memory at a time),
  and shot contributions accumulate through the stacked psum — the reference
  family's block-adjoint loop as one collective;
* anisotropic gradients are first-class: the TTI propagator's
  ``store_adjoint=`` runs the hand-derived transpose of the rotated
  coupled system and returns the full (δc, δε, δδ, δθ, δφ) tuple in one
  reverse pass; ``coeff_dtype=jnp.bfloat16`` streams the five smooth
  coefficient fields at half width (the 3.9×-over-XLA fused TTI config);
* on a mesh, pass ``mesh=make_block_mesh(n)`` and nothing else changes —
  the same script is the multi-chip driver.

Run: ``python examples/12_multishot_imaging.py``
"""

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from jets_tpu.ops.wave import (multishot_wave_operator,
                                   tti_wave_propagator)

    # --- isotropic multishot FWI gradient (config-#5 shape, scaled) ----
    grid = (16, 32, 128)
    rcv = jnp.asarray([np.ravel_multi_index((8, 16, x), grid)
                       for x in range(128)], jnp.int32)
    srcs = jnp.asarray([np.ravel_multi_index((8, 16, 32 + 16 * k), grid)
                        for k in range(4)], jnp.int32)
    F = multishot_wave_operator(
        grid, srcs, nt=24, dt=6e-4, dx=10.0, freq=16.0, rcv_idx=rcv,
        sponge_width=3,
        store_adjoint="int8",    # per-shot stored int8 adjoint sweeps
        shot_map="map",          # shots one after another per device
        dtype=jnp.float32,
    )
    c_true = jnp.full(grid, 1500.0, jnp.float32).at[10:, :, :].set(1560.0)
    c0 = jnp.full(grid, 1500.0, jnp.float32)
    d_obs = F(c_true)

    @jax.jit
    def fwi_gradient(c, d):
        J = F.linearize(c)
        r = F(c) - d
        return 0.5 * jnp.vdot(r, r).real, J.H(r)

    phi, g = fwi_gradient(c0, d_obs)
    print(f"multishot FWI: {len(srcs)} shots, phi={float(phi):.3e}, "
          f"|g|max={float(jnp.max(jnp.abs(g))):.3e}")
    assert float(jnp.max(jnp.abs(g))) > 0.0

    # --- TTI imaging gradient: full 5-parameter tuple in one pass ------
    Ft = tti_wave_propagator(
        grid, nt=24, dt=6e-4, dx=10.0, freq=16.0, rcv_idx=rcv,
        src_idx=int(srcs[0]), sponge_width=3,
        store_adjoint="int8",
        coeff_dtype=jnp.bfloat16,   # half-width smooth coefficient fields
        dtype=jnp.float32,
    )
    full = lambda v: jnp.full(grid, v, jnp.float32)  # noqa: E731
    m0 = Ft.dom.zeros()
    for b, v in enumerate((1500.0, 0.1, 0.05, 0.2, 0.7)):
        m0 = m0.setblock(b, full(v))
    dt_obs = Ft(m0.setblock(0, full(1540.0)))

    @jax.jit
    def tti_gradient(m, d):
        J = Ft.linearize(m)
        return J.H(Ft(m) - d)

    gt = tti_gradient(m0, dt_obs)
    names = ("c", "eps", "delta", "theta", "phi")
    mags = {n: float(jnp.max(jnp.abs(gt.getblock(b))))
            for b, n in enumerate(names)}
    print("TTI 5-parameter gradient |.|max:",
          {k: f"{v:.2e}" for k, v in mags.items()})
    assert all(v > 0.0 for v in mags.values())
    print("ok")


if __name__ == "__main__":
    main()
