"""Example 13 — production anisotropic + attenuating gradients from
stored compressed wavefield histories (round-5 features together).

Three gradient paths a production imaging shop runs daily, all through
the SAME jet/solver machinery:

* **VTI FWI gradient** from the stored two-field history
  (``vti_wave_propagator(store_adjoint="int8")``) — the hand-derived
  transposed sweep reads the int8 history instead of recomputing the
  forward;
* **IsoDenQ gradient** — velocity, buoyancy AND attenuation
  (``vdq_wave_propagator``, the Prop*AcoIsoDenQ parameter set) with the
  hand-derived Kosloff-friction transpose: one reverse pass returns the
  full (δc, δb, δQ) BlockVector;
* **attenuating VTI** (``q=``): static constant-Q friction composed with
  the stored anisotropic sweep — the ``Prop*AcoVTIDenQ`` slot.

Run: ``python examples/13_anisotropic_denq_gradient.py``
"""

import jax
import jax.numpy as jnp

from jets_tpu.ops.wave import vdq_wave_propagator, vti_wave_propagator


def main():
    grid = (24, 24)
    kw = dict(nt=36, dt=8e-4, dx=10.0, freq=18.0, src_idx=12 * 24 + 12,
              sponge_width=4, dtype=jnp.float32)
    full = lambda v: jnp.full(grid, v, jnp.float32)  # noqa: E731

    # --- VTI gradient from the stored int8 two-field history ----------
    F = vti_wave_propagator(grid, store_adjoint="int8", **kw)
    m0 = (F.dom.zeros().setblock(0, full(1500.0))
          .setblock(1, full(0.1)).setblock(2, full(0.05)))
    # synthetic observed data from a perturbed model -> physical residual
    d_obs = F(m0.setblock(0, full(1530.0)))
    r = F(m0) - d_obs
    g = F.linearize(m0).H(r)
    names = ("velocity", "epsilon", "delta")
    print("VTI stored-int8 gradient blocks:")
    for b, nm in enumerate(names):
        print(f"  d{nm:<9} |g|max = "
              f"{float(jnp.max(jnp.abs(g.getblock(b)))):.3e}")

    # --- full IsoDenQ (c, b, Q) gradient ------------------------------
    Fq = vdq_wave_propagator(grid, store_adjoint="int8", **kw)
    mq = (Fq.dom.zeros().setblock(0, full(2000.0))
          .setblock(1, full(1e-3)).setblock(2, full(30.0)))
    dq_obs = Fq(mq.setblock(2, full(20.0)))     # attenuation anomaly
    rq = Fq(mq) - dq_obs
    gq = Fq.linearize(mq).H(rq)
    print("IsoDenQ stored-int8 gradient blocks:")
    for b, nm in enumerate(("velocity", "buoyancy", "Q")):
        print(f"  d{nm:<9} |g|max = "
              f"{float(jnp.max(jnp.abs(gq.getblock(b)))):.3e}")

    # --- attenuating VTI: static Q + stored anisotropic sweep ---------
    Fv = vti_wave_propagator(grid, q=25.0, store_adjoint="f32", **kw)
    gv = Fv.linearize(m0).H(r)
    print("VTI+staticQ stored gradient |g|max =",
          f"{float(jnp.max(jnp.abs(gv.getblock(0)))):.3e}")

    assert float(jnp.max(jnp.abs(g.getblock(0)))) > 0
    assert float(jnp.max(jnp.abs(gq.getblock(2)))) > 0
    print("done")


if __name__ == "__main__":
    main()
