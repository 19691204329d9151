"""Example 09 — Multi-parameter FWI on a block-vector model.

The variable-density propagator's model is a ``BlockSpace`` holding
velocity ``c`` and buoyancy ``b = 1/ρ`` (the reference family's
multi-parameter model is exactly a block vector, ``src/Jets.jl:736-760``).
Everything downstream — the least-squares objective, the adjoint-state
gradient, L-BFGS's two-loop recursion and line search — runs on the block
pytree unchanged.

Run: ``python examples/09_multiparameter_fwi.py`` (CPU-friendly sizes).
"""

import jax
import jax.numpy as jnp

from jets_tpu.ops.wave import vd_wave_propagator
from jets_tpu.solvers import lbfgs, least_squares_objective

n = 24
grid = (n, n)

F = vd_wave_propagator(
    grid, nt=48, dt=0.0008, dx=10.0, freq=18.0,
    src_idx=n * (n // 2) + n // 2, sponge_width=4, dtype=jnp.float32,
)

# true model: background + a velocity anomaly and a density anomaly
c_bg = jnp.full(grid, 2000.0, jnp.float32)
b_bg = jnp.full(grid, 1e-3, jnp.float32)          # rho = 1000 kg/m^3
m_true = F.dom.zeros().setblock(
    0, c_bg.at[8:12, 8:12].add(80.0)).setblock(
    1, b_bg.at[14:18, 6:10].mul(1.2))
d_obs = F(m_true)

# start from the smooth background
m0 = F.dom.zeros().setblock(0, c_bg).setblock(1, b_bg)
fg = least_squares_objective(F, d_obs)
phi0, g0 = fg(m0)
print(f"initial misfit: {float(phi0):.4e}  "
      f"(grad blocks: |g_c|={float(jnp.linalg.norm(g0.getblock(0))):.2e}, "
      f"|g_b|={float(jnp.linalg.norm(g0.getblock(1))):.2e})")

res = lbfgs(fg, m0, maxiter=15, mem=5, tol=0.0)
phi1, _ = fg(res.m)
print(f"misfit after {int(res.iterations)} L-BFGS iterations: "
      f"{float(phi1):.4e}  ({float(phi1) / float(phi0):.3f} of initial)")
assert float(phi1) < 0.5 * float(phi0)
print("done")
