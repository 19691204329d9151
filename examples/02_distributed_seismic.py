"""Example 2 — distributed multi-shot linearized seismic inversion.

The flagship workload: shots stacked on a leading block axis, sharded over a
device mesh, the adjoint accumulated with one ``psum`` over the mesh, and the
SAME jitted LSQR running unchanged on top.

Single-machine demo on 8 virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/02_distributed_seismic.py
"""

import jax
import jax.numpy as jnp

from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.parallel.sharded import make_block_mesh, shard_blocks
from jets_tpu.solvers import lsqr


def main():
    n_dev = len(jax.devices())
    mesh = make_block_mesh(n_dev) if n_dev > 1 else None
    print(f"devices: {n_dev}, mesh: {mesh.shape if mesh else None}")

    A, m_true, d_obs = make_seismic_problem(
        (256, 256), nshots=max(8, n_dev * 2), nreceivers=512,
        seed=0, mesh=mesh, noise=0.02, dtype=jnp.float32,
    )
    if mesh is not None:
        d_obs = shard_blocks(d_obs, mesh)

    res = lsqr(A, d_obs, maxiter=60, tol=1e-6)
    rel = float(res.resnorm) / float(A.rng.norm(d_obs))
    print(f"distributed LSQR: {int(res.iterations)} iters, rel residual {rel:.3f}")


if __name__ == "__main__":
    main()
