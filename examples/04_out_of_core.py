"""Example 4 — out-of-core inversion with the native data loader.

When the observed data for all shots exceeds device memory, stream shot
blocks from the on-disk store (C++ background prefetch) and accumulate the
model gradient blockwise — steepest-descent on the normal equations with
the per-block operators from the block algebra.

Run: ``JAX_PLATFORMS=cpu python examples/04_out_of_core.py``
"""
import os
import tempfile

import jax
import jax.numpy as jnp

from jets_tpu.models.seismic import make_seismic_operator
from jets_tpu.utils.dataloader import ShotGatherLoader, ShotGatherStore


def main():
    grid, nshots, nrecv, batch = (128, 128), 32, 256, 8
    A = make_seismic_operator(grid, nshots, nrecv, jax.random.PRNGKey(0))
    m_true = jax.random.normal(jax.random.PRNGKey(1), grid) * 0.1
    d_obs = A(m_true)

    # persist the data like a field dataset, then stream it back per block
    path = os.path.join(tempfile.mkdtemp(), "shots.bin")
    store = ShotGatherStore.create(path, d_obs)
    loader = ShotGatherLoader(store, batch_shots=batch, queue_depth=2)
    print(f"store: {nshots} shots, native prefetch: {loader.native}")

    # one streamed gradient: g = sum_blocks J_b' (J_b m - d_b), where J_b is
    # the rows of A for that shot block (a restriction of the stacked range)
    @jax.jit
    def block_grad(op, m, d_block, lo):
        d_pred = jax.lax.dynamic_slice_in_dim(op(m), lo, d_block.shape[0])
        r = d_pred - d_block
        full = jnp.zeros(op.rng.shape, d_block.dtype)
        full = jax.lax.dynamic_update_slice_in_dim(full, r, lo, axis=0)
        return op.H(full)

    m = jnp.zeros(grid)
    for step in range(3):
        g = jnp.zeros(grid)
        for idx, block in loader:
            g = g + block_grad(A, m, jnp.asarray(block), idx * batch)
        m = m - 0.4 * g / (1e-9 + float(jnp.linalg.norm(g)))
        rel = float(jnp.linalg.norm(A(m) - d_obs) / jnp.linalg.norm(d_obs))
        print(f"step {step}: streamed gradient, rel residual {rel:.3f}")


if __name__ == "__main__":
    main()
