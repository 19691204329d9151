"""Example 1 — sparse-spike deconvolution with the operator algebra.

Builds ``A = D ∘ S`` (derivative after wavelet convolution), generates data
from a sparse reflectivity, and solves with LSQR — the canonical matrix-free
workflow of the reference framework (docs ``lsqr(vec(A), vec(d))``), without
any vec bridge.

Run: ``python examples/01_deconvolution.py``
"""

import jax
import jax.numpy as jnp

import jets_tpu as jt
from jets_tpu.ops.conv import conv1d_operator, derivative_operator
from jets_tpu.solvers import lsqr


def main():
    n = 2000
    t = jnp.arange(25, dtype=jnp.float32)
    wavelet = jnp.exp(-0.5 * ((t - 12.0) / 3.0) ** 2)

    S = conv1d_operator(wavelet, n)       # wavelet convolution
    D = derivative_operator(n)            # first difference
    A = D @ S                             # composition (flattens, fuses)

    # mandatory adjoint gate before solving
    lhs, rhs = jt.dot_product_test(
        A, A.dom.randn(jax.random.PRNGKey(0)), A.rng.randn(jax.random.PRNGKey(1))
    )
    print(f"dot-product gate: {float(lhs):.6f} vs {float(rhs):.6f}")

    key = jax.random.PRNGKey(42)
    x_true = jnp.zeros((n,)).at[jax.random.randint(key, (20,), 50, n - 50)].set(1.0)
    d = A(x_true)

    res = lsqr(A, d, maxiter=300, tol=1e-8, damp=1e-4)
    rel = float(A.rng.norm(A(res.x) - d)) / float(A.rng.norm(d))
    print(f"LSQR: {int(res.iterations)} iterations, relative residual {rel:.2e}")


if __name__ == "__main__":
    main()
