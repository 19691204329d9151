"""Example 7 — simultaneous-source deblending by sparse inversion.

A blended acquisition fires ``nshots`` overlapping sources into ONE
continuous record ``d = B m`` (``blend_operator`` — pad/roll/sum, no
scatter). Recovering the unblended gather ``m`` is underdetermined where
shots overlap; solving damped LSQR on ``B`` composed with a causal
integration (sparsity-in-difference prior, the classic deblending trick)
gives a useful (L2) separation; full separation needs a sparsity solver on top of the same operators.

Run: ``python examples/07_deblending.py``
"""

import jax
import jax.numpy as jnp
import numpy as np

import jets_tpu as jt
from jets_tpu.ops import blend_operator, integration_operator
from jets_tpu.solvers import lsqr


def main():
    nshots, nt = 16, 400
    rng = np.random.default_rng(0)
    # dense firing schedule: shots overlap by ~25%
    t0 = np.sort(rng.integers(0, (3 * nshots * nt) // 4, nshots))
    T = int(t0.max()) + nt
    B = blend_operator(nshots, nt, t0, T)

    # mandatory adjoint gate before solving
    lhs, rhs = jt.dot_product_test(
        B, B.dom.randn(jax.random.PRNGKey(0)), B.rng.randn(jax.random.PRNGKey(1))
    )
    print(f"dot-product gate: {float(lhs):.6f} vs {float(rhs):.6f}")

    # synthetic unblended gather: a few spiky arrivals per shot, integrated
    # once so traces are piecewise-smooth
    spikes = np.zeros((nshots, nt), np.float32)
    for s in range(nshots):
        idx = rng.integers(20, nt - 20, 4)
        spikes[s, idx] = rng.standard_normal(4)
    S = integration_operator(jt.Space((nshots, nt), jnp.float32), axis=1)
    m_true = S(jnp.asarray(spikes))
    d = B(m_true)

    # solve in the spike domain: d = (B ∘ S) z, m = S z — the integration
    # prior concentrates energy, which is what separates overlapping shots
    A = B @ S
    res = lsqr(A, d, maxiter=400, tol=1e-10, damp=1e-3)
    m_est = S(res.x)

    rel = float(jnp.linalg.norm(m_est - m_true) / jnp.linalg.norm(m_true))
    relres = float(B.rng.norm(B(m_est) - d) / B.rng.norm(d))
    print(f"LSQR: {int(res.iterations)} iterations")
    print(f"blended-data residual {relres:.2e}, model error {rel:.2e}")


if __name__ == "__main__":
    main()
