"""Dense-matrix operator — matrix interop (reference ``src/Jets.jl:325-345``,
``_matmul_df!/_matmul_df′!`` auto-wrap at ``:573-576,691-708``).

Plain 2-D arrays participate in the operator algebra by being wrapped into a
linear operator whose forward is a matvec (a matrix-unit product). The matrix is a pytree
leaf in the jet's state, so a jitted solver sees it as a traced argument (no
per-instance recompilation).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["matrix_operator"]


def _matmul_df(dm, m0, state):
    return state["A"] @ dm


def _matmul_dft(dd, m0, state):
    return jnp.conj(state["A"]).T @ dd


def matrix_operator(A) -> LinearOperator:
    """Wrap a dense ``(m, n)`` matrix as a linear operator ``R^n -> R^m``."""
    A = jnp.asarray(A)
    if A.ndim != 2:
        raise ValueError(f"matrix_operator needs a 2-D array, got ndim={A.ndim}")
    m, n = A.shape
    j = Jet(
        dom=Space((n,), A.dtype),
        rng=Space((m,), A.dtype),
        df=_matmul_df,
        dft=_matmul_dft,
        state={"A": A},
    )
    return LinearOperator(j)
