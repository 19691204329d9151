"""Causal (scan) operators — the JetPack family's integration ops
(``JopLeakyIntegration``/``JopNim`` and the difference op named with the
companion packs in ``/root/reference/docs/src/index.md:14-19``).

Design: causal recurrences are first-order linear scans, so the forward
is a single ``lax.associative_scan`` — a log-depth parallel scan that XLA
maps onto the VPU, not a serial time loop. The adjoint of a causal
integration is the ANTICAUSAL integration (matrix transpose of the lower-
triangular Toeplitz), implemented as flip → same scan → flip; both
directions share one kernel.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["integration_operator", "difference_operator", "nim_operator"]


def _leaky_scan(x, alpha, axis):
    """y[t] = alpha * y[t-1] + x[t] along ``axis`` via associative scan.

    Elements are affine maps ``y -> a*y + b``; composition
    ``(a1,b1) then (a2,b2) = (a2*a1, a2*b1 + b2)`` is associative, giving a
    log-depth parallel recurrence on the VPU.
    """
    a = jnp.full_like(x, alpha)

    def combine(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a2 * a1, a2 * b1 + b2

    _, y = lax.associative_scan(combine, (a, x), axis=axis)
    return y


def _integ_df(dm, m0, state):
    return _leaky_scan(dm, state["alpha"], state["axis"])


def _integ_dft(dd, m0, state):
    ax = state["axis"]
    return jnp.flip(_leaky_scan(jnp.flip(dd, ax), state["alpha"], ax), ax)


def integration_operator(
    space: Space, alpha: float = 1.0, axis: int = -1
) -> LinearOperator:
    """Causal (leaky) integration along ``axis``:
    ``d[t] = alpha * d[t-1] + m[t]`` (``alpha=1`` is the running sum, the
    inverse of :func:`difference_operator`). Adjoint is the anticausal
    integration. JetPack's ``JopLeakyIntegration``; reference companion
    packs named at ``docs/src/index.md:14-19``."""
    axis = int(axis) % space.ndim
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("integration_operator needs a real floating space")
    alpha = float(alpha)
    j = Jet(
        dom=space,
        rng=space,
        df=_integ_df,
        dft=_integ_dft,
        state={"alpha": alpha, "axis": axis},
    )
    return LinearOperator(j)


def _diff_df(dm, m0, state):
    ax = state["axis"]
    lo = lax.slice_in_dim(dm, 0, 1, axis=ax)
    body = lax.slice_in_dim(dm, 1, None, axis=ax) - lax.slice_in_dim(
        dm, 0, -1, axis=ax
    )
    return jnp.concatenate([lo, body], axis=ax)


def _diff_dft(dd, m0, state):
    ax = state["axis"]
    body = lax.slice_in_dim(dd, 0, -1, axis=ax) - lax.slice_in_dim(
        dd, 1, None, axis=ax
    )
    hi = lax.slice_in_dim(dd, -1, None, axis=ax)
    return jnp.concatenate([body, hi], axis=ax)


def difference_operator(space: Space, axis: int = -1) -> LinearOperator:
    """First difference along ``axis`` with ``d[0] = m[0]`` (so the operator
    is square and exactly inverted by ``integration_operator(alpha=1)``).
    ``D = I - S`` for the one-sample causal shift ``S``; the handwritten
    adjoint is ``I - S^T`` (anticausal shift)."""
    axis = int(axis) % space.ndim
    j = Jet(dom=space, rng=space, df=_diff_df, dft=_diff_dft,
            state={"axis": axis})
    return LinearOperator(j)


def _nim_f(m, state):
    ax, p = state["axis"], state["p"]
    u = m ** p
    S = jnp.sum(u, axis=ax, keepdims=True)
    S = jnp.where(jnp.abs(S) > 0, S, 1.0)
    return jnp.cumsum(u, axis=ax) / S


def _nim_upstate(m0, state):
    ax, p = state["axis"], state["p"]
    u0 = m0 ** p
    S0 = jnp.sum(u0, axis=ax, keepdims=True)
    S0 = jnp.where(jnp.abs(S0) > 0, S0, 1.0)
    return {"du_dm": p * m0 ** (p - 1), "U0": jnp.cumsum(u0, axis=ax),
            "S0": S0}


def _nim_df(dm, m0, state):
    ax = state["axis"]
    du = state["du_dm"] * dm
    dU = jnp.cumsum(du, axis=ax)
    dS = jnp.sum(du, axis=ax, keepdims=True)
    return dU / state["S0"] - state["U0"] * dS / state["S0"] ** 2


def _nim_dft(dd, m0, state):
    ax = state["axis"]
    S0, U0 = state["S0"], state["U0"]
    # transpose of cumsum is the anticausal cumsum; of sum, a broadcast
    acc = jnp.flip(jnp.cumsum(jnp.flip(dd / S0, ax), axis=ax), ax)
    corr = jnp.sum(dd * U0 / S0 ** 2, axis=ax, keepdims=True)
    return state["du_dm"] * (acc - corr)


def nim_operator(space: Space, p: float = 2.0, axis: int = -1):
    """Normalized integration (JetPack's ``JopNim``): the cumulative sum of
    ``m^p`` along ``axis`` normalized by its total — a monotone [0, 1]
    profile per trace (even ``p``), the time-lapse warping workhorse.
    Nonlinear; tangent/adjoint handwritten with ``upstate``-precomputed
    linearization-point quantities."""
    from ..core.jet import Operator
    axis = int(axis) % space.ndim
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("nim_operator needs a real floating space")
    j = Jet(
        dom=space,
        rng=space,
        f=_nim_f,
        df=_nim_df,
        dft=_nim_dft,
        upstate=_nim_upstate,
        state={"axis": axis, "p": float(p), "du_dm": None, "U0": None,
               "S0": None},
    )
    return Operator(j)
