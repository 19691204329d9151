"""Orthonormal discrete wavelet transform operators.

JAX counterpart of the ``JopWavelet``-style transform ops that live in
the reference's companion package family (``JetPackTransforms``, named in
``/root/reference/docs/src/index.md:14-19``). The reference repo itself ships
no transforms; this module supplies the capability the ecosystem provides.

Design:

* Separable multi-level Mallat DWT with **periodic boundary**, so the
  transform is exactly orthonormal and its adjoint equals its inverse.
* The analysis filter bank is expressed as a handful of ``jnp.roll`` +
  strided-slice ops — static shapes, no gathers, fuses under XLA.
* The adjoint is **derived via ``jax.linear_transpose``** (the framework's
  correct-by-construction default, see ``core/jet.py``); for an orthonormal
  W this is also its inverse. Gated by the dot-product and orthonormality
  tests in ``tests/test_ops.py``.

Filters: Haar and Daubechies-4 (``db2``).
"""
from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["wavelet_operator", "WAVELETS"]

_SQ3 = math.sqrt(3.0)
_SQ2 = math.sqrt(2.0)

WAVELETS = {
    "haar": (1.0 / _SQ2, 1.0 / _SQ2),
    "db2": (
        (1.0 + _SQ3) / (4.0 * _SQ2),
        (3.0 + _SQ3) / (4.0 * _SQ2),
        (3.0 - _SQ3) / (4.0 * _SQ2),
        (1.0 - _SQ3) / (4.0 * _SQ2),
    ),
    # standard Daubechies analysis low-pass coefficients (orthonormality is
    # enforced by the suite: materialize(W)^T materialize(W) == I)
    "db3": (
        0.3326705529500826,
        0.8068915093110925,
        0.4598775021184915,
        -0.1350110200102546,
        -0.0854412738820267,
        0.0352262918857095,
    ),
    "db4": (
        0.2303778133088965,
        0.7148465705529157,
        0.6308807679298589,
        -0.0279837694168599,
        -0.1870348117190931,
        0.0308413818355607,
        0.0328830116668852,
        -0.0105974017850690,
    ),
}


def _analysis_1d(x, lo, axis):
    """One analysis level along ``axis`` with periodic extension:
    ``a[k] = Σ_i lo[i]·x[(2k+i) mod n]``, ``d[k] = Σ_i hi[i]·x[(2k+i) mod n]``
    where ``hi[i] = (-1)^i · lo[L-1-i]`` (quadrature mirror)."""
    L = len(lo)
    hi = tuple(((-1.0) ** i) * lo[L - 1 - i] for i in range(L))
    x = jnp.moveaxis(x, axis, -1)
    a = jnp.zeros_like(x[..., ::2])
    d = jnp.zeros_like(a)
    for i in range(L):
        xi = jnp.roll(x, -i, axis=-1)[..., ::2]
        a = a + lo[i] * xi
        d = d + hi[i] * xi
    out = jnp.concatenate([a, d], axis=-1)
    return jnp.moveaxis(out, -1, axis)


def _dwt(m, lo, levels, axes):
    out = m
    for lev in range(levels):
        # the approximation block shrinks by 2 along every transformed axis
        sub_sl = tuple(
            slice(0, s >> lev) if ax in axes else slice(None)
            for ax, s in enumerate(m.shape)
        )
        sub = out[sub_sl]
        for ax in axes:
            sub = _analysis_1d(sub, lo, ax)
        out = out.at[sub_sl].set(sub)
    return out


def wavelet_operator(
    space: Space,
    wavelet: str = "db2",
    levels: int = 1,
    axes: Tuple[int, ...] = None,
) -> LinearOperator:
    """Multi-level separable orthonormal DWT on ``space`` (periodic
    boundary). ``axes`` defaults to all axes; every transformed axis length
    must be divisible by ``2**levels``. The adjoint (= inverse, the
    transform is orthonormal) is derived by ``jax.linear_transpose``."""
    if wavelet not in WAVELETS:
        raise ValueError(f"unknown wavelet {wavelet!r}; have {list(WAVELETS)}")
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("wavelet_operator needs a real floating space")
    axes = tuple(range(space.ndim)) if axes is None else tuple(
        int(a) % space.ndim for a in axes
    )
    for ax in axes:
        if space.shape[ax] % (1 << levels):
            raise ValueError(
                f"axis {ax} length {space.shape[ax]} not divisible by "
                f"2^{levels}"
            )
    lo = WAVELETS[wavelet]

    def _df(dm, m0, state):
        return _dwt(dm, lo, levels, axes)

    j = Jet(dom=space, rng=space, df=_df)
    return LinearOperator(j)
