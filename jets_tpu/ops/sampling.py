"""Off-grid sampling/interpolation operators — Kaiser-windowed sinc, the
JetPackWaveFD source/receiver interpolation scheme (Hicks 2002) of the
reference family (``docs/src/index.md:14-19``; nothing in the reference repo
itself, ``src/Jets.jl`` has no interpolation).

Design: **interpolation is dense banded matrices applied as matmuls**, not
gathers — a flat gather moves one element at a time while a small dense
matmul runs on the matrix units, so each axis's fractional sampling becomes a ``(npts_ax, n_ax)`` matrix
built once at operator-construction time (numpy, float64, then cast).
Separable (tensor-product) sampling contracts one axis at a time; scattered
points contract per-point rows. Adjoints are derived via
``linear_transpose`` — transposed matmuls.

Weights: ``w(x) = sinc(x) · I0(β √(1-(x/r)²)) / I0(β)`` over the ``2r`` taps
around each fractional coordinate (Hicks' optimal β≈6.31 for r=4); taps
falling outside the grid are dropped (zero exterior, consistent with the
framework's zero-boundary stencils). On-grid coordinates reproduce exact
point sampling (the sinc collapses to a delta).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = [
    "kaiser_sinc_matrix",
    "sinc_sampling_operator",
    "sinc_point_sampling_operator",
]

_HICKS_BETA = {1: 1.24, 2: 2.94, 3: 4.53, 4: 6.31, 5: 7.91, 6: 9.42,
               7: 10.88, 8: 12.31}


def kaiser_sinc_matrix_np(n: int, coords, radius: int = 4,
                          beta: float | None = None) -> np.ndarray:
    """Float64 numpy variant of :func:`kaiser_sinc_matrix` (host-side
    geometry construction without touching the JAX x64 flag)."""
    coords = np.asarray(coords, np.float64)
    if beta is None:
        beta = _HICKS_BETA[radius]
    i0b = np.i0(beta)
    W = np.zeros((coords.shape[0], n), np.float64)
    base = np.floor(coords).astype(np.int64)
    for t in range(-radius + 1, radius + 1):
        j = base + t
        x = coords - j                       # in (-radius, radius]
        arg = 1.0 - (x / radius) ** 2
        win = np.where(arg > 0, np.i0(beta * np.sqrt(np.maximum(arg, 0.0))),
                       0.0) / i0b
        w = np.sinc(x) * win
        ok = (j >= 0) & (j < n)
        np.add.at(W, (np.arange(coords.shape[0])[ok], j[ok]), w[ok])
    return W


def kaiser_sinc_matrix(n: int, coords, radius: int = 4,
                       beta: float | None = None, dtype=jnp.float32):
    """Dense ``(len(coords), n)`` Kaiser-windowed-sinc sampling matrix for
    fractional coordinates on a length-``n`` axis (built in float64 numpy at
    construction time; rows of on-grid coordinates are exact one-hots)."""
    W = kaiser_sinc_matrix_np(n, coords, radius, beta)
    # cast host-side: requesting float64 via jnp.asarray would warn/truncate
    # when the x64 flag is off
    return jnp.asarray(W.astype(np.dtype(dtype)))


def _axis_contract(W, u, ax):
    """Apply ``W`` (m, n_ax) along axis ``ax`` of ``u`` → axis length m."""
    v = jnp.tensordot(W, u, axes=((1,), (ax,)))   # (m, ...rest)
    return jnp.moveaxis(v, 0, ax)


def sinc_sampling_operator(
    space: Space, coords_per_axis: Sequence, radius: int = 4,
) -> LinearOperator:
    """Separable (tensor-product) off-grid resampling: axis ``k`` of the
    output grid lives at fractional coordinates ``coords_per_axis[k]`` of
    the input axis. Forward = one banded matmul per axis; adjoint is
    the derived transposed-matmul chain. Use for model regridding, receiver
    lines/planes, and any JetPackWaveFD-style geometry with a separable
    layout."""
    if len(coords_per_axis) != space.ndim:
        raise ValueError("need one coordinate array per axis")
    Ws = tuple(
        kaiser_sinc_matrix(space.shape[ax], coords_per_axis[ax], radius,
                           dtype=space.dtype)
        for ax in range(space.ndim)
    )
    out_shape = tuple(int(np.asarray(c).shape[0]) for c in coords_per_axis)
    rng = Space(out_shape, space.dtype)

    def _df(dm, m0, state):
        u = dm
        for ax, W in enumerate(state["Ws"]):
            u = _axis_contract(W, u, ax)
        return u

    j = Jet(dom=space, rng=rng, df=_df, state={"Ws": Ws})
    return LinearOperator(j)


def sinc_point_sampling_operator(
    space: Space, points, radius: int = 4,
) -> LinearOperator:
    """Scattered off-grid point sampling: ``points`` is ``(npts, ndim)``
    fractional coordinates; the output is the ``(npts,)`` vector of sampled
    values. Implemented as per-point row contractions (one matmul for
    the leading axis, then row-wise weighted reductions) — no gathers. For
    large grids this does ``npts · n_0 · Π n_rest`` MACs; meant for
    operator-level sampling (acquisition geometry, QC), not per-time-step
    loops (the wave propagator's in-loop off-grid receivers use the
    separable line form instead)."""
    points = np.asarray(points, np.float64)
    if points.ndim != 2 or points.shape[1] != space.ndim:
        raise ValueError("points must be (npts, ndim)")
    Ws = tuple(
        kaiser_sinc_matrix(space.shape[ax], points[:, ax], radius,
                           dtype=space.dtype)
        for ax in range(space.ndim)
    )
    rng = Space((points.shape[0],), space.dtype)

    def _df(dm, m0, state):
        Ws = state["Ws"]
        # contract axis 0 with per-point rows: t[p, rest...] — a matmul
        t = jnp.tensordot(Ws[0], dm, axes=((1,), (0,)))
        # remaining axes: per-point weighted reductions (einsum keeps the
        # point axis aligned; XLA lowers these to batched matmuls)
        for W in Ws[1:]:
            t = jnp.einsum("pi,pi...->p...", W, t)
        return t

    j = Jet(dom=space, rng=rng, df=_df, state={"Ws": Ws})
    return LinearOperator(j)
