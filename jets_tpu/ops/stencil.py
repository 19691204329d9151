"""Stencil operators — 2-D blur and 3-D seismic-style stencils
(BASELINE configs #3 and #5; companion-pack territory in the reference
family, ``docs/src/index.md:14-19``).

The generic path lowers to ``lax.conv_general_dilated`` with SAME padding —
XLA maps these onto its convolution path and *transposes them into
convolutions* for the derived adjoint, so both directions run at conv speed.
The Laplacian is a shift-and-add of zero-padded slices, which XLA fuses
into one elementwise pass.
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
from jax import lax

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = [
    "laplacian_nd",
    "stencil_operator",
    "blur2d_operator",
    "laplacian_operator",
]


def _stencil_df(dm, m0, state):
    k = state["stencil"]
    nd = k.ndim
    pads = [((s - 1) // 2, s - 1 - (s - 1) // 2) for s in k.shape]
    # conv (not correlation): flip the stencil on every axis
    kf = k[tuple(slice(None, None, -1) for _ in range(nd))]
    spatial = "".join("DHW"[-nd + i] for i in range(nd)) if nd <= 3 else None
    if spatial is None:
        raise ValueError("stencil_operator supports 1-3 spatial dims")
    dn = lax.conv_dimension_numbers(
        (1, 1) + dm.shape, (1, 1) + k.shape,
        ("NC" + spatial, "OI" + spatial, "NC" + spatial),
    )
    out = lax.conv_general_dilated(
        dm[None, None], kf[None, None],
        window_strides=(1,) * nd,
        padding=pads,
        dimension_numbers=dn,
    )
    return out[0, 0]


def stencil_operator(space: Space, stencil) -> LinearOperator:
    """Constant-coefficient stencil applied with SAME (zero) padding on an
    n-D grid (n ≤ 3). The adjoint (the flipped stencil) is derived via
    ``linear_transpose`` → an XLA transposed convolution."""
    stencil = jnp.asarray(stencil, space.dtype)
    if stencil.ndim != space.ndim:
        raise ValueError(
            f"stencil ndim {stencil.ndim} != space ndim {space.ndim}"
        )
    j = Jet(dom=space, rng=space, df=_stencil_df, state={"stencil": stencil})
    return LinearOperator(j)


def blur2d_operator(shape: Sequence[int], radius: int = 2,
                    dtype=jnp.float32) -> LinearOperator:
    """Gaussian-ish box blur on a 2-D grid — the CGLS deblurring operator of
    BASELINE config #3."""
    n = 2 * radius + 1
    x = jnp.arange(n, dtype=dtype) - radius
    g = jnp.exp(-0.5 * (x / max(radius, 1)) ** 2)
    k = jnp.outer(g, g)
    k = k / jnp.sum(k)
    return stencil_operator(Space(shape, dtype), k)


# Central finite-difference coefficients for the second derivative,
# (c0, (c1, c2, ...)): d²u/dx² ≈ (c0*u[i] + Σ_s c_s*(u[i-s]+u[i+s])) / h².
# Standard Taylor-table values; order 2 is the classic (1, -2, 1).
_D2_COEFFS = {
    2: (-2.0, (1.0,)),
    4: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
    8: (
        -205.0 / 72.0,
        (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0),
    ),
}


def laplacian_nd(x, order: int = 2):
    """n-D Laplacian via shifted slices of a zero-padded array — pure
    elementwise adds that fuse into their consumer, and exactly symmetric
    with the zero boundary (self-adjoint). THE single
    shared implementation: the wave propagator and the fused seismic
    flagship import this so their bit-exactness guarantees hold.

    ``order`` selects the spatial accuracy (2, 4 or 8 — the orders the
    reference family's JetPackWaveFD propagators offer). All orders keep
    the zero boundary and symmetric taps, so self-adjointness holds
    exactly at every order. ``order=2`` is bit-identical to the original
    implementation (the flagship's fused/composed equality depends on it).
    """
    nd = x.ndim
    c0, cs = _D2_COEFFS[order]
    halfw = len(cs)
    xp = jnp.pad(x, halfw)
    out = (c0 * nd) * x
    for ax in range(nd):
        for s, c in enumerate(cs, start=1):
            lo = tuple(
                slice(halfw - s, -(halfw + s))
                if i == ax else slice(halfw, -halfw)
                for i in range(nd)
            )
            hi = tuple(
                slice(halfw + s, (s - halfw) or None)
                if i == ax else slice(halfw, -halfw)
                for i in range(nd)
            )
            if c == 1.0:
                # keep the original two-add association (the flagship's
                # fused/composed bit-exactness depends on it)
                out = out + xp[lo] + xp[hi]
            else:
                out = out + c * (xp[lo] + xp[hi])
    return out


def _laplacian_df(dm, m0, state):
    return laplacian_nd(dm)


def _laplacian4_df(dm, m0, state):
    return laplacian_nd(dm, order=4)


def _laplacian8_df(dm, m0, state):
    return laplacian_nd(dm, order=8)


_LAPLACIAN_DF = {2: _laplacian_df, 4: _laplacian4_df, 8: _laplacian8_df}


def laplacian_operator(
    shape: Sequence[int], dtype=jnp.float32, *, order: int = 2,
) -> LinearOperator:
    """Second-order n-D Laplacian stencil — the seismic-style wave-operator
    building block of BASELINE config #5. Self-adjoint (symmetric stencil,
    zero boundary).

    ``order`` ∈ {2, 4, 8} selects the stencil accuracy
    (:func:`laplacian_nd`).
    """
    sp = Space(shape, dtype)
    if order not in _D2_COEFFS:
        raise ValueError(f"order must be one of {sorted(_D2_COEFFS)}")
    j = Jet(dom=sp, rng=sp, df=_LAPLACIAN_DF[order], dft="self")
    return LinearOperator(j)
