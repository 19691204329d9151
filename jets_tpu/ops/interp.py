"""Linear interpolation operator — JetPack's ``JopInterp`` (companion packs
named in ``/root/reference/docs/src/index.md:14-19``): sample a gridded
signal at fractional positions along one axis.

Design: the forward is two per-axis ``take``s blended by the fractional
weights (measured on this hardware: per-axis takes beat gather stamps and
one-hot matmuls — see repo notes). The adjoint is the weighted scatter-add
(``.at[].add``), which XLA lowers to a sorted segment sum.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["interp_operator"]


def _interp_df(dm, m0, state):
    ax = state["axis"]
    a = jnp.take(dm, state["i0"], axis=ax)
    b = jnp.take(dm, state["i1"], axis=ax)
    shape = [1] * dm.ndim
    shape[ax] = state["i0"].shape[0]
    w = state["w"].reshape(shape)
    return (1.0 - w) * a + w * b


def _interp_dft(dd, m0, state):
    ax = state["axis"]
    n = state["n"]
    shape = [1] * dd.ndim
    shape[ax] = state["i0"].shape[0]
    w = state["w"].reshape(shape)
    out_shape = list(dd.shape)
    out_shape[ax] = n
    out = jnp.zeros(out_shape, dd.dtype)
    # Move the interpolation axis to the front so the fancy index is 1-D;
    # duplicate target bins accumulate (segment-sum semantics of .at[].add).
    dd0 = jnp.moveaxis((1.0 - w) * dd, ax, 0)
    dd1 = jnp.moveaxis(w * dd, ax, 0)
    out = jnp.moveaxis(out, ax, 0)
    out = out.at[state["i0"]].add(dd0)
    out = out.at[state["i1"]].add(dd1)
    return jnp.moveaxis(out, 0, ax)


def interp_operator(space: Space, positions, axis: int = -1) -> LinearOperator:
    """Linear interpolation of ``space`` onto fractional sample positions
    (in units of the grid index, clipped to ``[0, n-1]``) along ``axis``.
    Range swaps that axis's length for ``len(positions)``."""
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    pos = np.clip(np.asarray(positions, dtype=np.float64), 0.0, n - 1.0)
    if pos.ndim != 1:
        raise ValueError("positions must be 1-D")
    i0 = np.minimum(np.floor(pos).astype(np.int32), n - 2) if n > 1 else np.zeros(
        pos.shape, np.int32
    )
    i0 = np.maximum(i0, 0)
    w = (pos - i0).astype(np.dtype(space.dtype) if np.dtype(space.dtype).kind == "f"
         else np.float32)
    i1 = np.minimum(i0 + 1, n - 1)
    rng_shape = list(space.shape)
    rng_shape[axis] = pos.shape[0]
    rng = Space(tuple(rng_shape), space.dtype)
    j = Jet(
        dom=space,
        rng=rng,
        df=_interp_df,
        dft=_interp_dft,
        state={
            "i0": jnp.asarray(i0),
            "i1": jnp.asarray(i1),
            "w": jnp.asarray(w, dtype=space.dtype),
            "axis": axis,
            "n": n,
        },
    )
    return LinearOperator(j)
