"""Transform and structural operators — the JetPackTransforms/JetPack-style
companion ops (named in the reference docs ``docs/src/index.md:14-19``):
DCT, identity, zero-padding and restriction/cropping.

All are linear with hand-written adjoints (orthonormal DCT is unitary;
padding and restriction are mutual adjoints), gated by the dot-product test
in the suite.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = [
    "circshift_operator",
    "projection_operator",
    "dct_operator",
    "identity_operator",
    "pad_operator",
    "restriction_operator",
    "reshape_operator",
    "real_operator",
    "imag_operator",
    "transpose_operator",
    "flip_operator",
    "permutation_operator",
]


def _dct_df(dm, m0, state):
    out = dm
    for ax in range(dm.ndim):
        out = jax.scipy.fft.dct(out, norm="ortho", axis=ax)
    return out


def _dct_dft(dd, m0, state):
    out = dd
    for ax in range(dd.ndim):
        out = jax.scipy.fft.idct(out, norm="ortho", axis=ax)
    return out


def dct_operator(space: Space) -> LinearOperator:
    """Orthonormal type-II DCT over every axis; adjoint = inverse DCT
    (unitary)."""
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("dct_operator needs a real floating space")
    j = Jet(dom=space, rng=space, df=_dct_df, dft=_dct_dft)
    return LinearOperator(j)


def _id_df(dm, m0, state):
    return dm


def identity_operator(space: Space) -> LinearOperator:
    j = Jet(dom=space, rng=space, df=_id_df, dft="self")
    return LinearOperator(j)


def _pad_df(dm, m0, state):
    pads = state["pads"]
    return jnp.pad(dm, pads)


def _pad_dft(dd, m0, state):
    pads = state["pads"]
    sl = tuple(slice(lo, dd.shape[i] - hi) for i, (lo, hi) in enumerate(pads))
    return dd[sl]


def pad_operator(space: Space, pads: Sequence[Tuple[int, int]]) -> LinearOperator:
    """Zero-padding ``dom -> padded range``; the adjoint is the restriction
    (crop) back — mutual adjoints, exact."""
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    if len(pads) != space.ndim:
        raise ValueError(f"need {space.ndim} pad pairs, got {len(pads)}")
    out_shape = tuple(
        s + lo + hi for s, (lo, hi) in zip(space.shape, pads)
    )
    j = Jet(
        dom=space,
        rng=Space(out_shape, space.dtype),
        df=_pad_df,
        dft=_pad_dft,
        state={"pads": pads},
    )
    return LinearOperator(j)


def restriction_operator(
    space: Space, window: Sequence[Tuple[int, int]]
) -> LinearOperator:
    """Crop to ``window`` (per-axis (start, stop)); adjoint zero-pads back —
    the standard data-windowing operator of inversion workflows."""
    window = tuple((int(a), int(b)) for a, b in window)
    if len(window) != space.ndim:
        raise ValueError(f"need {space.ndim} window pairs, got {len(window)}")
    for (a, b), s in zip(window, space.shape):
        if not (0 <= a < b <= s):
            raise ValueError(f"window {window} out of bounds for {space.shape}")
    out_shape = tuple(b - a for a, b in window)
    pads = tuple(
        (a, s - b) for (a, b), s in zip(window, space.shape)
    )

    def _r_df(dm, m0, state):
        sl = tuple(slice(a, b) for a, b in state["window"])
        return dm[sl]

    def _r_dft(dd, m0, state):
        return jnp.pad(dd, state["pads"])

    j = Jet(
        dom=space,
        rng=Space(out_shape, space.dtype),
        df=_r_df,
        dft=_r_dft,
        state={"window": window, "pads": pads},
    )
    return LinearOperator(j)


def reshape_operator(space: Space, new_shape: Sequence[int]) -> LinearOperator:
    """Shape-changing identity ``dom(shape) -> rng(new_shape)`` (same number
    of elements); the adjoint reshapes back. The operator-level counterpart
    of the reference's ``reshape(x, R)`` space verb (``src/Jets.jl:38``)."""
    new_shape = tuple(int(s) for s in new_shape)
    if int(jnp.prod(jnp.array(new_shape))) != space.size:
        raise ValueError(f"cannot reshape {space.shape} -> {new_shape}")

    def _df(dm, m0, state):
        return dm.reshape(state["out"])

    def _dft(dd, m0, state):
        return dd.reshape(state["in"])

    j = Jet(
        dom=space,
        rng=Space(new_shape, space.dtype),
        df=_df,
        dft=_dft,
        state={"out": new_shape, "in": space.shape},
    )
    return LinearOperator(j)


def _real_dtype(dtype):
    d = jnp.dtype(dtype)
    if d.kind != "c":
        raise TypeError(f"expected complex space, got {d}")
    return jnp.float32 if d.itemsize == 8 else jnp.float64


def real_operator(space: Space) -> LinearOperator:
    """``d = Re(m)``: complex dom → real rng. R-linear; adjoint (w.r.t. the
    real inner product ``Re⟨·,·⟩``) embeds ``dd ↦ dd + 0i``."""
    rdt = _real_dtype(space.dtype)

    def _df(dm, m0, state):
        return jnp.real(dm)

    def _dft(dd, m0, state):
        return dd.astype(space.dtype)

    j = Jet(dom=space, rng=Space(space.shape, rdt), df=_df, dft=_dft)
    return LinearOperator(j)


def imag_operator(space: Space) -> LinearOperator:
    """``d = Im(m)``: complex dom → real rng. R-linear; adjoint embeds
    ``dd ↦ i·dd`` (w.r.t. the real inner product)."""
    rdt = _real_dtype(space.dtype)

    def _df(dm, m0, state):
        return jnp.imag(dm)

    def _dft(dd, m0, state):
        return (1j * dd).astype(space.dtype)

    j = Jet(dom=space, rng=Space(space.shape, rdt), df=_df, dft=_dft)
    return LinearOperator(j)


def transpose_operator(space: Space, axes: Sequence[int]) -> LinearOperator:
    """Axis permutation ``m -> m.transpose(axes)`` (orthogonal; adjoint =
    inverse permutation)."""
    axes = tuple(int(a) % space.ndim for a in axes)
    if sorted(axes) != list(range(space.ndim)):
        raise ValueError(f"{axes} is not a permutation of axes")
    inv = tuple(int(i) for i in sorted(range(space.ndim), key=lambda k: axes[k]))
    out_shape = tuple(space.shape[a] for a in axes)

    def _df(dm, m0, state):
        return jnp.transpose(dm, state["axes"])

    def _dft(dd, m0, state):
        return jnp.transpose(dd, state["inv"])

    j = Jet(
        dom=space,
        rng=Space(out_shape, space.dtype),
        df=_df,
        dft=_dft,
        state={"axes": axes, "inv": inv},
    )
    return LinearOperator(j)


def flip_operator(space: Space, axes: Sequence[int]) -> LinearOperator:
    """Reverse the given axes (involutive and orthogonal: adjoint = itself)."""
    axes = tuple(sorted(int(a) % space.ndim for a in axes))

    def _df(dm, m0, state):
        return jnp.flip(dm, axis=state["axes"])

    j = Jet(dom=space, rng=space, df=_df, dft="self", state={"axes": axes})
    return LinearOperator(j)


def permutation_operator(space: Space, perm) -> LinearOperator:
    """Permute the FLAT elements of the space by index vector ``perm``
    (``d.flat[i] = m.flat[perm[i]]``); adjoint applies the inverse
    permutation. Orthogonal."""
    perm = jnp.asarray(perm, jnp.int32)
    if perm.shape != (space.size,):
        raise ValueError(f"perm must have {space.size} entries")
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(space.size, dtype=jnp.int32)
    )

    def _df(dm, m0, state):
        return jnp.ravel(dm)[state["perm"]].reshape(dm.shape)

    def _dft(dd, m0, state):
        return jnp.ravel(dd)[state["inv"]].reshape(dd.shape)

    j = Jet(
        dom=space,
        rng=space,
        df=_df,
        dft=_dft,
        state={"perm": perm, "inv": inv},
    )
    return LinearOperator(j)


def _circshift_df(dm, m0, state):
    return jnp.roll(dm, state["shifts"], axis=state["axes"])


def _circshift_dft(dd, m0, state):
    return jnp.roll(dd, tuple(-s for s in state["shifts"]), axis=state["axes"])


def circshift_operator(space: Space, shifts: Sequence[int]) -> LinearOperator:
    """Circular shift (JetPack's ``JopCircShift``): ``jnp.roll`` by
    ``shifts[ax]`` per axis — a pure permutation, so unitary; the adjoint
    (= inverse) rolls back. Reference companion packs named at
    ``docs/src/index.md:14-19``."""
    shifts = tuple(int(s) for s in shifts)
    if len(shifts) != space.ndim:
        raise ValueError(f"need {space.ndim} shifts, got {len(shifts)}")
    j = Jet(
        dom=space,
        rng=space,
        df=_circshift_df,
        dft=_circshift_dft,
        state={"shifts": shifts, "axes": tuple(range(space.ndim))},
    )
    return LinearOperator(j)


def _proj_df(dm, m0, state):
    Q = state["Q"]
    ndim = dm.ndim
    coeff = jnp.tensordot(jnp.conj(Q), dm,
                          axes=(tuple(range(1, ndim + 1)),
                                tuple(range(ndim))))
    out = jnp.tensordot(coeff, Q, axes=1)
    if state["complement"]:
        return dm - out
    return out


def projection_operator(vectors, complement: bool = False) -> LinearOperator:
    """Orthogonal projection onto ``span(vectors)`` (JetPack's
    ``JopProjection``): ``P = Q Q^H`` after a host-side QR orthonormalization
    of the ``(k, *shape)`` stack. ``complement=True`` gives ``I - P``.
    Idempotent and self-adjoint; the apply is two small matmuls,
    never materializing the n×n projector."""
    V = jnp.asarray(vectors)
    if V.ndim < 2:
        V = V[None]
    k = V.shape[0]
    flat = np.asarray(V.reshape(k, -1)).T  # (n, k)
    q, r = np.linalg.qr(flat)
    # drop directions lost to rank deficiency
    keep = np.abs(np.diagonal(r)) > 1e-12 * max(np.abs(np.diagonal(r)).max(), 1e-300)
    q = q[:, keep]
    Q = jnp.asarray(q.T.reshape((-1,) + V.shape[1:]), dtype=V.dtype)
    sp = Space(V.shape[1:], V.dtype)
    j = Jet(dom=sp, rng=sp, df=_proj_df, dft="self",
            state={"Q": Q, "complement": bool(complement)})
    return LinearOperator(j)
