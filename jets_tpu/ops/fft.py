"""FFT operators — exercising the symmetric (rfft) space.

JAX counterpart of the reference family's ``JopFft`` (JetPackTransforms,
``docs/src/index.md:14-19``); the rfft range is a :class:`SymmetricSpace`
whose weighted inner product reproduces the reference's doubled-norm
semantics for the stored half-spectrum (``src/Jets.jl:406-516``,
``test/runtests.jl:243-248``).

All transforms use ``norm="ortho"`` so the complex FFT is unitary (adjoint =
inverse) and the rfft adjoint is the orthonormal inverse real transform —
both hand-written (no transpose derivation needed) and certified by the
dot-product gate.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space, SymmetricSpace

__all__ = ["fft_operator", "rfft_operator"]


def _fft_df(dm, m0, state):
    return jnp.fft.fftn(dm, norm="ortho")


def _fft_dft(dd, m0, state):
    return jnp.fft.ifftn(dd, norm="ortho")


def fft_operator(space: Space) -> LinearOperator:
    """Unitary n-D FFT on a complex space; adjoint is the inverse."""
    if not jnp.issubdtype(space.dtype, jnp.complexfloating):
        raise TypeError("fft_operator needs a complex space; use rfft_operator")
    j = Jet(dom=space, rng=space, df=_fft_df, dft=_fft_dft)
    return LinearOperator(j)


def _rfft_df(dm, m0, state):
    return jnp.fft.rfftn(dm, norm="ortho")


def _rfft_dft(dd, m0, state):
    return jnp.fft.irfftn(dd, s=state["logical_shape"], norm="ortho")


def rfft_operator(space: Space) -> LinearOperator:
    """Real n-D FFT: real ``space`` → :class:`SymmetricSpace` of the stored
    half-spectrum. The adjoint is ``irfftn`` — exact w.r.t. the symmetric
    space's multiplicity-weighted inner product."""
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("rfft_operator needs a real floating space")
    # complex128 only for f64 domains; bf16/f16/f32 all produce complex64
    cdt = jnp.complex128 if space.dtype == jnp.float64 else jnp.complex64
    stored = space.shape[:-1] + (space.shape[-1] // 2 + 1,)
    rng = SymmetricSpace(stored, space.shape, cdt, axis=-1)
    j = Jet(
        dom=space,
        rng=rng,
        df=_rfft_df,
        dft=_rfft_dft,
        state={"logical_shape": space.shape},
    )
    return LinearOperator(j)
