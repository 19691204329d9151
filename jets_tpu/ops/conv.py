"""1-D convolution and derivative operators — the deconvolution chain
``A = D ∘ S`` of BASELINE config #2 (companion-pack ops in the reference
family, named in ``docs/src/index.md:14-19``).

Forwards are XLA convolutions (statically shaped); adjoints
are *derived* via ``jax.linear_transpose`` — XLA transposes a convolution into
another convolution, so the derived adjoint is as fast as a hand-written one
and exact by construction (then certified by the dot-product gate in CI).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["conv1d_operator", "convnd_operator", "derivative_operator", "gradient_operator"]


def _conv_same(m, k):
    """Same-length 1-D convolution via conv_general_dilated."""
    L = k.shape[0]
    # 'same' crop of the full convolution is full[(L-1)//2 : (L-1)//2 + n]
    # (scipy/numpy convention); achieving that crop with a *correlation*
    # against the flipped kernel requires low-padding by the complement
    # L-1-(L-1)//2 = L//2 — for even L the pair is asymmetric and the
    # naive (lo, hi) order is off by one.
    pad_lo = L // 2
    pad_hi = L - 1 - pad_lo
    out = lax.conv_general_dilated(
        m[None, None, :],
        k[::-1][None, None, :],  # conv (not correlation): flip the kernel
        window_strides=(1,),
        padding=[(pad_lo, pad_hi)],
        dimension_numbers=("NCH", "OIH", "NCH"),
    )
    return out[0, 0, :]


def _conv1d_df(dm, m0, state):
    return _conv_same(dm, state["kernel"])


def conv1d_operator(kernel, n: int, dtype=jnp.float32) -> LinearOperator:
    """Same-length convolution with ``kernel`` on 1-D signals of length ``n``
    (e.g. a source wavelet ``S`` in seismic deconvolution)."""
    kernel = jnp.asarray(kernel, dtype)
    sp = Space((n,), dtype)
    j = Jet(dom=sp, rng=sp, df=_conv1d_df, state={"kernel": kernel})
    return LinearOperator(j)


def _deriv_df(dm, m0, state):
    # forward difference with zero boundary: d[i] = (m[i+1] - m[i]) / dx
    dx = state["dx"]
    d = (dm[1:] - dm[:-1]) / dx
    return jnp.concatenate([d, jnp.zeros((1,), dm.dtype)])


def gradient_operator(space: Space, dx: float = 1.0) -> LinearOperator:
    """n-D forward-difference gradient: ``dom(shape) -> rng((nd,) + shape)``
    with ``(∇m)[ax, ..., i, ...] = (m[i+1] - m[i]) / dx`` along each axis
    (zero at the trailing face). The standard smoothing / total-variation
    regularization operator of inversion workflows; the adjoint (negative
    divergence with boundary terms) is derived via ``jax.linear_transpose``.
    """
    nd = space.ndim
    inv = 1.0 / float(dx)

    def _df(dm, m0, state):
        outs = []
        for ax in range(nd):
            d = (jnp.roll(dm, -1, axis=ax) - dm) * inv
            # zero the wrapped trailing face
            idx = [slice(None)] * nd
            idx[ax] = slice(-1, None)
            d = d.at[tuple(idx)].set(0.0)
            outs.append(d)
        return jnp.stack(outs, axis=0)

    j = Jet(
        dom=space,
        rng=Space((nd,) + space.shape, space.dtype),
        df=_df,
    )
    return LinearOperator(j)


def derivative_operator(n: int, dx: float = 1.0, dtype=jnp.float32) -> LinearOperator:
    """First-difference derivative ``D`` on 1-D signals of length ``n``
    (zero-padded at the right boundary); adjoint is the negative backward
    difference, derived automatically."""
    sp = Space((n,), dtype)
    j = Jet(dom=sp, rng=sp, df=_deriv_df, state={"dx": float(dx)})
    return LinearOperator(j)


def _dim_numbers(nd):
    sp = "DHW"[-nd:] if nd <= 3 else None
    if sp is None:
        raise ValueError("convnd_operator supports up to 3 spatial dims")
    return ("NC" + sp, "OI" + sp, "NC" + sp)


def _convnd(m, k, pads):
    nd = m.ndim
    out = lax.conv_general_dilated(
        m[None, None],
        k[None, None],
        window_strides=(1,) * nd,
        padding=pads,
        dimension_numbers=_dim_numbers(nd),
    )
    return out[0, 0]


def _convnd_df(dm, m0, state):
    return _convnd(dm, state["kflip"], state["pads"])


def _convnd_dft(dd, m0, state):
    # transpose of zero-padded 'same' convolution: correlate (un-flipped
    # conjugate kernel) with the lo/hi padding swapped — exact for even and
    # odd kernel sizes alike
    return _convnd(dd, jnp.conj(state["k"]), state["pads_t"])


def convnd_operator(kernel, space: Space) -> LinearOperator:
    """General n-D (n ≤ 3) 'same'-shape convolution with an arbitrary
    kernel, zero boundary (the JetPack convolution family generalized from
    :func:`conv1d_operator`). The forward is one XLA convolution; the
    handwritten adjoint is the correlation with swapped asymmetric padding,
    exact for even-sized kernels too."""
    k = jnp.asarray(kernel, dtype=space.dtype)
    if k.ndim != space.ndim:
        raise ValueError(
            f"kernel ndim {k.ndim} != space ndim {space.ndim}"
        )
    pads, pads_t = [], []
    for L in k.shape:
        lo = (L - 1) // 2
        hi = L - 1 - lo
        # cropping the full convolution at offset lo requires *low*-padding
        # the correlation-with-flipped-kernel by hi (and vice versa for the
        # transpose) — for even L the asymmetric pair must be swapped
        pads.append((hi, lo))
        pads_t.append((lo, hi))
    kflip = k[tuple(slice(None, None, -1) for _ in range(k.ndim))]
    j = Jet(
        dom=space,
        rng=space,
        df=_convnd_df,
        dft=_convnd_dft,
        state={"k": k, "kflip": kflip, "pads": tuple(pads),
               "pads_t": tuple(pads_t)},
    )
    return LinearOperator(j)
