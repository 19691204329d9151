"""Linear Radon (slant-stack) transform operator.

The ``JopSlantStack`` capability of the reference's companion transforms
package (``JetPackTransforms``, named in
``/root/reference/docs/src/index.md:14-19``), built for XLA: the
time-shift stack is evaluated in the temporal Fourier domain, where it is a
per-frequency complex matmul against a phase matrix — matmul work with static
shapes, no gathers or interpolation.

Forward (slowness model → shot gather):

    d(t, x) = Σ_p m(t - p·x, p)
    ⇔  D(f, x) = Σ_p M(f, p) · exp(-2πi f p x)

Adjoint: the conjugate-phase stack (hand-written, certified by the
dot-product gate). Periodic in time (FFT); taper the model in τ if wrap
matters.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["radon_operator"]


def _radon_df(dm, m0, state):
    ph = state["phase"]  # (nf, np, nx)
    nt = state["nt"]
    M = jnp.fft.rfft(dm, axis=0)  # (nf, np)
    D = jnp.einsum("fp,fpx->fx", M, ph)
    return jnp.fft.irfft(D, n=nt, axis=0)


def _radon_dft(dd, m0, state):
    ph = state["phase"]
    nt = state["nt"]
    D = jnp.fft.rfft(dd, axis=0)  # (nf, nx)
    M = jnp.einsum("fx,fpx->fp", D, jnp.conj(ph))
    return jnp.fft.irfft(M, n=nt, axis=0)


def radon_operator(
    nt: int,
    offsets: Sequence[float],
    slownesses: Sequence[float],
    dt: float = 1.0,
    dtype=jnp.float32,
) -> LinearOperator:
    """Slant stack ``m(τ, p) → d(t, x)`` over receiver ``offsets`` (x) and
    ``slownesses`` (p), periodic in time.

    Domain ``(nt, len(slownesses))``, range ``(nt, len(offsets))``. The
    phase tensor ``exp(-2πi f p x)`` is precomputed once,
    ``(nt//2+1, np, nx)`` complex.
    """
    offsets = np.asarray(offsets, dtype=np.float64)
    slownesses = np.asarray(slownesses, dtype=np.float64)
    f = np.fft.rfftfreq(int(nt), d=float(dt))  # (nf,)
    px = slownesses[:, None] * offsets[None, :]  # (np, nx)
    ph = np.exp(-2j * np.pi * f[:, None, None] * px[None, :, :])
    # keep irfft exactly real-adjoint: the self-conjugate Nyquist bin (even
    # nt) must carry a real coefficient (same device as shift_operator)
    if nt % 2 == 0:
        ph[-1] = np.real(ph[-1])
    cdtype = np.complex128 if jnp.dtype(dtype) == jnp.float64 else np.complex64
    j = Jet(
        dom=Space((int(nt), len(slownesses)), dtype),
        rng=Space((int(nt), len(offsets)), dtype),
        df=_radon_df,
        dft=_radon_dft,
        state={"phase": jnp.asarray(ph, dtype=cdtype), "nt": int(nt)},
    )
    return LinearOperator(j)
