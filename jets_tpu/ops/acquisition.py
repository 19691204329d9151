"""Acquisition-geometry operators — JetPack's ``JopBlend`` (simultaneous-
source blending) and ``JopLMO`` (linear moveout) families (companion packs
named in ``/root/reference/docs/src/index.md:14-19``).

Design notes:
* Blending places each shot's trace at its firing time in one continuous
  record. Instead of a scatter, the forward is pad → per-shot ``jnp.roll``
  (a permutation XLA lowers to cheap rotates) → sum over shots; the adjoint is the rolls
  reversed plus a static slice. Both are fully vectorized over shots.
* LMO applies a per-trace fractional time shift as an rFFT phase ramp — one
  batched FFT + elementwise complex multiply, unitary up to the circular
  wrap, adjoint = conjugate phase.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space

__all__ = ["blend_operator", "lmo_operator", "reghost_operator"]


def _blend_df(dm, m0, state):
    T = state["T"]
    nt = dm.shape[-1]
    padded = jnp.pad(dm, [(0, 0), (0, T - nt)])
    rolled = jax.vmap(lambda tr, t0: jnp.roll(tr, t0))(padded, state["t0"])
    return jnp.sum(rolled, axis=0)


def _blend_dft(dd, m0, state):
    nt = state["nt"]
    unrolled = jax.vmap(lambda t0: jnp.roll(dd, -t0))(state["t0"])
    return unrolled[:, :nt]


def blend_operator(nshots: int, nt: int, firing_times, T: int,
                   dtype=jnp.float32) -> LinearOperator:
    """Simultaneous-source blending: domain is the unblended shot gather
    ``(nshots, nt)``, range the continuous record ``(T,)`` with shot ``s``
    added at integer sample ``firing_times[s]``. Requires
    ``max(firing_times) + nt <= T`` so rolls never wrap live samples."""
    t0 = np.asarray(firing_times, dtype=np.int32)
    if t0.shape != (nshots,):
        raise ValueError(f"need {nshots} firing times, got {t0.shape}")
    if t0.min() < 0 or int(t0.max()) + nt > T:
        raise ValueError("firing_times must satisfy 0 <= t0 and t0 + nt <= T")
    dom = Space((nshots, nt), dtype)
    rng = Space((T,), dtype)
    j = Jet(
        dom=dom,
        rng=rng,
        df=_blend_df,
        dft=_blend_dft,
        state={"t0": jnp.asarray(t0), "T": int(T), "nt": int(nt)},
    )
    return LinearOperator(j)


def _lmo_df(dm, m0, state):
    n = dm.shape[-1]
    D = jnp.fft.rfft(dm, axis=-1)
    return jnp.fft.irfft(D * state["phase"], n=n, axis=-1)


def _lmo_dft(dd, m0, state):
    n = dd.shape[-1]
    D = jnp.fft.rfft(dd, axis=-1)
    return jnp.fft.irfft(D * jnp.conj(state["phase"]), n=n, axis=-1)


def lmo_operator(space: Space, dt: float, offsets, slowness: float
                 ) -> LinearOperator:
    """Linear moveout on a ``(ntrace, nt)`` gather: trace ``i`` is advanced
    by ``slowness * offsets[i]`` seconds (fractional, circular) via an rFFT
    phase ramp along the last axis. Unimodular phase ⇒ adjoint is the
    conjugate ramp (the reverse moveout)."""
    if space.ndim != 2:
        raise ValueError("lmo_operator expects a (ntrace, nt) space")
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("lmo_operator needs a real floating space")
    ntrace, nt = space.shape
    offs = np.asarray(offsets, dtype=np.float64)
    if offs.shape != (ntrace,):
        raise ValueError(f"need {ntrace} offsets, got {offs.shape}")
    tau = slowness * offs  # seconds to ADVANCE each trace by
    f = np.fft.rfftfreq(nt, d=dt)
    # x(t + tau) has spectrum X(f) e^{+2πi f τ} (advance = moveout removal)
    phase = np.exp(+2j * np.pi * f[None, :] * tau[:, None])
    cdtype = np.complex128 if np.dtype(space.dtype) == np.float64 else np.complex64
    j = Jet(
        dom=space,
        rng=space,
        df=_lmo_df,
        dft=_lmo_dft,
        state={"phase": jnp.asarray(phase.astype(cdtype))},
    )
    return LinearOperator(j)


def _reghost_df(dm, m0, state):
    D = jnp.fft.fft2(dm)
    return jnp.real(jnp.fft.ifft2(D * state["G"]))


def _reghost_dft(dd, m0, state):
    D = jnp.fft.fft2(dd)
    # FK multiplier adjoint: conjugate-reflected filter; our G is built
    # Hermitian-symmetric (real impulse response), so conj(G) suffices
    return jnp.real(jnp.fft.ifft2(D * jnp.conj(state["G"])))


def reghost_operator(
    space: Space,
    dt: float,
    dx: float,
    depth: float,
    c: float = 1500.0,
    sea_surface_reflectivity: float = -1.0,
) -> LinearOperator:
    """Receiver-side ghost model in the FK domain (the ``JopReghost`` /
    JetPackWaveFD family, companion packs named at
    ``docs/src/index.md:14-19``): a ghost-free ``(nx, nt)`` gather acquires
    the surface ghost ``d_ghost = (1 + R e^{-2 i ω k_z(depth)/ω ...})``,
    i.e. each plane-wave component is delayed by the two-way vertical
    travel to the free surface and scaled by the reflectivity ``R``.

    ``G(f, k) = 1 + R exp(-4 π i k_z depth)`` with
    ``k_z = sqrt((f/c)² - k²)`` for propagating waves and exponentially
    decaying (evanescent) amplitude beyond the critical wavenumber. Purely
    diagonal in FK ⇒ one batched 2-D FFT each way; adjoint is the conjugate
    multiplier. Hermitian symmetry of ``G`` keeps real gathers real.
    """
    if space.ndim != 2:
        raise ValueError("reghost_operator expects a (nx, nt) space")
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("reghost_operator needs a real floating space")
    nx, nt = space.shape
    f = np.fft.fftfreq(nt, d=dt)          # temporal frequency (Hz)
    k = np.fft.fftfreq(nx, d=dx)          # spatial wavenumber (1/m)
    F = np.broadcast_to(f.reshape(1, nt), (nx, nt))
    K = np.broadcast_to(k.reshape(nx, 1), (nx, nt))
    kz2 = (F / c) ** 2 - K ** 2
    prop = kz2 >= 0.0
    kz = np.sqrt(np.abs(kz2))
    # propagating: pure phase delay with SIGNED frequency (odd in f, so G is
    # Hermitian and real gathers stay exactly real); evanescent: real decay
    phase = np.where(prop, np.exp(-4j * np.pi * np.sign(F) * kz * depth),
                     np.exp(-4.0 * np.pi * kz * depth))
    G = 1.0 + sea_surface_reflectivity * phase
    cdtype = np.complex128 if np.dtype(space.dtype) == np.float64 else np.complex64
    j = Jet(
        dom=space,
        rng=space,
        df=_reghost_df,
        dft=_reghost_dft,
        state={"G": jnp.asarray(G.astype(cdtype))},
    )
    return LinearOperator(j)
