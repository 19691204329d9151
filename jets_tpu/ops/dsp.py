"""Signal-processing operators — the ``JetPackDSP`` companion family.

The reference repo ships no DSP ops; its ecosystem does (``JetPackDSP``,
named in ``/root/reference/docs/src/index.md:14-19``). These are the
seismic-workflow staples: edge tapers, band-pass filters, fractional time
shifts, Fourier resampling, and mutes — all linear, all gated by the
dot-product test.

Notes: every op here is either a real diagonal in the sample domain
(taper, mute — self-adjoint by inspection) or a diagonal in the Fourier
domain applied through the unitary rFFT (bandpass: real mask ⇒ self-adjoint;
shift: unimodular phase ⇒ adjoint = conjugate phase). Fourier resampling's
adjoint is derived via ``jax.linear_transpose``. Everything is static-shape
``jnp`` code that XLA fuses around the FFTs.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..core.jet import Jet, LinearOperator
from ..core.spaces import Space
from .diagonal import diagonal_operator

__all__ = [
    "taper_operator",
    "translation_operator",
    "mix_operator",
    "roughness_operator",
    "envelope_operator",
    "bandpass_operator",
    "shift_operator",
    "resample_operator",
    "mute_operator",
]


def _cosine_ramp(n, width, dtype):
    """Edge weights for one axis: cosine ramp of ``width`` samples at each
    end, flat 1 in between."""
    w = np.ones(n, dtype=dtype)
    if width > 0:
        r = 0.5 * (1.0 - np.cos(np.pi * (np.arange(width) + 0.5) / width))
        w[:width] = r
        w[n - width:] = r[::-1]
    return w


def taper_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Cosine edge taper: multiply by a separable weight that ramps from 0
    at each boundary over ``widths[ax]`` samples. Real diagonal ⇒
    self-adjoint."""
    widths = tuple(int(w) for w in widths)
    if len(widths) != space.ndim:
        raise ValueError(f"need {space.ndim} widths, got {len(widths)}")
    rdtype = np.dtype(space.dtype)
    if rdtype.kind == "c":
        rdtype = np.float64 if rdtype == np.complex128 else np.float32
    w = np.ones(space.shape, dtype=rdtype)
    for ax, (n, width) in enumerate(zip(space.shape, widths)):
        if 2 * width > n:
            raise ValueError(f"taper width {width} too large for axis {ax}")
        shape = [1] * space.ndim
        shape[ax] = n
        w = w * _cosine_ramp(n, width, rdtype).reshape(shape)
    return diagonal_operator(jnp.asarray(w, dtype=space.dtype))


def _bandpass_mask(n, dt, f_lo, f_hi, f_taper, dtype):
    f = np.fft.rfftfreq(n, d=dt)
    m = np.zeros(f.shape, dtype=dtype)
    m[(f >= f_lo) & (f <= f_hi)] = 1.0
    if f_taper > 0.0:
        lo_ramp = (f >= f_lo - f_taper) & (f < f_lo)
        m[lo_ramp] = 0.5 * (1.0 - np.cos(np.pi * (f[lo_ramp] - (f_lo - f_taper)) / f_taper))
        hi_ramp = (f > f_hi) & (f <= f_hi + f_taper)
        m[hi_ramp] = 0.5 * (1.0 + np.cos(np.pi * (f[hi_ramp] - f_hi) / f_taper))
    return m


def _bp_df(dm, m0, state):
    ax = state["axis"]
    n = dm.shape[ax]
    D = jnp.fft.rfft(dm, axis=ax)
    mask = state["mask"]
    shape = [1] * dm.ndim
    shape[ax] = mask.shape[0]
    return jnp.fft.irfft(D * mask.reshape(shape), n=n, axis=ax)


def bandpass_operator(
    space: Space,
    dt: float,
    f_lo: float,
    f_hi: float,
    f_taper: float = 0.0,
    axis: int = -1,
) -> LinearOperator:
    """Zero-phase band-pass along ``axis`` (sample interval ``dt``): rFFT →
    real cosine-tapered mask on [f_lo, f_hi] → irFFT. Real even filter ⇒
    the operator is symmetric (self-adjoint)."""
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("bandpass_operator needs a real floating space")
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    mask = _bandpass_mask(n, dt, f_lo, f_hi, f_taper, np.dtype(space.dtype))
    j = Jet(
        dom=space,
        rng=space,
        df=_bp_df,
        dft="self",
        state={"mask": jnp.asarray(mask), "axis": axis},
    )
    return LinearOperator(j)


def _shift_df(dm, m0, state):
    ax = state["axis"]
    n = dm.shape[ax]
    D = jnp.fft.rfft(dm, axis=ax)
    ph = state["phase"]
    shape = [1] * dm.ndim
    shape[ax] = ph.shape[0]
    return jnp.fft.irfft(D * ph.reshape(shape), n=n, axis=ax)


def _shift_dft(dd, m0, state):
    ax = state["axis"]
    n = dd.shape[ax]
    D = jnp.fft.rfft(dd, axis=ax)
    ph = jnp.conj(state["phase"])
    shape = [1] * dd.ndim
    shape[ax] = ph.shape[0]
    return jnp.fft.irfft(D * ph.reshape(shape), n=n, axis=ax)


def shift_operator(
    space: Space, shift: float, dt: float = 1.0, axis: int = -1
) -> LinearOperator:
    """Periodic (possibly fractional) shift by ``shift`` time units along
    ``axis``: unimodular phase ramp in the Fourier domain. Unitary; the
    hand-written adjoint is the conjugate phase (= shift back)."""
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("shift_operator needs a real floating space")
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    f = np.fft.rfftfreq(n, d=dt)
    ph = np.exp(-2j * np.pi * f * shift)
    # keep irfft exactly real for even n: the Nyquist bin must stay real
    if n % 2 == 0:
        ph[-1] = np.real(ph[-1])
    ph[0] = 1.0
    cdtype = np.complex128 if space.dtype == jnp.float64 else np.complex64
    j = Jet(
        dom=space,
        rng=space,
        df=_shift_df,
        dft=_shift_dft,
        state={"phase": jnp.asarray(ph, dtype=cdtype), "axis": axis},
    )
    return LinearOperator(j)


def resample_operator(
    space: Space, n_out: int, axis: int = -1
) -> LinearOperator:
    """Fourier (sinc) resampling along ``axis`` from ``n`` to ``n_out``
    samples: rFFT, truncate or zero-pad the spectrum, irFFT at the new
    length, amplitude-preserving scale ``n_out/n``. Adjoint derived via
    ``jax.linear_transpose``."""
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("resample_operator needs a real floating space")
    axis = int(axis) % space.ndim
    n = space.shape[axis]
    n_out = int(n_out)
    k_in, k_out = n // 2 + 1, n_out // 2 + 1
    k = min(k_in, k_out)
    scale = float(n_out) / float(n)

    def _df(dm, m0, state):
        D = jnp.fft.rfft(dm, axis=axis)
        sl = [slice(None)] * dm.ndim
        sl[axis] = slice(0, k)
        D = D[tuple(sl)]
        if k_out > k:
            pads = [(0, 0)] * dm.ndim
            pads[axis] = (0, k_out - k)
            D = jnp.pad(D, pads)
        return scale * jnp.fft.irfft(D, n=n_out, axis=axis)

    rng_shape = list(space.shape)
    rng_shape[axis] = n_out
    j = Jet(dom=space, rng=Space(tuple(rng_shape), space.dtype), df=_df)
    return LinearOperator(j)


def mute_operator(space: Space, mask) -> LinearOperator:
    """Binary (or soft) mute: diagonal multiply by ``mask`` — the windowing
    workhorse of seismic processing. Real mask ⇒ self-adjoint."""
    mask = jnp.asarray(mask, dtype=space.dtype)
    if mask.shape != space.shape:
        raise ValueError(f"mask shape {mask.shape} != space {space.shape}")
    return diagonal_operator(mask)


def _box_sum(x, widths):
    """Zero-padded 'same' box-window sum via ``lax.reduce_window`` — the
    VPU-friendly separable moving sum."""
    return lax.reduce_window(
        x,
        jnp.zeros((), x.dtype),
        lax.add,
        window_dimensions=widths,
        window_strides=(1,) * x.ndim,
        padding="SAME",
    )


def _mix_df(dm, m0, state):
    return state["scale"] * _box_sum(dm, state["widths"])


def mix_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Box moving average ('mix', JetPack's ``JopMix``): separable
    odd-length box windows per axis, zero boundary, normalized by the full
    window size. Symmetric kernel + zero padding ⇒ self-adjoint."""
    widths = tuple(int(w) for w in widths)
    if len(widths) != space.ndim:
        raise ValueError(f"need {space.ndim} widths, got {len(widths)}")
    if any(w < 1 or w % 2 == 0 for w in widths):
        raise ValueError("mix widths must be odd and >= 1")
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("mix_operator needs a real floating space")
    scale = 1.0 / float(np.prod(widths))
    j = Jet(
        dom=space,
        rng=space,
        df=_mix_df,
        dft="self",
        state={"widths": widths, "scale": jnp.asarray(scale, space.dtype)},
    )
    return LinearOperator(j)


def _rough_df(dm, m0, state):
    return dm - state["scale"] * _box_sum(dm, state["widths"])


def roughness_operator(space: Space, widths: Sequence[int]) -> LinearOperator:
    """Roughness (JetPack's ``JopRoughness``): the residual after box
    smoothing, ``R = I - Mix``. Self-adjoint because Mix is; penalizing
    ``||R m||`` regularizes toward smooth models."""
    widths = tuple(int(w) for w in widths)
    if len(widths) != space.ndim:
        raise ValueError(f"need {space.ndim} widths, got {len(widths)}")
    if any(w < 1 or w % 2 == 0 for w in widths):
        raise ValueError("roughness widths must be odd and >= 1")
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("roughness_operator needs a real floating space")
    scale = 1.0 / float(np.prod(widths))
    j = Jet(
        dom=space,
        rng=space,
        df=_rough_df,
        dft="self",
        state={"widths": widths, "scale": jnp.asarray(scale, space.dtype)},
    )
    return LinearOperator(j)


def _hilbert(x, axis):
    """Hilbert transform of a real signal: imag part of the analytic
    signal, via full FFT with the one-sided multiplier."""
    n = x.shape[axis]
    X = jnp.fft.fft(x, axis=axis)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[axis] = n
    analytic = jnp.fft.ifft(X * jnp.asarray(h).reshape(shape), axis=axis)
    return jnp.imag(analytic)


def _env_f(m, state):
    h = _hilbert(m, state["axis"])
    return jnp.sqrt(m * m + h * h + state["eps"])

def _env_upstate(m0, state):
    h0 = _hilbert(m0, state["axis"])
    e0 = jnp.sqrt(m0 * m0 + h0 * h0 + state["eps"])
    return {"h0": h0, "e0": e0}


def _env_df(dm, m0, state):
    h0, e0 = state["h0"], state["e0"]
    return (m0 * dm + h0 * _hilbert(dm, state["axis"])) / e0


def _env_dft(dd, m0, state):
    # H is skew-adjoint (H^T = -H for real signals), so the transpose of
    # dm -> (m0*dm + h0*H(dm))/e0 is dd -> m0/e0*dd - H(h0/e0*dd).
    h0, e0 = state["h0"], state["e0"]
    return (m0 / e0) * dd - _hilbert((h0 / e0) * dd, state["axis"])


def envelope_operator(space: Space, axis: int = -1,
                      eps: float = 1e-20) -> "Operator":
    """Instantaneous-amplitude envelope (JetPackDSP's ``JopEnvelope``):
    ``e = sqrt(m^2 + H(m)^2 + eps)`` with the Hilbert transform ``H`` along
    ``axis``. Nonlinear; the tangent/adjoint pair uses the precomputed
    linearization-point envelope (``upstate`` hook)."""
    from ..core.jet import Operator
    if not jnp.issubdtype(space.dtype, jnp.floating):
        raise TypeError("envelope_operator needs a real floating space")
    axis = int(axis) % space.ndim
    j = Jet(
        dom=space,
        rng=space,
        f=_env_f,
        df=_env_df,
        dft=_env_dft,
        upstate=_env_upstate,
        state={"axis": axis, "eps": jnp.asarray(eps, space.dtype),
               "h0": None, "e0": None},
    )
    return Operator(j)


def translation_operator(space: Space, shifts: Sequence[float],
                         dts: Sequence[float] | None = None):
    """n-D (possibly fractional) periodic translation (JetPack's
    ``JopTranslation``): the separable composition of per-axis Fourier
    :func:`shift_operator`s — each axis is one batched rFFT phase ramp.
    ``shifts[ax]`` is in the units of ``dts[ax]`` (samples if omitted)."""
    shifts = tuple(float(s) for s in shifts)
    if len(shifts) != space.ndim:
        raise ValueError(f"need {space.ndim} shifts, got {len(shifts)}")
    dts = (1.0,) * space.ndim if dts is None else tuple(float(d) for d in dts)
    op = None
    for ax, (s, dt) in enumerate(zip(shifts, dts)):
        if s == 0.0:
            continue
        nxt = shift_operator(space, s, dt=dt, axis=ax)
        op = nxt if op is None else (nxt @ op)
    if op is None:
        from .transforms import identity_operator
        return identity_operator(space)
    return op
