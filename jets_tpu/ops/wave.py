"""Acoustic wave-equation operators — the JetPackWaveFD equivalent of the
reference family (``docs/src/index.md:14-19`` names JetPackWaveFD as the
wave-equation FD operator pack; none of it lives in the reference repo, so
this is a from-scratch JAX design).

Physics: constant-density acoustic wave equation, 2nd-order in time,
2nd-order in space,

    u_tt = c^2 ∇²u + s(t) δ(x - xs)

time-stepped by an explicit leapfrog scheme inside ``lax.scan`` (static trip
count → one compiled XLA loop; the 2-D/3-D Laplacian is the shift-and-add
stencil, pure elementwise work). Absorbing boundaries via a sponge taper.

Operators:

* :func:`wave_propagator` — nonlinear forward modeling ``F: c → d``
  (velocity model to receiver traces). Jacobian/adjoint come from JAX
  autodiff through the scan with ``jax.checkpoint`` on the step function —
  memory stays O(grid) per remat segment instead of O(grid × nt).
* :func:`born_operator` — the linearized (Born) modeling operator
  ``J = dF/dc|_{c0}`` as a :class:`LinearOperator` pinned at ``c0``; its
  adjoint is reverse-mode through the propagator (the imaging condition),
  exact by construction and certified by the dot-product gate.

This operator is the framework's showcase that *nonlinear* jets with
autodiff-derived tangent/adjoint slot into the same algebra and solvers as
hand-written ones.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space

__all__ = [
    "wave_propagator",
    "born_operator",
    "multishot_wave_operator",
    "vd_wave_propagator",
    "q_wave_propagator",
    "vdq_wave_propagator",
    "cpml_wave_propagator",
    "offgrid_wave_propagator",
    "vti_wave_propagator",
    "tti_wave_propagator",
    "multishot_vti_wave_operator",
    "multishot_tti_wave_operator",
]


from .stencil import laplacian_nd as _laplacian  # shared implementation


def _check_space_order(order: int) -> int:
    """Validate the spatial accuracy order at operator CONSTRUCTION time so a
    bad value raises a clear ``ValueError`` instead of a ``KeyError`` from
    ``_D2_COEFFS``/``_D1_COEFFS`` deep inside jit tracing (mirrors
    ``laplacian_operator``'s check, ``ops/stencil.py``)."""
    if order not in (2, 4, 8):
        raise ValueError(f"space_order must be one of (2, 4, 8), got {order}")
    return int(order)


def _sponge(shape, width: int, strength: float = 0.015,
            free_surface: bool = False):
    """Absorbing-boundary damping profile (cosine taper to the edges).
    With ``free_surface`` the TOP edge of axis 0 is left undamped: the
    zero-padded stencil boundary there acts as a pressure-release surface
    (u = 0), producing the surface ghost/multiples of marine acquisition
    (JetPackWaveFD's free-surface option)."""
    prof = jnp.ones(shape, jnp.float32)
    for ax, n in enumerate(shape):
        x = jnp.arange(n)
        if free_surface and ax == 0:
            edge = (n - 1 - x).astype(jnp.float32)   # damp only the bottom
        else:
            edge = jnp.minimum(x, n - 1 - x).astype(jnp.float32)
        damp = jnp.where(
            edge < width,
            jnp.exp(-strength * (width - edge) ** 2 / width),
            1.0,
        )
        prof = prof * damp.reshape(
            tuple(n if i == ax else 1 for i in range(len(shape)))
        )
    return prof


def _sponge_factors(shape, width: int, strength: float = 0.015,
                    free_surface: bool = False):
    """The per-axis 1-D factors of :func:`_sponge` (broadcastable shapes),
    left UNFUSED so the time step can recompute their product in-register
    instead of reading a full-grid sponge array from device memory: one
    grid touch fewer per step on a memory-bound 3-D grid. In float32 the
    factor product ``(d0·d1)·d2`` is bit-identical to the stored full-grid
    sponge (same multiplication tree); in float64 the factors are upcast
    before the product (the stored sponge was computed in f32), so
    equality is to roundoff there."""
    factors = []
    for ax, n in enumerate(shape):
        x = jnp.arange(n)
        if free_surface and ax == 0:
            edge = (n - 1 - x).astype(jnp.float32)
        else:
            edge = jnp.minimum(x, n - 1 - x).astype(jnp.float32)
        damp = jnp.where(
            edge < width,
            jnp.exp(-strength * (width - edge) ** 2 / width),
            1.0,
        )
        factors.append(damp.reshape(
            tuple(n if i == ax else 1 for i in range(len(shape)))
        ))
    return tuple(factors)


def _make_sponge(shape, width: int, strength: float = 0.015,
                 free_surface: bool = False, dtype=jnp.float32):
    """Sponge in the representation the step should use: a full-grid array
    for 1-/2-D grids (small enough to stay in cache), a tuple of per-axis
    factors for 3-D+ grids (one fewer full-grid read per step)."""
    if len(shape) >= 3:
        return tuple(f.astype(dtype) for f in _sponge_factors(
            shape, width, strength, free_surface))
    return _sponge(shape, width, strength, free_surface).astype(dtype)


def _mul_sponge(e, sponge):
    """Apply a sponge in either representation (full array or factor
    tuple); the factor product is bit-identical to the full array."""
    if isinstance(sponge, tuple):
        s = sponge[0]
        for p in sponge[1:]:
            s = s * p
        return e * s
    return e * sponge


def _iota_src_mask(shape, src_idx, amp):
    """One-hot source mask computed IN-REGISTER from broadcasted iotas —
    no memory traffic, vs a full-grid read for a stored dense mask. Values
    identical to
    ``zeros.at[src_idx].set(amp)``. Works under vmap (per-shot ``src_idx``
    broadcasts)."""
    nd = len(shape)
    flat = lax.broadcasted_iota(jnp.int32, shape, 0)
    for a in range(1, nd):
        flat = flat * shape[a] + lax.broadcasted_iota(jnp.int32, shape, a)
    return jnp.where(flat == src_idx, amp, jnp.zeros_like(amp))


def _ricker(nt: int, dt: float, freq: float, dtype=jnp.float32):
    # delay so the peak fires well inside the simulated window even for
    # short runs (standard 1/freq delay, capped at a quarter of the window)
    t0 = min(1.0 / freq, 0.25 * nt * dt)
    t = jnp.arange(nt, dtype=dtype) * dt - t0
    a = (jnp.pi * freq * t) ** 2
    return ((1 - 2 * a) * jnp.exp(-a)).astype(dtype)


def _trace_resampler(nt: int, dt: float, dtrec, dtype=jnp.float32):
    """Recording-grid time interpolation — JetPackWaveFD's ``dtmod``/
    ``dtrec`` split: the FD scheme steps at the CFL-limited modeling ``dt``
    while data live on a coarser recording grid ``dtrec``. Returns
    ``(ntrec, resample)`` where ``resample`` linearly interpolates
    ``(nt, ...)`` fine-grid traces onto the ``ntrec`` recording samples
    (differentiable — the derived adjoint is the linear-interpolation
    transpose, i.e. the reference family's adjoint trace injection).
    ``dtrec=None`` is the identity (record every modeling step)."""
    if dtrec is None:
        return nt, None
    import numpy as np

    dtrec = float(dtrec)
    if dtrec < dt - 1e-12:
        raise ValueError(f"dtrec={dtrec} must be >= modeling dt={dt}")
    ntrec = int(np.floor((nt - 1) * dt / dtrec + 1e-9)) + 1
    t = np.arange(ntrec) * (dtrec / dt)
    i0 = np.minimum(np.floor(t).astype(np.int64), max(nt - 2, 0))
    w = (t - i0).astype(np.dtype(dtype) if np.dtype(dtype).kind == "f"
                        else np.float32)
    i0_j = jnp.asarray(i0, jnp.int32)
    w_j = jnp.asarray(w, dtype)

    def resample(traces):
        wshape = (ntrec,) + (1,) * (traces.ndim - 1)
        wb = w_j.reshape(wshape)
        lo = jnp.take(traces, i0_j, axis=0)
        hi = jnp.take(traces, jnp.minimum(i0_j + 1, nt - 1), axis=0)
        return (1.0 - wb) * lo + wb * hi

    return ntrec, resample


def _scan_remat(step, carry, xs, remat_blocks: int):
    """``lax.scan`` with blocked rematerialization — the on-device stand-in
    for JetPackWaveFD's compressed wavefield serialization: instead of
    writing forward wavefields to disk for the adjoint pass, time steps are
    grouped into ``remat_blocks`` checkpointed segments, so reverse-mode
    stores O(remat_blocks + nt/remat_blocks) wavefields (minimized at
    ``remat_blocks ≈ √nt``) and recomputes inside each segment, instead of
    storing all ``nt`` step carries."""
    nt = int(xs.shape[0])
    if remat_blocks > 1 and nt % remat_blocks != 0:
        # don't silently drop the O(√nt) memory saving: snap to the nearest
        # divisor of nt (warning), so the blocked structure is preserved
        import warnings

        divisors = [k for k in range(2, nt + 1) if nt % k == 0]
        if divisors:
            snapped = min(divisors, key=lambda k: abs(k - remat_blocks))
            warnings.warn(
                f"remat_blocks={remat_blocks} does not divide nt={nt}; "
                f"using the nearest divisor {snapped} instead",
                stacklevel=2,
            )
            remat_blocks = snapped
        else:  # nt == 1
            remat_blocks = 1
    if remat_blocks <= 1:
        return lax.scan(jax.checkpoint(step, prevent_cse=False), carry, xs)
    blk = nt // remat_blocks
    xs_b = xs.reshape((remat_blocks, blk) + xs.shape[1:])

    # Closure-convert the step for the blocked (checkpoint-of-scan) path:
    # traced values captured in its closure (e.g. c²dt² derived from the
    # traced model) must cross the checkpoint boundary as explicit
    # loop-invariant state — a closed-over tracer would otherwise leak into
    # the remat jaxpr's constants, which some lowerings (custom calls,
    # kernels) cannot handle. The consts ride the scan carry unchanged —
    # XLA hoists invariant while-loop state, so this costs nothing per
    # step.
    x0 = jax.tree_util.tree_map(lambda a: a[0], xs)
    step_cc, consts = jax.closure_convert(step, carry, x0)
    consts = tuple(consts)

    def inner_fn(cc, x):
        c, ks = cc
        nc, y = step_cc(c, x, *ks)
        return (nc, ks), y

    inner = jax.checkpoint(inner_fn, prevent_cse=False)

    @jax.checkpoint
    def outer(cc, xb):
        return lax.scan(inner, cc, xb)

    (carry, _), traces = lax.scan(outer, (carry, consts), xs_b)
    return carry, traces.reshape((nt,) + traces.shape[2:])


def _store_codec(store: str, dtype):
    """Per-snapshot (enc, dec) for the stored-wavefield adjoints: ``f32``
    lossless, ``bf16`` 2× smaller, ``int8`` max-abs-scaled 4× smaller (the
    CvxCompress-style lossy trade of the reference family's production
    imaging, ``/root/reference/docs/src/index.md:17``). ``enc`` returns
    ``(encoded, scale)``; ``dec(encoded, scale)`` inverts it."""
    if store == "f32":
        return (lambda u: (u, jnp.ones((), dtype))), (lambda q, s: q)
    if store == "bf16":
        return (lambda u: (u.astype(jnp.bfloat16), jnp.ones((), dtype)),
                lambda q, s: q.astype(dtype))
    if store == "int8":
        def enc(u):
            s = jnp.maximum(jnp.max(jnp.abs(u)),
                            jnp.asarray(1e-30, dtype))
            return jnp.round(u * (127.0 / s)).astype(jnp.int8), s

        return enc, (lambda q, s: q.astype(dtype) * (s / 127.0))
    raise ValueError(
        f"store must be one of ('f32', 'bf16', 'int8'), got {store!r}"
    )


def _propagate(c, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
               remat_blocks, order: int = 2, src_mask=None, extract=None,
               wavefield_sharding=None):
    """Leapfrog time stepping; returns receiver traces (nt, nrcv).

    ``remat_blocks`` groups time steps into checkpointed segments so
    reverse-mode memory is O(grid · (remat_blocks + nt/remat_blocks))
    instead of O(grid · nt) — see :func:`_scan_remat`. ``order`` is the
    spatial accuracy of the Laplacian (2/4/8 — the JetPackWaveFD ladder).
    ``src_mask``/``extract`` override the default on-grid point injection /
    flat-gather extraction (used by the off-grid Kaiser-sinc geometry).

    ``wavefield_sharding`` (a ``NamedSharding``) constrains the scan-carry
    wavefields so the GRID AXIS of the model shards over the mesh — the
    "model larger than one device's memory" axis of BASELINE config #5:
    under ``jit``, XLA/GSPMD partitions the whole leapfrog and inserts the
    stencil's halo exchanges as collective-permutes.
    """
    shape = c.shape
    c2dt2 = (c * c) * (dt * dt) / (dx * dx)

    # one-hot source mask: a scatter inside the step is its own un-fused
    # XLA op per time step; a mask add fuses into the same elementwise pass
    # as the leapfrog update. In 1-/2-D the mask is a stored dense array;
    # in 3-D it is recomputed in-register from iotas, which saves a
    # full-grid read per step. Values are identical either way.
    size = 1
    for s in shape:
        size *= int(s)
    iota_src = src_mask is None and len(shape) >= 3
    if src_mask is None and not iota_src:
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )
    if extract is None:
        extract = lambda u: u.reshape(-1)[rcv_idx]  # noqa: E731
    amp = jnp.asarray(dt * dt, c.dtype)

    def step(carry, s_t):
        u_prev, u = carry
        lap = _laplacian(u, order=order)
        mask = (_iota_src_mask(shape, src_idx, amp) if iota_src
                else src_mask)
        u_next = _mul_sponge(2.0 * u - u_prev + c2dt2 * lap, sponge) \
            + s_t * mask
        rec = extract(u_next)
        return (u, u_next), rec

    # seed the carry with a src-derived zero so its batching/varying type
    # already matches the loop body's output under vmap/shard_map (the
    # source mask is per-shot data)
    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    if wavefield_sharding is not None:
        # pin the scan-carry sharding so GSPMD keeps the wavefields
        # grid-sharded through the whole loop (the constraint on the
        # initial carry propagates; without it XLA may replicate)
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)

    (_, _), traces = _scan_remat(step, (u0, u0), src_wavelet, remat_blocks)
    return traces


def _adjoint_stored(c, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
                    order: int = 2, store: str = "int8",
                    wavefield_sharding=None, src_mask=None, inject=None):
    """Adjoint-state gradient ``(∂F/∂c)ᵀ dd`` with a STORED forward-
    wavefield history — the on-device equivalent of JetPackWaveFD's
    production imaging path, where the forward wavefield is serialized
    through the lossy CvxCompress codec and read back during the adjoint
    sweep instead of being recomputed. Here the history stays ON DEVICE,
    compressed per snapshot:

    * ``store="int8"`` — per-snapshot max-abs scaling to int8 (4× smaller
      than f32; the CvxCompress-style lossy trade, gradient direction
      preserved to ~1e-3),
    * ``store="bf16"`` — 2× smaller, ~1e-3 relative error,
    * ``store="f32"`` — lossless; matches reverse-mode autodiff through
      the scan to roundoff (pinned by the suite).

    The reverse sweep is the hand-derived transpose of the leapfrog step
    (the Laplacian is self-adjoint under the zero boundary): with
    ``ē_k = S ⊙ a_{k+1}`` (S the sponge diagonal),

        a_k  = Pᵀ ḡrec_{k-1} + 2ē_k + L(c²dt²·ē_k) − ē_{k+1}
        gc2 += L(u_k) ⊙ ē_k          (u_k read from the stored history)

    so adjoint memory is O(nt·grid/ratio) with NO recomputation — the
    complementary point to ``remat_blocks`` (O(√nt·grid) with a 2nd
    forward sweep) on the reference family's storage/recompute trade
    (``utils/compression.py`` holds the host-side codec + SnapshotStore
    half of that slot)."""
    shape = c.shape
    dtype = c.dtype
    c2dt2 = (c * c) * (dt * dt) / (dx * dx)
    size = 1
    for s in shape:
        size *= int(s)
    iota_src = src_mask is None and len(shape) >= 3
    amp = jnp.asarray(dt * dt, dtype)
    if src_mask is None and not iota_src:
        src_mask = (
            jnp.zeros((size,), dtype).at[src_idx].set(dt * dt).reshape(shape)
        )

    def mask():
        return (_iota_src_mask(shape, src_idx, amp) if iota_src
                else src_mask)

    enc, dec = _store_codec(store, dtype)

    # seed zeros with a src-derived term so their varying/batching type
    # already matches the scan outputs under shard_map/vmap (same trick
    # as _propagate's carry seeding)
    zero = (src_idx * 0).astype(dtype)
    u0 = jnp.zeros(shape, dtype) + zero
    if wavefield_sharding is not None:
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)
    nt = int(src_wavelet.shape[0])

    if inject is None:
        def inject(row):
            return (jnp.zeros((size,), dtype).at[rcv_idx].add(row)
                    .reshape(shape))

    # ḡrec_{k-1} aligned to reverse iteration k (rec_k samples u_{k+1})
    dd = dd.astype(dtype)
    dd_shift = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], dtype), dd[:-1]], axis=0)

    def fstep(carry, s_t):
        u_prev, u = carry
        u_next = _mul_sponge(
            2.0 * u - u_prev + c2dt2 * _laplacian(u, order=order), sponge
        ) + s_t * mask()
        return (u, u_next), enc(u)   # history entry k holds u_k

    (_, _), (hist, scales) = lax.scan(fstep, (u0, u0), src_wavelet)

    def bstep(carry, xs):
        a_nxt, ebar_nxt, gc2 = carry
        q, s, grec_prev = xs
        u_k = dec(q, s)
        ebar = _mul_sponge(a_nxt, sponge)
        gc2 = gc2 + _laplacian(u_k, order=order) * ebar
        # sum order: the stencil/sponge core first, the (sparse)
        # receiver injection added last
        a_k = (2.0 * ebar + _laplacian(c2dt2 * ebar, order=order)
               - ebar_nxt) + inject(grec_prev)
        return (a_k, ebar, gc2), None

    carry0 = (inject(dd[-1]), u0, u0)
    (_, _, gc2), _ = lax.scan(bstep, carry0, (hist, scales, dd_shift),
                              reverse=True)
    return gc2 * (2.0 * c) * jnp.asarray((dt * dt) / (dx * dx), dtype)


def wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    free_surface: bool = False,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype=jnp.float32,
) -> Operator:
    """Nonlinear forward-modeling operator ``F: velocity c → traces d``.

    ``wavefield_sharding`` (a ``jax.sharding.NamedSharding``) grid-shards
    the propagating wavefields (and the stored adjoint history) over a
    device mesh — the model-larger-than-one-device axis: place the
    velocity with the same sharding and jit; XLA/GSPMD partitions the
    leapfrog and inserts the stencil halo exchanges.

    Domain: the velocity grid. Range: ``(ntrec, nrcv)`` receiver traces —
    ``ntrec = nt`` unless ``dtrec`` (the recording sample interval,
    JetPackWaveFD's ``dtrec`` vs the modeling ``dtmod``) is given, in which
    case the fine-grid traces are linearly interpolated onto the coarser
    recording grid (:func:`_trace_resampler`).
    Tangent/adjoint are JAX jvp/vjp through the rematerialized scan — the
    jet's ``upstate`` hook (reference ``point!``/``upstate!``,
    ``src/Jets.jl:297-301``) is where the linearization point is pinned.
    ``space_order`` ∈ {2, 4, 8} picks the spatial stencil accuracy.

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the adjoint
    from rematerialization to a stored (optionally lossily compressed)
    forward-wavefield history — see :func:`_adjoint_stored`. ``"f32"`` is
    pinned equal to the autodiff adjoint by the suite; ``"int8"`` trades
    ~1e-3 gradient error for 4× less adjoint memory and no recompute
    (the CvxCompress trade of the reference family's production RTM/FWI).
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    sp = Space(grid_shape, dtype)
    if rcv_idx is None:
        n = sp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width,
                          free_surface=free_surface, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)

    def _f(c, state):
        traces = _propagate(
            c, state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, sponge=state["sponge"],
            remat_blocks=remat_blocks, order=space_order,
            wavefield_sharding=wavefield_sharding,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dc, m0, state):
        _, tangent = jax.jvp(lambda c: _f(c, state), (m0,), (dc,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda c: _f(c, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            return _adjoint_stored(
                m0, dd, state["wavelet"], state["src_idx"],
                state["rcv_idx"], dt=dt, dx=dx, sponge=state["sponge"],
                order=space_order, store=store_adjoint,
                wavefield_sharding=wavefield_sharding,
            )

    j = Jet(
        dom=sp,
        rng=rng,
        f=_f,
        df=_df,
        dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


def born_operator(F: Operator, c0) -> LinearOperator:
    """Linearized (Born) modeling operator: the Jacobian of the wave
    propagator pinned at background velocity ``c0``. Forward = demigration,
    adjoint = migration (reverse-time imaging condition)."""
    return F.linearize(c0)


# ---------------------------------------------------------------------------
# Multi-shot modeling — the true BASELINE config #5 workload: an FD
# propagator per shot gather, shots stacked on a leading axis and sharded
# over the mesh "block" axis (DistributedJets' structure with real physics).
# ---------------------------------------------------------------------------


def multishot_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    window_corners=None,
    window_shape: Optional[Sequence[int]] = None,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    free_surface: bool = False,
    boundary: str = "sponge",
    cmax: float = 4000.0,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype=jnp.float32,
) -> Operator:
    """Nonlinear multi-shot modeling ``F: c -> (nshots, ntrec, nrcv)``
    (``shot_map="map"`` runs the local shots as a sequential ``lax.map``
    instead of one vmapped program, holding one shot's wavefields at a
    time) (``ntrec = nt`` unless the recording interval ``dtrec`` is given —
    see :func:`_trace_resampler`).

    Per-shot state is the source location; receivers are a fixed shared
    array. Forward/tangent vmap the leapfrog propagator over shots (and
    shard over the mesh block axis); the adjoint is the per-shot reverse
    propagation summed across shots — a ``psum`` over the mesh in the
    sharded case, exactly the reference's block-adjoint accumulation.

    **Ginsu windowing** (JetPackWaveFD's per-shot model subsetting): pass
    ``window_shape`` (one static shape for every shot — the ragged-window
    design: uniform windows vmap/shard like any stacked
    block) and per-shot ``window_corners`` ``(nshots, ndim)``. Each shot
    then propagates only inside ``c[corner : corner+window_shape]``
    (``lax.dynamic_slice``); ``src_indices``/``rcv_idx`` become
    window-relative flat indices. The adjoint places each shot's model
    update back through the transposed slice (a ``dynamic_update_slice``
    scatter-add, derived — not hand-written — via ``linear_transpose``),
    so gradient accumulation over overlapping windows is exact.

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the
    per-shot adjoint from autodiff to the stored-wavefield sweep
    (:func:`_adjoint_stored`), the production FWI/RTM gradient path (shot
    contributions accumulate via the stacked psum, the reference's
    block-adjoint loop).

    **Boundaries** (marine production multishot): ``free_surface=True``
    leaves the top edge of axis 0 undamped — the zero-padded stencil
    boundary there is a pressure-release surface producing the surface
    ghost/multiples (JetPackWaveFD's free-surface option, as on the
    single-shot propagators). ``boundary="cpml"`` swaps the cosine sponge
    for Pasalic–McGarry convolutional PML per shot (``cmax`` scales the
    static damping profiles); CPML shots ride the XLA step and the
    autodiff adjoint (``store_adjoint``/ginsu compose with the sponge
    boundary only).
    """
    from ..parallel.sharded import stacked_block_operator

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    sp = Space(grid_shape, dtype)
    src_indices = jnp.asarray(src_indices, jnp.int32)
    nshots = int(src_indices.shape[0])
    prop_shape = grid_shape
    if (window_shape is None) != (window_corners is None):
        raise ValueError(
            "ginsu windowing needs BOTH window_shape and window_corners "
            "(or neither)"
        )
    if window_shape is not None:
        import numpy as np

        prop_shape = tuple(int(s) for s in window_shape)
        corners_np = np.asarray(window_corners, np.int64)
        if corners_np.shape != (nshots, len(grid_shape)):
            raise ValueError(
                "window_corners must be (nshots, ndim) when window_shape "
                "is given"
            )
        # corners are concrete at construction: validate them here, because
        # lax.dynamic_slice CLAMPS out-of-bounds starts — an invalid corner
        # would silently model a shifted window (wrong shot location)
        hi = corners_np + np.asarray(prop_shape)
        if (corners_np < 0).any() or (hi > np.asarray(grid_shape)).any():
            bad = np.nonzero(
                (corners_np < 0).any(axis=1)
                | (hi > np.asarray(grid_shape)).any(axis=1)
            )[0]
            raise ValueError(
                f"ginsu window out of bounds for shots {bad.tolist()}: "
                f"need 0 <= corner and corner + {prop_shape} <= {grid_shape}"
            )
        window_corners = jnp.asarray(corners_np, jnp.int32)
    psp = Space(prop_shape, dtype)
    if rcv_idx is None:
        n = psp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    if boundary not in ("sponge", "cpml"):
        raise ValueError(
            f"boundary must be 'sponge' or 'cpml', got {boundary!r}")
    use_cpml = boundary == "cpml"
    if use_cpml and store_adjoint is not None:
        raise ValueError(
            "store_adjoint is not available with CPML boundaries (the "
            "stored sweep transposes the sponge scheme); CPML shots use "
            "the autodiff adjoint")
    if use_cpml and window_shape is not None:
        raise ValueError("ginsu windowing composes with boundary='sponge'")
    sponge = _make_sponge(prop_shape, sponge_width,
                          free_surface=free_surface, dtype=dtype)
    if use_cpml:
        a_prof, b_prof = _cpml_profiles(
            prop_shape, sponge_width, dt, dx, cmax, freq, dtype=dtype,
            free_surface=free_surface)

    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)

    def shot_f(c, bs):
        if window_shape is not None:
            starts = tuple(bs["corner"][i] for i in range(len(prop_shape)))
            c = lax.dynamic_slice(c, starts, prop_shape)
        if use_cpml:
            traces = _propagate_cpml(
                c, bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, a_prof=bs["a_prof"], b_prof=bs["b_prof"],
                order=space_order, remat_blocks=remat_blocks,
            )
        else:
            traces = _propagate(
                c, bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"],
                remat_blocks=remat_blocks, order=space_order,
            )
        return _resample(traces) if _resample is not None else traces

    def shot_df(dc, c0, bs):
        _, tangent = jax.jvp(lambda c: shot_f(c, bs), (c0,), (dc,))
        return tangent

    # Default: NO per-shot dft — an autodiff vjp inside the shard would
    # already psum over the block axis (transpose of the implicit pvary of
    # the replicated model), and the stacked adjoint's psum would
    # double-count. The adjoint is the jet-level linear transpose of the
    # WHOLE sharded tangent. With store_adjoint, the per-shot dft is the
    # EXPLICIT stored-wavefield sweep (no inner vjp, no implicit psum —
    # the stacked psum is then correct, not double-counted).
    shot_dft = None
    if store_adjoint is not None:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def shot_dft(d_b, m0, bs):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (d_b,) = rvjp(d_b)
            c = m0
            if window_shape is not None:
                starts = tuple(bs["corner"][i]
                               for i in range(len(prop_shape)))
                c = lax.dynamic_slice(c, starts, prop_shape)
            g = _adjoint_stored(
                c, d_b, bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
                store=store_adjoint,
            )
            if window_shape is not None:
                g = lax.dynamic_update_slice(
                    jnp.zeros(grid_shape, dtype), g, starts)
            return g

    bstate = {"src": src_indices}
    if window_shape is not None:
        bstate["corner"] = window_corners
    sstate = {"wavelet": wavelet, "sponge": sponge, "rcv": rcv_idx}
    if use_cpml:
        sstate["a_prof"] = tuple(a_prof)
        sstate["b_prof"] = tuple(b_prof)
    return stacked_block_operator(
        nblocks=nshots,
        dom=sp,
        rng_block=Space((ntrec, int(rcv_idx.shape[0])), dtype),
        bstate=bstate,
        sstate=sstate,
        f=shot_f,
        df=shot_df,
        dft=shot_dft,
        mesh=mesh,
        axis=axis,
        shot_map=shot_map,
    )


# ---------------------------------------------------------------------------
# CPML absorbing boundaries — the JetPackWaveFD boundary condition (the
# reference family's FD propagators use PML; the sponge above is the cheap
# default). Second-order-form convolutional PML with two memory variables
# per axis (psi on the first derivative, zeta on the second), after
# Pasalic & McGarry (SEG 2010). Layout: the memory variables are
# FULL-GRID fields whose update coefficients (a, b) are zero/one in the
# interior, so every update is one fused elementwise pass — no boundary
# strips, no scatters, no data-dependent control flow inside the scan.
# ---------------------------------------------------------------------------


# central first-derivative coefficients: du/dx = sum_s c_s (u[i+s] - u[i-s]) / h
_D1_COEFFS = {
    2: (0.5,),
    4: (2.0 / 3.0, -1.0 / 12.0),
    8: (4.0 / 5.0, -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0),
}


def _axslice(nd, ax, hw, s):
    """Slices of an array padded by ``hw`` along ``ax`` only, offset ``s``."""
    return tuple(
        slice(hw + s, (s - hw) or None) if i == ax else slice(None)
        for i in range(nd)
    )


def _d1_axis(x, ax, inv_dx, order: int = 2):
    """Central first derivative along ``ax`` (order 2/4/8), zero boundary."""
    cs = _D1_COEFFS[order]
    hw = len(cs)
    nd = x.ndim
    xp = jnp.pad(x, tuple((hw, hw) if i == ax else (0, 0) for i in range(nd)))
    out = None
    for s, c in enumerate(cs, start=1):
        term = c * (xp[_axslice(nd, ax, hw, s)] - xp[_axslice(nd, ax, hw, -s)])
        out = term if out is None else out + term
    return out * inv_dx


def _d2_axis(x, ax, inv_dx2, order: int = 2):
    """Second derivative along ``ax`` (order 2/4/8), zero boundary."""
    from .stencil import _D2_COEFFS

    c0, cs = _D2_COEFFS[order]
    hw = len(cs)
    nd = x.ndim
    xp = jnp.pad(x, tuple((hw, hw) if i == ax else (0, 0) for i in range(nd)))
    out = c0 * x
    for s, c in enumerate(cs, start=1):
        out = out + c * (xp[_axslice(nd, ax, hw, s)]
                         + xp[_axslice(nd, ax, hw, -s)])
    return out * inv_dx2


def _cpml_profiles(shape, width, dt, dx, cmax, f0, R=1e-3, dtype=jnp.float32,
                   free_surface: bool = False):
    """Per-axis CPML update coefficients ``(a_ax, b_ax)`` as broadcastable
    1-D profiles. ``sigma`` ramps quadratically to
    ``sigma_max = -3 c ln(R) / (2 W dx)`` at the outer edge; ``alpha`` ramps
    linearly from ``pi f0`` at the inner PML edge to 0 outside. In the
    interior ``sigma = alpha = 0`` gives ``b = 1, a = 0`` — the memory
    fields stay identically zero there and the update fuses to a no-op."""
    import numpy as np

    a_profiles, b_profiles = [], []
    sig_max = 3.0 * cmax * np.log(1.0 / R) / (2.0 * width * dx)
    for ax, n in enumerate(shape):
        i = np.arange(n, dtype=np.float64)
        if free_surface and ax == 0:
            # no PML at the top: the stencil's zero boundary is the
            # pressure-release free surface
            depth = np.maximum(width - (n - 1 - i), 0.0) / width
        else:
            depth = np.maximum(width - np.minimum(i, n - 1 - i), 0.0) / width
        sig = sig_max * depth**2
        alpha = np.pi * f0 * (1.0 - depth) * (depth > 0)
        b = np.exp(-(sig + alpha) * dt)
        denom = np.where(sig + alpha > 0, sig + alpha, 1.0)
        a = np.where(sig > 0, sig / denom * (b - 1.0), 0.0)
        bshape = tuple(n if j == ax else 1 for j in range(len(shape)))
        a_profiles.append(jnp.asarray(a, dtype).reshape(bshape))
        b_profiles.append(jnp.asarray(b, dtype).reshape(bshape))
    return a_profiles, b_profiles


def _propagate_cpml(c, src_wavelet, src_idx, rcv_idx, *, dt, dx,
                    a_prof, b_prof, order: int = 2, remat_blocks: int = 1):
    """Leapfrog stepping with CPML memory-variable boundaries. The carry is
    ``(u_prev, u, psi_0..psi_{nd-1}, zeta_0..zeta_{nd-1})`` — note this is a
    ≥4-large-carry scan body (see the de-fusion caveat in CLAUDE.md): CPML
    trades step cost for far lower boundary reflectivity; the sponge path
    stays the perf default."""
    shape = c.shape
    nd = c.ndim
    c2dt2 = (c * c) * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), c.dtype)
    inv_dx = jnp.asarray(1.0 / dx, c.dtype)

    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(dt * dt, c.dtype)
    if not iota_src:
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def step(carry, s_t):
        u_prev, u, psis, zetas = carry
        mask = _iota_src_mask(shape, src_idx, amp) if iota_src else src_mask
        new_psis, new_zetas, lap_terms = [], [], []
        for ax in range(nd):
            d1 = _d1_axis(u, ax, inv_dx, order)
            psi = b_prof[ax] * psis[ax] + a_prof[ax] * d1
            d2 = _d2_axis(u, ax, inv_dx2, order)
            dpsi = _d1_axis(psi, ax, inv_dx, order)
            zeta = b_prof[ax] * zetas[ax] + a_prof[ax] * (d2 + dpsi)
            new_psis.append(psi)
            new_zetas.append(zeta)
            lap_terms.append(d2 + dpsi + zeta)
        lap = lap_terms[0]
        for t in lap_terms[1:]:
            lap = lap + t
        u_next = 2.0 * u - u_prev + c2dt2 * lap + s_t * mask
        rec = u_next.reshape(-1)[rcv_idx]
        return (u, u_next, tuple(new_psis), tuple(new_zetas)), rec

    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    z = tuple(jnp.zeros(shape, c.dtype) for _ in range(nd))
    (_, _, _, _), traces = _scan_remat(step, (u0, u0, z, z), src_wavelet,
                                       remat_blocks)
    return traces


def cpml_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    pml_width: int = 12,
    cmax: float = 4000.0,
    space_order: int = 2,
    remat_blocks: int = 1,
    free_surface: bool = False,
    dtrec: Optional[float] = None,
    dtype=jnp.float32,
) -> Operator:
    """Nonlinear forward modeling ``F: c → d`` with CPML absorbing
    boundaries (Pasalic–McGarry second-order-form convolutional PML).
    Same jet contract as :func:`wave_propagator`; measured boundary
    reflectivity is orders of magnitude below the cosine sponge at equal
    width (see ``tests/test_wavefd.py``). ``cmax`` is the static velocity
    cap used to scale the damping profile (CPML profiles are compile-time
    constants, not functions of the model — keeping the jet linearization
    exact and the profiles out of the gradient)."""
    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    sp = Space(grid_shape, dtype)
    if rcv_idx is None:
        n = sp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    a_prof, b_prof = _cpml_profiles(
        grid_shape, pml_width, dt, dx, cmax, freq, dtype=dtype,
        free_surface=free_surface,
    )
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)

    def _f(c, state):
        traces = _propagate_cpml(
            c, state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, a_prof=state["a_prof"], b_prof=state["b_prof"],
            order=space_order, remat_blocks=remat_blocks,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dc, m0, state):
        _, tangent = jax.jvp(lambda c: _f(c, state), (m0,), (dc,))
        return tangent

    def _dft(dd, m0, state):
        _, vjp = jax.vjp(lambda c: _f(c, state), m0)
        (out,) = vjp(dd)
        return out

    j = Jet(
        dom=sp, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "a_prof": tuple(a_prof),
            "b_prof": tuple(b_prof),
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


# ---------------------------------------------------------------------------
# Variable-density acoustics — JetPackWaveFD's two-parameter (V, B) physics:
#     (1/kappa) p_tt = div(b grad p) + s,   kappa = rho c^2 = c^2 / b
# with b the buoyancy (1/rho). The spatial operator is the staggered
# self-adjoint form  -(D+)^T diag(b_half) (D+)  per axis, so the pinned-b
# pressure operator is exactly symmetric (zero boundary), and the model is
# the BLOCK vector (c, b) — the two-parameter FWI domain is a BlockSpace,
# exercising the block calculus end-to-end through autodiff.
# ---------------------------------------------------------------------------


def _div_b_grad(u, b, inv_dx2):
    """``Σ_ax D⁻(b_{i+1/2} · D⁺u) / dx²`` with zero boundary — symmetric in
    ``u`` for fixed ``b`` by construction (``D⁻ = -(D⁺)ᵀ``)."""
    nd = u.ndim
    out = None
    for ax in range(nd):
        sl_lo = tuple(slice(0, -1) if i == ax else slice(None)
                      for i in range(nd))
        sl_hi = tuple(slice(1, None) if i == ax else slice(None)
                      for i in range(nd))
        dplus = u[sl_hi] - u[sl_lo]                      # at i+1/2
        b_half = 0.5 * (b[sl_hi] + b[sl_lo])
        flux = b_half * dplus
        pads = tuple((1, 1) if i == ax else (0, 0) for i in range(nd))
        fp = jnp.pad(flux, pads)  # zero flux outside the grid
        # cell-centered divergence: div_i = flux_{i+1/2} - flux_{i-1/2}
        dminus = (fp[tuple(slice(1, None) if i == ax else slice(None)
                           for i in range(nd))]
                  - fp[tuple(slice(0, -1) if i == ax else slice(None)
                             for i in range(nd))])
        out = dminus * inv_dx2 if out is None else out + dminus * inv_dx2
    return out


def _propagate_vd(c, b, src_wavelet, src_idx, rcv_idx, *, dt, dx, sponge,
                  remat_blocks: int = 1, g=None):
    """Variable-density leapfrog: p_tt = kappa * div(b grad p) + kappa s.
    With ``g = gamma·dt`` (from a Q model block) the Kosloff constant-Q
    friction term ``2 gamma p_t`` is added — the full IsoDenQ physics of
    the JetPackWaveFD propagators. ``g=None`` keeps the lossless scheme
    bit-exact (no damping factors enter the update at all)."""
    shape = c.shape
    kappa = (c * c) / b
    kdt2 = kappa * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), c.dtype)
    if g is not None:
        inv1pg = 1.0 / (1.0 + g)
        om1g = 1.0 - g

    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(1.0, c.dtype)
    if not iota_src:
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(1.0).reshape(shape)
        )

    def step(carry, s_t):
        p_prev, p = carry
        lap = _div_b_grad(p, b, inv_dx2)
        mask = _iota_src_mask(shape, src_idx, amp) if iota_src else src_mask
        if g is None:
            p_next = _mul_sponge(2.0 * p - p_prev
                                 + kdt2 * (lap + s_t * mask), sponge)
        else:
            p_next = _mul_sponge((2.0 * p - om1g * p_prev
                                  + kdt2 * (lap + s_t * mask)) * inv1pg,
                                 sponge)
        rec = p_next.reshape(-1)[rcv_idx]
        return (p, p_next), rec

    zero = (src_idx * 0).astype(c.dtype)
    p0 = jnp.zeros(shape, c.dtype) + zero
    (_, _), traces = _scan_remat(step, (p0, p0), src_wavelet, remat_blocks)
    return traces


def _div_b_grad_bbar(u, w, inv_dx2):
    """Cotangent on ``b`` of ``b ↦ ⟨w, div(b·grad u)⟩`` at fixed ``u`` —
    the hand-derived b-transpose of :func:`_div_b_grad`: per axis,
    ``flux̄ = w·inv_dx2`` differenced back onto the staggered points
    (``wd[lo] − wd[hi]``), multiplied by the stored ``D⁺u``, and spread
    half-and-half onto the two neighboring cells (the transpose of the
    ``0.5·(b[hi]+b[lo])`` averaging)."""
    nd = u.ndim
    out = None
    wd = w * inv_dx2
    for ax in range(nd):
        sl_lo = tuple(slice(0, -1) if i == ax else slice(None)
                      for i in range(nd))
        sl_hi = tuple(slice(1, None) if i == ax else slice(None)
                      for i in range(nd))
        dplus = u[sl_hi] - u[sl_lo]
        bh_bar = (wd[sl_lo] - wd[sl_hi]) * dplus
        half = 0.5 * bh_bar
        pad_lo = tuple((1, 0) if i == ax else (0, 0) for i in range(nd))
        pad_hi = tuple((0, 1) if i == ax else (0, 0) for i in range(nd))
        contrib = jnp.pad(half, pad_hi) + jnp.pad(half, pad_lo)
        out = contrib if out is None else out + contrib
    return out


def _adjoint_stored_vd(c, b, qf, dd, src_wavelet, src_idx, rcv_idx, *, dt,
                       dx, f0, sponge, store: str = "int8"):
    """Adjoint-state gradient for the variable-density (and, with ``qf``,
    the full IsoDenQ) physics with a STORED encoded pressure history — the
    DenQ sibling of :func:`_adjoint_stored` (the reference family's
    production propagators are all Prop*AcoIsoDenQ,
    ``/root/reference/docs/src/index.md:17``). The reverse sweep is the
    hand-derived transpose of :func:`_propagate_vd`'s leapfrog (``L_b =
    div(b·grad·)`` is self-adjoint in ``p`` for fixed ``b``; the Kosloff
    friction is diagonal, so its factors ride the reverse recurrence
    in-register): with ``K = κ·dt²``, ``sē_k = S⊙a_{k+1}``,
    ``ē_k = ig⊙sē_k``,

        a_k  = Pᵀḡ + 2ē_k + L_b(K·ē_k) − og·ē_{k+1}
        gK  += (L_b(p_k) + s_k·mask)⊙ē_k
        gb  += b̄(p_k, K·ē_k)                  (the L_b b-transpose)
        gig += sē_k·(2p_k + K·(L_b(p_k) + s_k·mask)) − og·p_k·sē_{k+1}
        gog += −p_k·ē_{k+1}

    (the ``u_{k−1}`` terms of the direct transpose are REINDEXED onto step
    ``k`` against the carried ``ē_{k+1}``/``sē_{k+1}``, so each reverse
    step reads exactly one history snapshot). Model-block chains:
    ``gc = gK·(2c/b)·dt²``, ``gb −= gK·K/b``, and for finite Q
    ``gg = −gog − ig²·gig``, ``gQ = −gg·g/Q``. Returns ``(gc, gb)`` or
    ``(gc, gb, gQ)``."""
    shape = c.shape
    dtype = c.dtype
    kappa = (c * c) / b
    K = kappa * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), dtype)
    with_q = qf is not None
    if with_q:
        import math

        g = (math.pi * f0 * dt) / qf
        ig = 1.0 / (1.0 + g)
        og = 1.0 - g
    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(1.0, dtype)
    if not iota_src:
        dense_mask = (
            jnp.zeros((size,), dtype).at[src_idx].set(1.0).reshape(shape)
        )

    def mask():
        return (_iota_src_mask(shape, src_idx, amp) if iota_src
                else dense_mask)

    enc, dec = _store_codec(store, dtype)
    zero = (src_idx * 0).astype(dtype)
    u0 = jnp.zeros(shape, dtype) + zero

    def fstep(carry, s_t):
        p_prev, p = carry
        lap = _div_b_grad(p, b, inv_dx2)
        if with_q:
            p_next = _mul_sponge(
                (2.0 * p - og * p_prev + K * (lap + s_t * mask())) * ig,
                sponge)
        else:
            p_next = _mul_sponge(
                2.0 * p - p_prev + K * (lap + s_t * mask()), sponge)
        return (p, p_next), enc(p)

    (_, _), (hist, scales) = lax.scan(fstep, (u0, u0), src_wavelet)

    def inject(row):
        return (jnp.zeros((size,), dtype).at[rcv_idx].add(row)
                .reshape(shape))

    dd = dd.astype(dtype)
    dd_shift = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], dtype), dd[:-1]], axis=0)

    def bstep(carry, xs):
        a_nxt, ebar_nxt, sbar_nxt, gK, gb, gig, gog = carry
        qh, s, grec_prev, s_t = xs
        p_k = dec(qh, s)
        sbar = _mul_sponge(a_nxt, sponge)
        ebar = ig * sbar if with_q else sbar
        lap_k = _div_b_grad(p_k, b, inv_dx2)
        src_k = lap_k + s_t * mask()
        gK = gK + src_k * ebar
        gb = gb + _div_b_grad_bbar(p_k, K * ebar, inv_dx2)
        if with_q:
            gig = gig + (sbar * (2.0 * p_k + K * src_k)
                         - og * (p_k * sbar_nxt))
            gog = gog - p_k * ebar_nxt
            a_k = (2.0 * ebar + _div_b_grad(K * ebar, b, inv_dx2)
                   - og * ebar_nxt) + inject(grec_prev)
        else:
            a_k = (2.0 * ebar + _div_b_grad(K * ebar, b, inv_dx2)
                   - ebar_nxt) + inject(grec_prev)
        return (a_k, ebar, sbar, gK, gb, gig, gog), None

    carry0 = (inject(dd[-1]),) + (u0,) * 6
    (_, _, _, gK, gb, gig, gog), _ = lax.scan(
        bstep, carry0, (hist, scales, dd_shift, src_wavelet), reverse=True)

    gc = gK * (2.0 * c / b) * jnp.asarray(dt * dt, dtype)
    gb = gb - gK * (K / b)
    if not with_q:
        return gc, gb
    gg = -gog - (ig * ig) * gig
    gQ = -gg * (g / qf)
    return gc, gb, gQ


def vd_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype=jnp.float32,
) -> Operator:
    """Two-parameter variable-density forward modeling
    ``F: (c, b) → traces`` — the JetPackWaveFD velocity+buoyancy physics.

    Domain: ``BlockSpace([grid, grid])`` holding the velocity ``c`` and
    buoyancy ``b = 1/ρ`` blocks (the reference family's multi-parameter
    FWI model is exactly a block vector, ``src/Jets.jl:736-760``); range:
    ``(nt, nrcv)`` traces. Tangent/adjoint are jvp/vjp through the
    rematerialized scan over the WHOLE block vector, so the adjoint
    returns the (δc, δb) gradient pair in one reverse pass.

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the adjoint
    to the hand-derived STORED-history sweep (:func:`_adjoint_stored_vd`):
    no rematerialization recompute, history at the encoded width."""
    from ..core.blockspace import BlockSpace

    grid_shape = tuple(int(s) for s in grid_shape)
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp, gsp])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)

    def _f(m, state):
        c = m.getblock(0).reshape(grid_shape)
        b = m.getblock(1).reshape(grid_shape)
        traces = _propagate_vd(
            c, b, state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, sponge=state["sponge"], remat_blocks=remat_blocks,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dm, m0, state):
        _, tangent = jax.jvp(lambda m: _f(m, state), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda m: _f(m, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            gc, gb = _adjoint_stored_vd(
                m0.getblock(0).reshape(grid_shape),
                m0.getblock(1).reshape(grid_shape), None, dd,
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, f0=0.0, sponge=state["sponge"],
                store=store_adjoint,
            )
            return dom.zeros().setblock(0, gc).setblock(1, gb)

    j = Jet(
        dom=dom, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


def vdq_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    f0: Optional[float] = None,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype=jnp.float32,
) -> Operator:
    """Full IsoDenQ physics ``F: (c, b, Q) → traces`` — velocity, buoyancy
    AND attenuation together, the parameterization of JetPackWaveFD's
    production ``Prop*AcoIsoDenQ`` propagators. Domain:
    ``BlockSpace([grid, grid, grid])``; the adjoint returns the
    (δc, δb, δQ) gradient triple in one reverse pass. With ``Q → ∞`` this
    reduces bit-exactly to :func:`vd_wave_propagator` (no damping factors
    enter the update).

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the adjoint
    to the hand-derived STORED-history sweep (:func:`_adjoint_stored_vd`
    with the Kosloff friction transposed in-register) — the exact
    production imaging path of the reference family's DenQ propagators:
    compressed stored wavefields, no recompute
    (``/root/reference/docs/src/index.md:17``)."""
    from ..core.blockspace import BlockSpace

    grid_shape = tuple(int(s) for s in grid_shape)
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp, gsp, gsp])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)
    f0v = float(freq if f0 is None else f0)

    def _f(m, state):
        import math

        c = m.getblock(0).reshape(grid_shape)
        b = m.getblock(1).reshape(grid_shape)
        q = m.getblock(2).reshape(grid_shape)
        g = (math.pi * f0v * dt) / q
        traces = _propagate_vd(
            c, b, state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, sponge=state["sponge"], remat_blocks=remat_blocks,
            g=g,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dm, m0, state):
        _, tangent = jax.jvp(lambda m: _f(m, state), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda m: _f(m, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            gc, gb, gQ = _adjoint_stored_vd(
                m0.getblock(0).reshape(grid_shape),
                m0.getblock(1).reshape(grid_shape),
                m0.getblock(2).reshape(grid_shape), dd,
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, f0=f0v, sponge=state["sponge"],
                store=store_adjoint,
            )
            return (dom.zeros().setblock(0, gc).setblock(1, gb)
                    .setblock(2, gQ))

    j = Jet(
        dom=dom, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


# ---------------------------------------------------------------------------
# Visco-acoustic Q attenuation — the "Q" of JetPackWaveFD's DenQ propagator
# family (2D/3D Aco{Iso,VTI,TTI}DenQ: every production propagator in the
# reference family carries both variable density AND attenuation). Kosloff
# constant-Q damping: a first-order friction term with spatially varying
# rate gamma(x) = pi f0 / Q(x),
#
#     u_tt + 2 gamma u_t = c^2 lap(u) + s
#
# discretized with the centered-in-time damping term so the scheme stays
# 2nd-order and the update stays ONE fused elementwise pass:
# u+ = (2u - (1-g) u- + c^2 dt^2 lap + s) / (1+g) with g = gamma dt
# computed in-register from the Q model block. Q -> inf (g -> 0) reduces
# bit-for-bit to the lossless leapfrog (pinned by the suite).
# ---------------------------------------------------------------------------


def _propagate_q(c, q, src_wavelet, src_idx, rcv_idx, *, dt, dx, f0, sponge,
                 order: int = 2, remat_blocks: int = 1, coeff_dtype=None):
    """Leapfrog with Kosloff constant-Q friction; returns (nt, nrcv).
    ``coeff_dtype=jnp.bfloat16`` rounds the friction field g = γ·dt to
    bf16 (straight-through rounding, as in the TTI coefficient mode)."""
    import math

    shape = c.shape
    c2dt2 = (c * c) * (dt * dt) / (dx * dx)
    g = (math.pi * f0 * dt) / q                  # gamma·dt, full-grid field
    if coeff_dtype is not None and jnp.dtype(coeff_dtype) == jnp.bfloat16:
        # straight-through bf16 rounding of g via reduce_precision (an
        # astype round-trip may be elided under excess precision — see
        # _propagate_tti3d)
        g16 = lax.reduce_precision(lax.stop_gradient(g), 8, 7)
        g = g + lax.stop_gradient(g16 - g)
    inv1pg = 1.0 / (1.0 + g)
    om1g = 1.0 - g

    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(dt * dt, c.dtype)
    if not iota_src:
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def step(carry, s_t):
        u_prev, u = carry
        lap = _laplacian(u, order=order)
        mask = _iota_src_mask(shape, src_idx, amp) if iota_src else src_mask
        u_next = _mul_sponge(
            (2.0 * u - om1g * u_prev + c2dt2 * lap) * inv1pg, sponge
        ) + s_t * mask
        rec = u_next.reshape(-1)[rcv_idx]
        return (u, u_next), rec

    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    (_, _), traces = _scan_remat(step, (u0, u0), src_wavelet, remat_blocks)
    return traces


def _adjoint_stored_q(c, qf, dd, src_wavelet, src_idx, rcv_idx, *, dt, dx,
                      f0, sponge, order: int = 2, store: str = "int8",
                      coeff_dtype=None):
    """Adjoint-state gradient ``(∂F/∂(c,Q))ᵀ dd`` for the Kosloff
    constant-Q physics with a STORED encoded history — the transpose of
    :func:`_propagate_q`'s friction recurrence, hand-derived: the friction
    is DIAGONAL, so the reverse recursion carries the same in-register
    ``og = 1−g`` / ``ig = 1/(1+g)`` factors (with ``C = c²dt²/dx²``,
    ``sē_k = S⊙a_{k+1}``, ``ē_k = ig⊙sē_k``):

        a_k  = Pᵀḡ + 2ē_k + L(C·ē_k) − og·ē_{k+1}
        gC  += L(u_k)⊙ē_k
        gig += sē_k·(2u_k + C·L(u_k)) − og·u_k·sē_{k+1}
        gog += −u_k·ē_{k+1}

    (``u_{k−1}`` terms reindexed against the carried ``ē/sē_{k+1}``), then
    ``gc = gC·2c·dt²/dx²``, ``gg = −gog − ig²·gig``, ``gQ = −gg·g/Q``.
    ``coeff_dtype=jnp.bfloat16`` applies the forward's straight-through
    g-rounding so the gradient matches the rounded primal. Returns
    ``(gc, gQ)``."""
    import math

    shape = c.shape
    dtype = c.dtype
    C = (c * c) * (dt * dt) / (dx * dx)
    g_raw = (math.pi * f0 * dt) / qf
    g = g_raw
    if (coeff_dtype is not None
            and jnp.dtype(coeff_dtype) == jnp.bfloat16):
        g = lax.reduce_precision(g_raw, 8, 7)
    ig = 1.0 / (1.0 + g)
    og = 1.0 - g
    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(dt * dt, dtype)
    if not iota_src:
        dense_mask = (
            jnp.zeros((size,), dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def mask():
        return (_iota_src_mask(shape, src_idx, amp) if iota_src
                else dense_mask)

    enc, dec = _store_codec(store, dtype)
    zero = (src_idx * 0).astype(dtype)
    u0 = jnp.zeros(shape, dtype) + zero

    def fstep(carry, s_t):
        u_prev, u = carry
        lap = _laplacian(u, order=order)
        u_next = _mul_sponge(
            (2.0 * u - og * u_prev + C * lap) * ig, sponge
        ) + s_t * mask()
        return (u, u_next), enc(u)

    (_, _), (hist, scales) = lax.scan(fstep, (u0, u0), src_wavelet)

    def inject(row):
        return (jnp.zeros((size,), dtype).at[rcv_idx].add(row)
                .reshape(shape))

    dd = dd.astype(dtype)
    dd_shift = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], dtype), dd[:-1]], axis=0)

    def bstep(carry, xs):
        a_nxt, ebar_nxt, sbar_nxt, gC, gig, gog = carry
        qh, s, grec_prev = xs
        u_k = dec(qh, s)
        sbar = _mul_sponge(a_nxt, sponge)
        ebar = ig * sbar
        lap_k = _laplacian(u_k, order=order)
        gC = gC + lap_k * ebar
        gig = gig + (sbar * (2.0 * u_k + C * lap_k)
                     - og * (u_k * sbar_nxt))
        gog = gog - u_k * ebar_nxt
        a_k = (2.0 * ebar + _laplacian(C * ebar, order=order)
               - og * ebar_nxt) + inject(grec_prev)
        return (a_k, ebar, sbar, gC, gig, gog), None

    carry0 = (inject(dd[-1]),) + (u0,) * 5
    (_, _, _, gC, gig, gog), _ = lax.scan(
        bstep, carry0, (hist, scales, dd_shift), reverse=True)

    gc = gC * (2.0 * c) * jnp.asarray((dt * dt) / (dx * dx), dtype)
    gg = -gog - (ig * ig) * gig
    gQ = -gg * (g_raw / qf)
    return gc, gQ


def q_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    f0: Optional[float] = None,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    coeff_dtype=None,
    store_adjoint: Optional[str] = None,
    dtype=jnp.float32,
) -> Operator:
    """Two-parameter visco-acoustic forward modeling ``F: (c, Q) → traces``
    — the attenuation physics of JetPackWaveFD's DenQ propagators.
    ``coeff_dtype=jnp.bfloat16`` rounds the friction field g = γ·dt to
    bf16 (straight-through: the primal uses the rounded field, tangents
    flow in full precision).

    Domain: ``BlockSpace([grid, grid])`` holding velocity ``c`` and the
    quality factor ``Q`` (dimensionless; smaller Q = stronger absorption;
    the reference family's multi-parameter model is a block vector,
    ``src/Jets.jl:736-760``). ``f0`` is the reference frequency at which Q
    is specified (defaults to the source ``freq``). Tangent/adjoint via
    jvp/vjp through the rematerialized scan — the adjoint returns the
    (δc, δQ) gradient pair, so Q-tomography FWI runs through the same
    solvers as velocity FWI. ``Q → ∞`` reduces exactly to
    :func:`wave_propagator` (pinned by the suite)."""
    from ..core.blockspace import BlockSpace

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    if coeff_dtype is not None and jnp.dtype(coeff_dtype) not in (
            jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)):
        raise ValueError("coeff_dtype must be float32 or bfloat16")
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp, gsp])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)
    f0 = float(freq if f0 is None else f0)

    def _f(m, state):
        c = m.getblock(0).reshape(grid_shape)
        q = m.getblock(1).reshape(grid_shape)
        traces = _propagate_q(
            c, q, state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, f0=f0, sponge=state["sponge"], order=space_order,
            remat_blocks=remat_blocks, coeff_dtype=coeff_dtype,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dm, m0, state):
        _, tangent = jax.jvp(lambda m: _f(m, state), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda m: _f(m, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            gc, gQ = _adjoint_stored_q(
                m0.getblock(0).reshape(grid_shape),
                m0.getblock(1).reshape(grid_shape), dd,
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, f0=f0, sponge=state["sponge"],
                order=space_order, store=store_adjoint,
                coeff_dtype=coeff_dtype,
            )
            return dom.zeros().setblock(0, gc).setblock(1, gQ)

    j = Jet(
        dom=dom, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


# ---------------------------------------------------------------------------
# Off-grid acquisition geometry — JetPackWaveFD's Kaiser-windowed-sinc
# source/receiver interpolation (Hicks 2002): the per-time-step receiver
# extraction is ONE static slab slice + small banded matmuls instead of a
# flat gather, and the fractional source is folded into the existing dense
# injection mask at construction time (zero extra step cost).
# ---------------------------------------------------------------------------


def _offgrid_src_mask(shape, src_pos, dt, radius, dtype):
    """Full-grid injection mask with the source's Kaiser-sinc stamp placed
    at its (static) fractional position — built once in numpy."""
    import numpy as np

    from .sampling import kaiser_sinc_matrix_np

    mask = np.zeros(tuple(shape), np.float64)
    rows = [
        kaiser_sinc_matrix_np(n, [float(p)], radius)[0]
        for n, p in zip(shape, src_pos)
    ]
    stamp = rows[0]
    for r in rows[1:]:
        stamp = np.multiply.outer(stamp, r)
    mask += stamp * (dt * dt)
    return jnp.asarray(mask, dtype)


def offgrid_wave_propagator(
    grid_shape: Sequence[int],
    *,
    src_pos: Sequence[float],
    rcv_depth: float,
    rcv_coords,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    sponge_width: int = 12,
    space_order: int = 2,
    radius: int = 4,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    dtype=jnp.float32,
) -> Operator:
    """Nonlinear forward modeling with OFF-GRID acquisition: the source at
    fractional position ``src_pos`` (ndim floats) and a receiver line/plane
    at fractional depth ``rcv_depth`` along axis 0 with fractional
    coordinates ``rcv_coords`` on the remaining axes (one array for 2-D, a
    tuple of per-axis arrays for a separable 3-D plane).

    In-loop extraction: ``u[iz0:iz0+2r]`` (static slice) contracted with the
    depth's 2r sinc taps, then one banded ``(nrcv, n_ax)`` matmul per
    remaining axis. Tangent/adjoint via jvp/vjp as for
    :func:`wave_propagator` (the adjoint's transposed matmul scatters the
    residual back through the same sinc stamps — Hicks interpolation is its
    own adjoint pair).

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the adjoint
    to the stored-history sweep with the OFF-GRID geometry threaded
    through: the fractional-source mask enters the forward history sweep
    and the reverse receiver injection is the derived transpose of the
    Kaiser-sinc extraction (``jax.vjp`` of the banded matmuls)."""
    from .sampling import kaiser_sinc_matrix, kaiser_sinc_matrix_np

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    nd = len(grid_shape)
    sp = Space(grid_shape, dtype)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    src_mask = _offgrid_src_mask(grid_shape, src_pos, dt, radius, dtype)

    # depth taps: static window [iz0, iz0+2r) clamped to the grid
    import numpy as np

    n0 = grid_shape[0]
    iz0 = int(np.floor(rcv_depth)) - radius + 1
    lo = max(iz0, 0)
    hi = min(iz0 + 2 * radius, n0)
    wz_full = kaiser_sinc_matrix_np(n0, [float(rcv_depth)], radius)[0]
    wz = jnp.asarray(wz_full[lo:hi].astype(np.dtype(dtype)))

    if nd == 2:
        rcv_axes = (np.asarray(rcv_coords, np.float64),)
    else:
        rcv_axes = tuple(np.asarray(c, np.float64) for c in rcv_coords)
    if len(rcv_axes) != nd - 1:
        raise ValueError("rcv_coords must cover every non-depth axis")
    Wr = tuple(
        kaiser_sinc_matrix(grid_shape[1 + k], rcv_axes[k], radius,
                           dtype=dtype)
        for k in range(nd - 1)
    )
    out_shape = tuple(int(W.shape[0]) for W in Wr)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec,) + out_shape, dtype)

    def _extract(u, st):
        # contract depth: (hi-lo, rest...) · (hi-lo,) -> (rest...)
        line = jnp.tensordot(st["wz"], u[lo:hi], axes=((0,), (0,)))
        for k, W in enumerate(st["Wr"]):
            line = _offgrid_axis_contract(W, line, k)
        return line

    def _f(c, state):
        traces = _propagate(
            c, state["wavelet"], jnp.int32(0), None,
            dt=dt, dx=dx, sponge=state["sponge"],
            remat_blocks=remat_blocks,
            order=space_order, src_mask=state["src_mask"],
            extract=lambda u: _extract(u, state),
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dc, m0, state):
        _, tangent = jax.jvp(lambda c: _f(c, state), (m0,), (dc,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda c: _f(c, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample, jnp.zeros((nt,) + out_shape, dtype))
                (dd,) = rvjp(dd)

            ex = lambda u: _extract(u, state)  # noqa: E731
            _, evjp = jax.vjp(ex, jnp.zeros(grid_shape, dtype))

            def inj(row):
                (g,) = evjp(row)
                return g

            return _adjoint_stored(
                m0, dd, state["wavelet"], jnp.int32(0), None,
                dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
                store=store_adjoint,
                src_mask=state["src_mask"], inject=inj,
            )

    j = Jet(
        dom=sp, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_mask": src_mask,
            "wz": wz,
            "Wr": Wr,
        },
    )
    return Operator(j)


def _offgrid_axis_contract(W, u, ax):
    v = jnp.tensordot(W, u, axes=((1,), (ax,)))
    return jnp.moveaxis(v, 0, ax)


# ---------------------------------------------------------------------------
# VTI anisotropy — JetPackWaveFD's pseudo-acoustic VTI physics (Duveneck/
# Alkhalifah coupled second-order system). Model = (c, epsilon, delta): a
# THREE-block vector domain. With epsilon = delta = 0 and matched initial/
# boundary conditions the p and q fields coincide and the system reduces
# exactly to the isotropic propagator (pinned by the test suite).
# ---------------------------------------------------------------------------


def _propagate_vti(c, eps, delta, src_wavelet, src_idx, rcv_idx, *, dt, dx,
                   sponge, order: int = 2, remat_blocks: int = 1,
                   og=None, ig=None, wavefield_sharding=None):
    """Coupled leapfrog for the pseudo-acoustic VTI system (axis 0 = z):

        p_tt = c² [(1+2ε) Lh(p) + √(1+2δ) ∂zz q] + s
        q_tt = c² [√(1+2δ) Lh(p) + ∂zz q] + s

    with ``Lh`` the horizontal Laplacian (all axes but 0). ``og``/``ig``
    carry static Kosloff constant-Q friction (the DenQ slot of the
    reference family's anisotropic propagators)."""
    shape = c.shape
    nd = c.ndim
    c2dt2 = (c * c) * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), c.dtype)
    ah = 1.0 + 2.0 * eps
    av = jnp.sqrt(1.0 + 2.0 * delta)

    size = 1
    for s in shape:
        size *= int(s)
    iota_src = c.ndim >= 3
    amp = jnp.asarray(dt * dt, c.dtype)
    if not iota_src:
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def _xla_update(p_prev, p, q_prev, q, c2, ah_, av_, s_t, mask):
        lh = _d2_axis(p, 1, inv_dx2, order)
        for ax in range(2, nd):
            lh = lh + _d2_axis(p, ax, inv_dx2, order)
        dzz = _d2_axis(q, 0, inv_dx2, order)
        if og is None:
            e_p = 2.0 * p - p_prev + c2 * (ah_ * lh + av_ * dzz)
            e_q = 2.0 * q - q_prev + c2 * (av_ * lh + dzz)
        else:
            e_p = (2.0 * p - og * p_prev + c2 * (ah_ * lh + av_ * dzz)) * ig
            e_q = (2.0 * q - og * q_prev + c2 * (av_ * lh + dzz)) * ig
        p_next = _mul_sponge(e_p, sponge) + s_t * mask
        q_next = _mul_sponge(e_q, sponge) + s_t * mask
        return p_next, q_next

    def step(carry, s_t):
        p_prev, p, q_prev, q = carry
        mask = _iota_src_mask(shape, src_idx, amp) if iota_src else src_mask
        p_next, q_next = _xla_update(p_prev, p, q_prev, q, c2dt2, ah, av,
                                     s_t, mask)
        rec = p_next.reshape(-1)[rcv_idx]
        return (p, p_next, q, q_next), rec

    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    if wavefield_sharding is not None:
        # pin the scan-carry sharding so GSPMD keeps BOTH coupled fields
        # grid-sharded through the whole loop (as in _propagate)
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)
    (_, _, _, _), traces = _scan_remat(
        step, (u0, u0, u0, u0), src_wavelet, remat_blocks)
    return traces


def _adjoint_stored_vti(c, eps, delta, dd, src_wavelet, src_idx, rcv_idx, *,
                        dt, dx, sponge, order: int = 2, store: str = "int8",
                        og=None, ig=None, wavefield_sharding=None):
    """Adjoint-state gradient ``(∂F/∂(c,ε,δ))ᵀ dd`` for the coupled
    pseudo-acoustic VTI system with a STORED (encoded) two-field forward
    history — the anisotropic sibling of :func:`_adjoint_stored`. The
    reverse sweep is the hand-derived transpose of the coupled leapfrog
    (``Lh``/``∂zz`` are self-adjoint under the zero boundary): with
    ``ēp = S⊙ap₊``, ``ēq = S⊙aq₊``,

        ap = Pᵀḡ + 2ēp + Lh(C·ah·ēp) + Lh(C·av·ēq) − ēp₊
        aq =      2ēq + ∂zz(C·av·ēp) + ∂zz(C·ēq)  − ēq₊
        gC  += (ah·Lh(p_k) + av·∂zz(q_k))⊙ēp + (av·Lh(p_k) + ∂zz(q_k))⊙ēq
        gah += C·Lh(p_k)⊙ēp
        gav += C·(∂zz(q_k)⊙ēp + Lh(p_k)⊙ēq)

    (p_k, q_k read back from the stored history; C = c²dt²,
    ah = 1+2ε, av = √(1+2δ); the model-block gradients follow by the
    outer chain gc = 2c·dt²·gC, gε = 2·gah, gδ = gav/av). No
    rematerialization recompute; the two-field history is stored at the
    encoded width. Returns the (gc, gε, gδ) triple."""
    shape = c.shape
    nd = c.ndim
    dtype = c.dtype
    C = (c * c) * (dt * dt)
    ah = 1.0 + 2.0 * eps
    av = jnp.sqrt(1.0 + 2.0 * delta)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), dtype)
    size = 1
    for s in shape:
        size *= int(s)
    iota_src = nd >= 3
    amp = jnp.asarray(dt * dt, dtype)
    if not iota_src:
        dense_mask = (
            jnp.zeros((size,), dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def mask():
        return (_iota_src_mask(shape, src_idx, amp) if iota_src
                else dense_mask)

    enc, dec = _store_codec(store, dtype)

    def Lh(u):
        out = _d2_axis(u, 1, inv_dx2, order)
        for ax in range(2, nd):
            out = out + _d2_axis(u, ax, inv_dx2, order)
        return out

    def Dz(u):
        return _d2_axis(u, 0, inv_dx2, order)

    zero = (src_idx * 0).astype(dtype)
    u0 = jnp.zeros(shape, dtype) + zero
    if wavefield_sharding is not None:
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)
    nt = int(src_wavelet.shape[0])

    # ---- forward history sweep (both fields encoded per step) ----------
    def fstep(carry, s_t):
        p_prev, p, q_prev, q = carry
        lh = Lh(p)
        dzz = Dz(q)
        if og is None:
            e_p = 2.0 * p - p_prev + C * (ah * lh + av * dzz)
            e_q = 2.0 * q - q_prev + C * (av * lh + dzz)
        else:
            e_p = (2.0 * p - og * p_prev + C * (ah * lh + av * dzz)) * ig
            e_q = (2.0 * q - og * q_prev + C * (av * lh + dzz)) * ig
        p_next = _mul_sponge(e_p, sponge) + s_t * mask()
        q_next = _mul_sponge(e_q, sponge) + s_t * mask()
        return (p, p_next, q, q_next), (enc(p), enc(q))

    (_, _, _, _), hists = lax.scan(fstep, (u0, u0, u0, u0), src_wavelet)
    (ph, ps), (qh, qs) = hists

    def inject(row):
        return (jnp.zeros((size,), dtype).at[rcv_idx].add(row)
                .reshape(shape))

    dd = dd.astype(dtype)
    dd_shift = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], dtype), dd[:-1]], axis=0)

    def bstep(carry, xs):
        ap1, aq1, ebp1, ebq1, gC, gah, gav = carry
        pq, psc, qq, qsc, grec_prev = xs
        p_k = dec(pq, psc)
        q_k = dec(qq, qsc)
        # static Q: the ig diagonal precedes every linear term (the whole
        # update is scaled by 1/(1+g)), and the leapfrog memory term
        # carries og = 1-g — the transposed recurrence picks up the SAME
        # in-register factors (Q itself is static, not differentiated)
        ebp = _mul_sponge(ap1, sponge)
        ebq = _mul_sponge(aq1, sponge)
        if og is not None:
            ebp = ebp * ig
            ebq = ebq * ig
        lh_k = Lh(p_k)
        dzz_k = Dz(q_k)
        gC = gC + ((ah * lh_k + av * dzz_k) * ebp
                   + (av * lh_k + dzz_k) * ebq)
        gah = gah + (C * lh_k) * ebp
        gav = gav + C * (dzz_k * ebp + lh_k * ebq)
        ebp1s = ebp1 if og is None else og * ebp1
        ebq1s = ebq1 if og is None else og * ebq1
        ap = (2.0 * ebp + Lh(C * ah * ebp) + Lh(C * av * ebq)
              - ebp1s) + inject(grec_prev)
        aq = (2.0 * ebq + Dz(C * av * ebp) + Dz(C * ebq)) - ebq1s
        return (ap, aq, ebp, ebq, gC, gah, gav), None

    carry0 = (inject(dd[-1]), u0, u0, u0, u0, u0, u0)
    (_, _, _, _, gC, gah, gav), _ = lax.scan(
        bstep, carry0, (ph, ps, qh, qs, dd_shift), reverse=True)
    gc = gC * (2.0 * c) * jnp.asarray(dt * dt, dtype)
    geps = 2.0 * gah
    gdelta = gav / av
    return gc, geps, gdelta


def vti_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    q=None,
    f0: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype=jnp.float32,
) -> Operator:
    """Three-parameter VTI anisotropic forward modeling
    ``F: (c, ε, δ) → traces`` — the JetPackWaveFD pseudo-acoustic VTI
    physics on a ``BlockSpace([grid, grid, grid])`` domain (vertical
    velocity + Thomsen parameters). Tangent/adjoint via jvp/vjp through the
    rematerialized coupled scan; the adjoint returns the (δc, δε, δδ)
    gradient triple in one reverse pass. With ``ε = δ = 0`` the system
    reduces exactly to :func:`wave_propagator`'s isotropic physics (the
    suite pins the reduction to roundoff).

    ``q=`` adds STATIC Kosloff constant-Q friction to both coupled fields
    (scalar or grid-shaped quality factor at reference frequency ``f0``,
    default the source ``freq``) — the attenuating "DenQ" variant of the
    reference family's VTI propagators. Static: Q is a modeling parameter,
    not part of the inversion domain (the jet still differentiates through
    (c, ε, δ)).

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} switches the
    adjoint from autodiff to the hand-derived STORED two-field-history
    sweep (:func:`_adjoint_stored_vti`) — the anisotropic production
    imaging path: no rematerialization recompute, history at the stored
    width. Composes with ``q=`` (the transposed recurrence carries the
    og/ig friction factors).

    ``wavefield_sharding`` (a ``NamedSharding``) grid-shards both coupled
    scan-carry fields and the stored two-field history over a mesh axis
    (the model-larger-than-one-device axis)."""
    import math

    from ..core.blockspace import BlockSpace

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    og = ig = None
    if q is not None:
        g = (math.pi * float(freq if f0 is None else f0) * dt) \
            / jnp.asarray(q, dtype)
        og = jnp.broadcast_to(1.0 - g, grid_shape).astype(dtype)
        ig = jnp.broadcast_to(1.0 / (1.0 + g), grid_shape).astype(dtype)
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp, gsp, gsp])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)

    def _f(m, state):
        traces = _propagate_vti(
            m.getblock(0), m.getblock(1), m.getblock(2),
            state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
            remat_blocks=remat_blocks, og=og, ig=ig,
            wavefield_sharding=wavefield_sharding,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dm, m0, state):
        _, tangent = jax.jvp(lambda m: _f(m, state), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda m: _f(m, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )
        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            gc, geps, gdelta = _adjoint_stored_vti(
                m0.getblock(0), m0.getblock(1), m0.getblock(2), dd,
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
                store=store_adjoint,
                og=og, ig=ig, wavefield_sharding=wavefield_sharding,
            )
            return (dom.zeros().setblock(0, gc).setblock(1, geps)
                    .setblock(2, gdelta))

    j = Jet(
        dom=dom, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


# ---------------------------------------------------------------------------
# TTI anisotropy — tilted transversely isotropic pseudo-acoustics (2-D):
# the VTI coupled system with its derivative operators rotated by the local
# tilt angle theta of the symmetry axis. Model = (c, epsilon, delta, theta):
# a FOUR-block domain. theta = 0 reduces exactly to the VTI propagator
# (pinned by the suite). The rotated operators
#     H = cos²θ ∂xx + sin²θ ∂zz − sin2θ ∂xz     (normal to symmetry axis)
#     V = sin²θ ∂xx + cos²θ ∂zz + sin2θ ∂xz     (along the symmetry axis)
# satisfy H + V = ∇² identically. Like all production pseudo-acoustic TTI
# schemes this is conditionally stable (requires ε ≥ δ and smooth θ).
# ---------------------------------------------------------------------------


def _dxz(u, inv_dx, order: int = 2):
    """Mixed second derivative ∂²/∂z∂x (2-D): composed central first
    derivatives (order 2/4/8), zero boundary."""
    return _d1_axis(_d1_axis(u, 0, inv_dx, order), 1, inv_dx, order)


def _propagate_tti(c, eps, delta, theta, src_wavelet, src_idx, rcv_idx, *,
                   dt, dx, sponge, order: int = 2, remat_blocks: int = 1,
                   og=None, ig=None):
    if c.ndim != 2:
        raise ValueError("tti propagator is 2-D (tilt in the x-z plane)")
    shape = c.shape
    c2dt2 = (c * c) * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), c.dtype)
    inv_dx = jnp.asarray(1.0 / dx, c.dtype)
    ah = 1.0 + 2.0 * eps
    av = jnp.sqrt(1.0 + 2.0 * delta)
    ct2 = jnp.cos(theta) ** 2
    st2 = jnp.sin(theta) ** 2
    s2t = jnp.sin(2.0 * theta)

    size = int(shape[0]) * int(shape[1])
    src_mask = (
        jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt).reshape(shape)
    )

    def step(carry, s_t):
        p_prev, p, q_prev, q = carry
        # rotated operators on each field
        pxx = _d2_axis(p, 1, inv_dx2, order)
        pzz = _d2_axis(p, 0, inv_dx2, order)
        pxz = _dxz(p, inv_dx, order)
        qxx = _d2_axis(q, 1, inv_dx2, order)
        qzz = _d2_axis(q, 0, inv_dx2, order)
        qxz = _dxz(q, inv_dx, order)
        Hp = ct2 * pxx + st2 * pzz - s2t * pxz
        Vq = st2 * qxx + ct2 * qzz + s2t * qxz
        if og is None:
            e_p = 2.0 * p - p_prev + c2dt2 * (ah * Hp + av * Vq)
            e_q = 2.0 * q - q_prev + c2dt2 * (av * Hp + Vq)
        else:
            e_p = (2.0 * p - og * p_prev
                   + c2dt2 * (ah * Hp + av * Vq)) * ig
            e_q = (2.0 * q - og * q_prev + c2dt2 * (av * Hp + Vq)) * ig
        p_next = e_p * sponge + s_t * src_mask
        q_next = e_q * sponge + s_t * src_mask
        rec = p_next.reshape(-1)[rcv_idx]
        return (p, p_next, q, q_next), rec

    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    (_, _, _, _), traces = _scan_remat(
        step, (u0, u0, u0, u0), src_wavelet, remat_blocks)
    return traces


def _propagate_tti3d(c, eps, delta, theta, phi, src_wavelet, src_idx,
                     rcv_idx, *, dt, dx, sponge, order: int = 2,
                     remat_blocks: int = 1, og=None, ig=None,
                     coeff_dtype=None, wavefield_sharding=None):
    """3-D tilted-TI pseudo-acoustics with azimuth. The symmetry axis is
    the unit vector ``n = (cosθ, sinθ·cosφ, sinθ·sinφ)`` in (z, y, x); the
    rotated vertical operator is the directional second derivative

        V(u) = Σᵢ nᵢ² ∂ᵢᵢu + Σ_{i<j} 2nᵢnⱼ ∂ᵢⱼu

    and the rotated horizontal operator ``H = ∇² − V`` is expanded with
    explicit ``(1 − nᵢ²)`` / ``−2nᵢnⱼ`` coefficients so that at
    ``θ = 0`` every multiplier is exactly 0 or 1 and the scheme reduces
    to the 3-D VTI propagator to FMA-grouping noise (pinned at rtol 1e-12
    by the suite, like the 2-D tilt pin) — JetPackWaveFD's 3-D
    ``Prop3DAcoTTIDenQ`` parameterization.

    ``coeff_dtype=jnp.bfloat16`` rounds the five smooth coefficient fields
    (1+2ε, √(1+2δ), and the symmetry-axis components) to bf16 values:
    ~0.4% relative rounding on the anisotropy coefficients (θ=0 stays
    EXACT: bf16 represents 0 and 1 exactly, so the VTI reduction pin
    holds)."""
    shape = c.shape
    c2dt2 = (c * c) * (dt * dt)
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), c.dtype)
    inv_dx = jnp.asarray(1.0 / dx, c.dtype)
    ah = 1.0 + 2.0 * eps
    av = jnp.sqrt(1.0 + 2.0 * delta)
    nz = jnp.cos(theta)
    st = jnp.sin(theta)
    ny = st * jnp.cos(phi)
    nx = st * jnp.sin(phi)
    if coeff_dtype is not None and jnp.dtype(coeff_dtype) == jnp.bfloat16:
        # Straight-through rounding: the PRIMAL uses the bf16-rounded
        # coefficients, but tangents flow in full f32 — differentiating
        # through the rounding cast itself would truncate tangents/
        # cotangents to bf16 and break the dot-product gate at ~1e-3. The
        # rounding is lax.reduce_precision (bf16 = 8 exponent / 7 mantissa
        # bits), NOT an astype round-trip: XLA under
        # --xla_allow_excess_precision (on by default, the GPU backend
        # included) may elide f32→bf16→f32 convert pairs and silently
        # leave the coefficients unrounded.
        def _r16(x):
            return lax.reduce_precision(lax.stop_gradient(x), 8, 7)

        def _st(x):
            return x + lax.stop_gradient(_r16(x) - x)

        ah, av, nz, ny, nx = (_st(x) for x in (ah, av, nz, ny, nx))
    czz, cyy, cxx = nz * nz, ny * ny, nx * nx
    czy, czx, cyx = 2.0 * nz * ny, 2.0 * nz * nx, 2.0 * ny * nx

    iota_src = c.ndim >= 3
    amp = jnp.asarray(dt * dt, c.dtype)
    if not iota_src:
        size = 1
        for s in shape:
            size *= int(s)
        src_mask = (
            jnp.zeros((size,), c.dtype).at[src_idx].set(dt * dt)
            .reshape(shape)
        )

    def _dij(u, i, j):
        return _d1_axis(_d1_axis(u, i, inv_dx, order), j, inv_dx, order)

    def _HV(u):
        uzz = _d2_axis(u, 0, inv_dx2, order)
        uyy = _d2_axis(u, 1, inv_dx2, order)
        uxx = _d2_axis(u, 2, inv_dx2, order)
        uzy = _dij(u, 0, 1)
        uzx = _dij(u, 0, 2)
        uyx = _dij(u, 1, 2)
        V = (czz * uzz + cyy * uyy + cxx * uxx
             + czy * uzy + czx * uzx + cyx * uyx)
        H = ((1.0 - czz) * uzz + (1.0 - cyy) * uyy + (1.0 - cxx) * uxx
             - czy * uzy - czx * uzx - cyx * uyx)
        return H, V

    def step(carry, s_t):
        p_prev, p, q_prev, q = carry
        mask = _iota_src_mask(shape, src_idx, amp) if iota_src else src_mask
        Hp, _ = _HV(p)
        _, Vq = _HV(q)
        if og is None:
            e_p = 2.0 * p - p_prev + c2dt2 * (ah * Hp + av * Vq)
            e_q = 2.0 * q - q_prev + c2dt2 * (av * Hp + Vq)
        else:
            e_p = (2.0 * p - og * p_prev
                   + c2dt2 * (ah * Hp + av * Vq)) * ig
            e_q = (2.0 * q - og * q_prev + c2dt2 * (av * Hp + Vq)) * ig
        p_next = _mul_sponge(e_p, sponge) + s_t * mask
        q_next = _mul_sponge(e_q, sponge) + s_t * mask
        rec = p_next.reshape(-1)[rcv_idx]
        return (p, p_next, q, q_next), rec

    zero = (src_idx * 0).astype(c.dtype)
    u0 = jnp.zeros(shape, c.dtype) + zero
    if wavefield_sharding is not None:
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)
    (_, _, _, _), traces = _scan_remat(
        step, (u0, u0, u0, u0), src_wavelet, remat_blocks)
    return traces


def _adjoint_stored_tti3d(c, eps, delta, theta, phi, dd, src_wavelet,
                          src_idx, rcv_idx, *, dt, dx, sponge,
                          order: int = 2, store: str = "int8",
                          coeff_dtype=None, og=None, ig=None,
                          wavefield_sharding=None):
    """Adjoint-state gradient ``(∂F/∂(c,ε,δ,θ,φ))ᵀ dd`` for the 3-D
    tilted-TI system with a STORED two-field history — the TTI sibling of
    :func:`_adjoint_stored_vti`. Every rotated derivative (∂ᵢᵢ and the
    composed-first-difference ∂ᵢⱼ) is self-adjoint under the zero
    boundary, so the reverse sweep transposes term by term:

        ap = Pᵀḡ + 2ēp + Hᵀ(C·ah·ēp + C·av·ēq) − ēp₊
        aq =      2ēq + Vᵀ(C·av·ēp + C·ēq)     − ēq₊

    (Hᵀ/Vᵀ are LINEAR, so each applies ONCE on the summed weight field
    — the reverse is compute-bound and the transposed operators are its
    hot arithmetic)

    with ``Hᵀ(w) = Σ_d D_d(κ_d·w)`` (coefficients move inside). The six
    direction-coefficient gradients fold immediately into the THREE
    axis-component accumulators (per derivative label d:
    ``δc_d = C·[(av·q_d − ah·p_d)ēp + (q_d − av·p_d)ēq]``), then chain
    through n = (cosθ, sinθcosφ, sinθsinφ) to (gθ, gφ).

    ``coeff_dtype=jnp.bfloat16`` applies the SAME straight-through
    coefficient rounding as the forward (gradients consistent with the
    rounded primal). Returns (gc, gε, gδ, gθ, gφ)."""
    shape = c.shape
    dtype = c.dtype
    C = (c * c) * (dt * dt)
    ah = 1.0 + 2.0 * eps
    av = jnp.sqrt(1.0 + 2.0 * delta)
    nz = jnp.cos(theta)
    st = jnp.sin(theta)
    ny = st * jnp.cos(phi)
    nx = st * jnp.sin(phi)
    av_raw = av  # the δ chain differentiates the UNROUNDED √(1+2δ)
    if coeff_dtype is not None and jnp.dtype(coeff_dtype) == jnp.bfloat16:
        def _r16(x):
            return lax.reduce_precision(lax.stop_gradient(x), 8, 7)

        def _st16(x):
            return x + lax.stop_gradient(_r16(x) - x)

        ah, av, nz, ny, nx = (_st16(x) for x in (ah, av, nz, ny, nx))
    czz, cyy, cxx = nz * nz, ny * ny, nx * nx
    czy, czx, cyx = 2.0 * nz * ny, 2.0 * nz * nx, 2.0 * ny * nx
    inv_dx2 = jnp.asarray(1.0 / (dx * dx), dtype)
    inv_dx = jnp.asarray(1.0 / dx, dtype)
    size = 1
    for s in shape:
        size *= int(s)
    amp = jnp.asarray(dt * dt, dtype)

    enc, dec = _store_codec(store, dtype)

    def _dij(u, i, j):
        return _d1_axis(_d1_axis(u, i, inv_dx, order), j, inv_dx, order)

    def derivs(u):
        return (_d2_axis(u, 0, inv_dx2, order),
                _d2_axis(u, 1, inv_dx2, order),
                _d2_axis(u, 2, inv_dx2, order),
                _dij(u, 0, 1), _dij(u, 0, 2), _dij(u, 1, 2))

    def H_of(d6):
        uzz, uyy, uxx, uzy, uzx, uyx = d6
        return ((1.0 - czz) * uzz + (1.0 - cyy) * uyy + (1.0 - cxx) * uxx
                - czy * uzy - czx * uzx - cyx * uyx)

    def V_of(d6):
        uzz, uyy, uxx, uzy, uzx, uyx = d6
        return (czz * uzz + cyy * uyy + cxx * uxx
                + czy * uzy + czx * uzx + cyx * uyx)

    def HT(w):
        return (_d2_axis((1.0 - czz) * w, 0, inv_dx2, order)
                + _d2_axis((1.0 - cyy) * w, 1, inv_dx2, order)
                + _d2_axis((1.0 - cxx) * w, 2, inv_dx2, order)
                - _dij(czy * w, 0, 1) - _dij(czx * w, 0, 2)
                - _dij(cyx * w, 1, 2))

    def VT(w):
        return (_d2_axis(czz * w, 0, inv_dx2, order)
                + _d2_axis(cyy * w, 1, inv_dx2, order)
                + _d2_axis(cxx * w, 2, inv_dx2, order)
                + _dij(czy * w, 0, 1) + _dij(czx * w, 0, 2)
                + _dij(cyx * w, 1, 2))

    zero = (src_idx * 0).astype(dtype)
    u0 = jnp.zeros(shape, dtype) + zero
    nt = int(src_wavelet.shape[0])

    if wavefield_sharding is not None:
        u0 = lax.with_sharding_constraint(u0, wavefield_sharding)

    # ---- forward history sweep (the TTI stored adjoint is 3-D, so the
    # source is always the in-register iota mask) -----------------------
    mask = _iota_src_mask(shape, src_idx, amp)

    def fstep(carry, s_t):
        p_prev, p, q_prev, q = carry
        dp6 = derivs(p)
        dq6 = derivs(q)
        if og is None:
            e_p = 2.0 * p - p_prev + C * (ah * H_of(dp6) + av * V_of(dq6))
            e_q = 2.0 * q - q_prev + C * (av * H_of(dp6) + V_of(dq6))
        else:
            e_p = (2.0 * p - og * p_prev
                   + C * (ah * H_of(dp6) + av * V_of(dq6))) * ig
            e_q = (2.0 * q - og * q_prev
                   + C * (av * H_of(dp6) + V_of(dq6))) * ig
        p_next = _mul_sponge(e_p, sponge) + s_t * mask
        q_next = _mul_sponge(e_q, sponge) + s_t * mask
        return (p, p_next, q, q_next), (enc(p), enc(q))

    (_, _, _, _), hists = lax.scan(fstep, (u0, u0, u0, u0), src_wavelet)
    (ph, ps), (qh, qs) = hists

    def inject(row):
        return (jnp.zeros((size,), dtype).at[rcv_idx].add(row)
                .reshape(shape))

    dd = dd.astype(dtype)
    dd_shift = jnp.concatenate(
        [jnp.zeros((1,) + dd.shape[1:], dtype), dd[:-1]], axis=0)

    def bstep(carry, xs):
        ap1, aq1, ebp1, ebq1, gC, gah, gav, gnz, gny, gnx = carry
        pq, psc, qq, qsc, grec_prev = xs
        p_k = dec(pq, psc)
        q_k = dec(qq, qsc)
        ebp = _mul_sponge(ap1, sponge)
        ebq = _mul_sponge(aq1, sponge)
        if og is not None:
            # static Q: ig precedes every linear term; the leapfrog memory
            # term carries og (Q static, not differentiated)
            ebp = ebp * ig
            ebq = ebq * ig
        dp6 = derivs(p_k)
        dq6 = derivs(q_k)
        Hp = H_of(dp6)
        Vq = V_of(dq6)
        gC = gC + ((ah * Hp + av * Vq) * ebp + (av * Hp + Vq) * ebq)
        gah = gah + (C * Hp) * ebp
        gav = gav + C * (Vq * ebp + Hp * ebq)
        # six per-derivative coefficient contributions, folded straight
        # into the three axis-component accumulators
        dz_c = []
        for p_d, q_d in zip(dp6, dq6):
            dz_c.append(C * ((av * q_d - ah * p_d) * ebp
                             + (q_d - av * p_d) * ebq))
        dczz, dcyy, dcxx, dczy, dczx, dcyx = dz_c
        gnz = gnz + (2.0 * nz * dczz + 2.0 * ny * dczy + 2.0 * nx * dczx)
        gny = gny + (2.0 * ny * dcyy + 2.0 * nz * dczy + 2.0 * nx * dcyx)
        gnx = gnx + (2.0 * nx * dcxx + 2.0 * nz * dczx + 2.0 * ny * dcyx)
        ebp1s = ebp1 if og is None else og * ebp1
        ebq1s = ebq1 if og is None else og * ebq1
        # HT/VT are linear: one application on the summed weight field
        # instead of two (the transposed operators are where the reverse
        # step's arithmetic lives)
        ap = (2.0 * ebp + HT(C * ah * ebp + C * av * ebq)
              - ebp1s) + inject(grec_prev)
        aq = (2.0 * ebq + VT(C * av * ebp + C * ebq)) - ebq1s
        return (ap, aq, ebp, ebq, gC, gah, gav, gnz, gny, gnx), None

    carry0 = (inject(dd[-1]),) + (u0,) * 9
    (_, _, _, _, gC, gah, gav, gnz, gny, gnx), _ = lax.scan(
        bstep, carry0, (ph, ps, qh, qs, dd_shift), reverse=True)

    gc = gC * (2.0 * c) * jnp.asarray(dt * dt, dtype)
    geps = 2.0 * gah
    gdelta = gav / av_raw   # straight-through: d√(1+2δ)/dδ at unrounded δ
    # n = (cosθ, sinθ·cosφ, sinθ·sinφ)
    cth, sth = jnp.cos(theta), jnp.sin(theta)
    cph, sph = jnp.cos(phi), jnp.sin(phi)
    gtheta = -sth * gnz + (cth * cph) * gny + (cth * sph) * gnx
    gphi = (-sth * sph) * gny + (sth * cph) * gnx
    return gc, geps, gdelta, gtheta, gphi


def tti_wave_propagator(
    grid_shape: Sequence[int],
    *,
    nt: int = 256,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    src_idx: int = 0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    q=None,
    f0: Optional[float] = None,
    coeff_dtype=None,
    store_adjoint: Optional[str] = None,
    wavefield_sharding=None,
    dtype=jnp.float32,
) -> Operator:
    """TTI anisotropic forward modeling — JetPackWaveFD's tilted-TI physics.

    ``store_adjoint`` ∈ {None, "f32", "bf16", "int8"} (3-D only) switches
    the adjoint from autodiff to the hand-derived STORED two-field-history
    sweep (:func:`_adjoint_stored_tti3d`): no rematerialization recompute,
    history at the encoded width, full (gc, gε, gδ, gθ, gφ) tuple in one
    reverse pass.

    2-D: four-parameter ``F: (c, ε, δ, θ) → traces`` (tilt θ in the x-z
    plane). 3-D: five-parameter ``F: (c, ε, δ, θ, φ) → traces`` with
    azimuth φ (the symmetry axis ``n = (cosθ, sinθcosφ, sinθsinφ)`` —
    the reference family's ``Prop3DAcoTTIDenQ`` parameter set). Domain:
    ``BlockSpace([grid] * nparams)`` (vertical velocity, Thomsen ε/δ, tilt,
    and azimuth in 3-D; angles in radians). ``θ = 0`` reduces exactly to
    :func:`vti_wave_propagator` in BOTH dimensions (pinned). Conditionally
    stable like all pseudo-acoustic TTI schemes: keep ``ε ≥ δ`` and the
    angle fields smooth.

    ``q=`` adds STATIC Kosloff constant-Q friction to both coupled fields
    (scalar or grid-shaped; reference frequency ``f0`` defaults to the
    source ``freq``) — completing the parameter set of the reference
    family's ``Prop*AcoTTIDenQ`` production propagators.

    ``coeff_dtype=jnp.bfloat16`` (3-D only) rounds the five smooth
    coefficient fields to bf16 values in the forward and the stored
    adjoint (see :func:`_propagate_tti3d`; ~0.4% coefficient rounding,
    θ=0 reduction stays exact).

    ``store_adjoint`` composes with ``q=`` (og/ig factors in the
    transposed recurrence). ``wavefield_sharding`` grid-shards the coupled
    fields and stored history over a mesh axis (3-D only)."""
    import math

    from ..core.blockspace import BlockSpace

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    if len(grid_shape) not in (2, 3):
        raise ValueError("tti_wave_propagator supports 2-D and 3-D grids")
    three_d = len(grid_shape) == 3
    if coeff_dtype is not None:
        if jnp.dtype(coeff_dtype) not in (jnp.dtype(jnp.float32),
                                          jnp.dtype(jnp.bfloat16)):
            raise ValueError("coeff_dtype must be float32 or bfloat16")
        if not three_d and jnp.dtype(coeff_dtype) == jnp.bfloat16:
            raise ValueError("bf16 coefficient mode is 3-D only")
    if wavefield_sharding is not None and len(grid_shape) != 3:
        raise ValueError("wavefield_sharding on TTI is 3-D only")
    og = ig = None
    if q is not None:
        g = (math.pi * float(freq if f0 is None else f0) * dt) \
            / jnp.asarray(q, dtype)
        og = jnp.broadcast_to(1.0 - g, grid_shape).astype(dtype)
        ig = jnp.broadcast_to(1.0 / (1.0 + g), grid_shape).astype(dtype)
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp] * (5 if three_d else 4))
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)
    rng = Space((ntrec, int(rcv_idx.shape[0])), dtype)

    def _f(m, state):
        if three_d:
            traces = _propagate_tti3d(
                m.getblock(0), m.getblock(1), m.getblock(2), m.getblock(3),
                m.getblock(4),
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
                remat_blocks=remat_blocks, og=og, ig=ig,
                coeff_dtype=coeff_dtype,
                wavefield_sharding=wavefield_sharding,
            )
            return _resample(traces) if _resample is not None else traces
        traces = _propagate_tti(
            m.getblock(0), m.getblock(1), m.getblock(2), m.getblock(3),
            state["wavelet"], state["src_idx"], state["rcv_idx"],
            dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
            remat_blocks=remat_blocks, og=og, ig=ig,
        )
        return _resample(traces) if _resample is not None else traces

    def _df(dm, m0, state):
        _, tangent = jax.jvp(lambda m: _f(m, state), (m0,), (dm,))
        return tangent

    if store_adjoint is None:
        def _dft(dd, m0, state):
            _, vjp = jax.vjp(lambda m: _f(m, state), m0)
            (out,) = vjp(dd)
            return out
    else:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )
        if not three_d:
            raise ValueError(
                "store_adjoint on the TTI propagator is 3-D only (the "
                "2-D tilt path keeps the autodiff adjoint)"
            )
        def _dft(dd, m0, state):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (dd,) = rvjp(dd)
            g5 = _adjoint_stored_tti3d(
                m0.getblock(0), m0.getblock(1), m0.getblock(2),
                m0.getblock(3), m0.getblock(4), dd,
                state["wavelet"], state["src_idx"], state["rcv_idx"],
                dt=dt, dx=dx, sponge=state["sponge"], order=space_order,
                store=store_adjoint,
                coeff_dtype=coeff_dtype, og=og, ig=ig,
                wavefield_sharding=wavefield_sharding,
            )
            out = dom.zeros()
            for b, g in enumerate(g5):
                out = out.setblock(b, g)
            return out

    j = Jet(
        dom=dom, rng=rng, f=_f, df=_df, dft=_dft,
        state={
            "wavelet": wavelet,
            "sponge": sponge,
            "src_idx": jnp.asarray(src_idx, jnp.int32),
            "rcv_idx": rcv_idx,
        },
    )
    return Operator(j)


def multishot_vti_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype=jnp.float32,
) -> Operator:
    """Multi-shot VTI modeling ``F: (c, ε, δ) -> (nshots, nt, nrcv)`` —
    anisotropic physics through the SAME stacked/sharded block machinery as
    the isotropic multishot (the model, a ``BlockVector``, is just another
    pytree: it replicates across the mesh with spec ``P()`` and the derived
    adjoint psum returns the (δc, δε, δδ) triple)."""
    from ..core.blockspace import BlockSpace
    from ..parallel.sharded import stacked_block_operator

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp, gsp, gsp])
    src_indices = jnp.asarray(src_indices, jnp.int32)
    nshots = int(src_indices.shape[0])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)

    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)

    def shot_f(m, bs):
        traces = _propagate_vti(
            m.getblock(0), m.getblock(1), m.getblock(2),
            bs["wavelet"], bs["src"], bs["rcv"],
            dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
            remat_blocks=remat_blocks,
        )
        return _resample(traces) if _resample is not None else traces

    def shot_df(dm, m0, bs):
        _, tangent = jax.jvp(lambda m: shot_f(m, bs), (m0,), (dm,))
        return tangent

    shot_dft = None
    if store_adjoint is not None:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )

        def shot_dft(d_b, m0, bs):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (d_b,) = rvjp(d_b)
            g3 = _adjoint_stored_vti(
                m0.getblock(0), m0.getblock(1), m0.getblock(2), d_b,
                bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
                store=store_adjoint,
            )
            out = dom.zeros()
            for b, g in enumerate(g3):
                out = out.setblock(b, g)
            return out

    return stacked_block_operator(
        nblocks=nshots,
        dom=dom,
        rng_block=Space((ntrec, int(rcv_idx.shape[0])), dtype),
        bstate={"src": src_indices},
        sstate={"wavelet": wavelet, "sponge": sponge, "rcv": rcv_idx},
        f=shot_f,
        df=shot_df,
        dft=shot_dft,
        mesh=mesh,
        axis=axis,
        shot_map=shot_map,
    )


def multishot_tti_wave_operator(
    grid_shape: Sequence[int],
    src_indices,
    *,
    nt: int = 128,
    dt: float = 0.001,
    dx: float = 10.0,
    freq: float = 15.0,
    rcv_idx=None,
    sponge_width: int = 12,
    space_order: int = 2,
    remat_blocks: int = 1,
    dtrec: Optional[float] = None,
    store_adjoint: Optional[str] = None,
    mesh=None,
    axis: str = "block",
    shot_map: str = "vmap",
    dtype=jnp.float32,
) -> Operator:
    """Multi-shot TTI modeling — tilted-TI physics through the stacked/
    sharded block machinery (the sharded sibling of
    :func:`tti_wave_propagator`, exactly as :func:`multishot_vti_wave_operator`
    is to VTI). Domain: ``BlockSpace([grid]*4)`` in 2-D (c, ε, δ, θ) or
    ``BlockSpace([grid]*5)`` in 3-D (adds azimuth φ); range
    ``(nshots, ntrec, nrcv)``. The BlockVector model replicates across the
    mesh; the derived psum adjoint returns the full parameter-gradient
    tuple (incl. tilt/azimuth) summed over shots."""
    from ..core.blockspace import BlockSpace
    from ..parallel.sharded import stacked_block_operator

    grid_shape = tuple(int(s) for s in grid_shape)
    space_order = _check_space_order(space_order)
    if len(grid_shape) not in (2, 3):
        raise ValueError("multishot_tti_wave_operator supports 2-D and 3-D")
    three_d = len(grid_shape) == 3
    gsp = Space(grid_shape, dtype)
    dom = BlockSpace([gsp] * (5 if three_d else 4))
    src_indices = jnp.asarray(src_indices, jnp.int32)
    nshots = int(src_indices.shape[0])
    if rcv_idx is None:
        n = gsp.size
        rcv_idx = jnp.arange(0, n, max(1, n // 128))[:128]
    rcv_idx = jnp.asarray(rcv_idx, jnp.int32)
    wavelet = _ricker(nt, dt, freq, dtype)
    sponge = _make_sponge(grid_shape, sponge_width, dtype=dtype)
    ntrec, _resample = _trace_resampler(nt, dt, dtrec, dtype)

    def shot_f(m, bs):
        if three_d:
            traces = _propagate_tti3d(
                m.getblock(0), m.getblock(1), m.getblock(2), m.getblock(3),
                m.getblock(4), bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
                remat_blocks=remat_blocks,
            )
        else:
            traces = _propagate_tti(
                m.getblock(0), m.getblock(1), m.getblock(2), m.getblock(3),
                bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
                remat_blocks=remat_blocks,
            )
        return _resample(traces) if _resample is not None else traces

    def shot_df(dm, m0, bs):
        _, tangent = jax.jvp(lambda m: shot_f(m, bs), (m0,), (dm,))
        return tangent

    shot_dft = None
    if store_adjoint is not None:
        if store_adjoint not in ("f32", "bf16", "int8"):
            raise ValueError(
                "store_adjoint must be one of (None, 'f32', 'bf16', "
                f"'int8'), got {store_adjoint!r}"
            )
        if not three_d:
            raise ValueError(
                "store_adjoint on the TTI multishot is 3-D only"
            )

        def shot_dft(d_b, m0, bs):
            if _resample is not None:
                _, rvjp = jax.vjp(
                    _resample,
                    jnp.zeros((nt, int(rcv_idx.shape[0])), dtype))
                (d_b,) = rvjp(d_b)
            g5 = _adjoint_stored_tti3d(
                m0.getblock(0), m0.getblock(1), m0.getblock(2),
                m0.getblock(3), m0.getblock(4), d_b,
                bs["wavelet"], bs["src"], bs["rcv"],
                dt=dt, dx=dx, sponge=bs["sponge"], order=space_order,
                store=store_adjoint,
            )
            out = dom.zeros()
            for b, g in enumerate(g5):
                out = out.setblock(b, g)
            return out

    return stacked_block_operator(
        nblocks=nshots,
        dom=dom,
        rng_block=Space((ntrec, int(rcv_idx.shape[0])), dtype),
        bstate={"src": src_indices},
        sstate={"wavelet": wavelet, "sponge": sponge, "rcv": rcv_idx},
        f=shot_f,
        df=shot_df,
        dft=shot_dft,
        mesh=mesh,
        axis=axis,
        shot_map=shot_map,
    )
