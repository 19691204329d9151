"""Flagship model: multi-shot linearized seismic-style inversion.

BASELINE configs #4/#5: a tall block-column operator over shot gathers —
the exact structure DistributedJets.jl distributes over workers (block rows
= shots; SURVEY §2 ledger).

Per-shot physics (linearized Born-style modeling, kept linear):

    d_b = R_b [ w_b ⊙ (L m) ] = w_b[rcv_b] * (L m)[rcv_b]

Architecture:

* per-shot weights live **at receiver points only** (``wr``, (nshots,
  nrecv)) — the full per-shot weight grids never exist, so per-shot work is
  O(nrecv), not O(grid);
* receivers form a **regular interior subgrid** (constant-spacing
  acquisition), sampled by per-axis ``take``s, major axis first, where the
  one big gather moves whole contiguous minor-axis rows instead of single
  elements;
* the default ``impl="fused"`` goes further: the forward samples the
  Laplacian *stencil taps directly* on a 3-block-per-axis gathered
  sub-array (``_make_sampled_stencil_df``) — grid traffic is ~3·c0 rows
  read, no dense sweep at all; the adjoint deposits per-axis then runs ONE
  dense Laplacian sweep, whose elementwise tail XLA can fuse into the
  solver's following axpy/norm (a scatter tail would not fuse);
* shots shard over the mesh ``"block"`` axis; the model is replicated; the
  adjoint accumulation is a single ``psum`` of the (nrecv,) receiver sums
  over the mesh, lifted into the model grid once, after it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..core.algebra import compose
from ..core.jet import Operator
from ..core.spaces import Space
from ..ops.stencil import laplacian_operator
from ..parallel.sharded import stacked_block_operator

__all__ = ["make_seismic_operator", "make_seismic_problem"]


def _sample_df(u, m0, bs):
    """Per-shot forward: gather the shared wavefield at the FIXED receiver
    array (the gather is block-invariant, so vmap computes it once), weight
    by the per-shot receiver-point illumination."""
    return jnp.ravel(u)[bs["rcv"]] * bs["wr"]


def _reduce_shots(dd, m0, bs):
    """Whole-stack adjoint, first half: the weighted residuals reduced over
    the local shots, (nshots, nrecv) → (nrecv,) — the block-accumulation
    loop of the reference (src/Jets.jl:1034-1057) as one reduction. The
    cross-shard ``psum`` acts on this receiver-sized array; the lift into
    the model grid (a ``dft_tail``) runs once, after it."""
    return jnp.sum(dd * bs["wr"], axis=0)


def _make_sample_tail(grid_shape):
    size = 1
    for s in grid_shape:
        size *= int(s)

    def tail(g, sst):
        """ONE scatter-add of the receiver sums into the wavefield grid."""
        z = jnp.zeros((size,), g.dtype)
        return z.at[sst["rcv"]].add(g).reshape(grid_shape)

    return tail


def _laplacian_stamps(grid_shape, rcv, dtype):
    """Precompute the 5/7-point Laplacian *stamp* at each receiver: flat
    indices and coefficients of every stencil tap, with taps that fall off
    the grid masked to coefficient 0 (the stencil op's zero boundary).

    Returns ``(idx, coef)`` of shape ``(2*nd+1, nrecv)``. This is what lets
    the fused flagship skip the dense Laplacian pass entirely: the operator
    only ever *samples* ``L m`` at receivers (forward) or *deposits*
    ``L^T (S^T d)`` from receivers (adjoint), and both are O(nrecv) stamp
    gathers/scatters instead of O(grid) stencil sweeps."""
    import numpy as np

    nd = len(grid_shape)
    rcv_np = np.asarray(rcv)
    coords = np.stack(np.unravel_index(rcv_np, grid_shape))  # (nd, nrecv)
    strides = np.ones(nd, dtype=np.int64)
    for ax in range(nd - 2, -1, -1):
        strides[ax] = strides[ax + 1] * grid_shape[ax + 1]
    idx = [rcv_np]
    coef = [np.full(rcv_np.shape, -2.0 * nd)]
    for ax in range(nd):
        for delta in (-1, 1):
            c = coords[ax] + delta
            valid = (c >= 0) & (c < grid_shape[ax])
            idx.append(np.where(valid, rcv_np + delta * strides[ax], rcv_np))
            coef.append(valid.astype(np.float64))
    return (
        jnp.asarray(np.stack(idx), dtype=jnp.int32),
        jnp.asarray(np.stack(coef), dtype=dtype),
    )


def _stamp_df(m, m0, bs):
    """Fused per-shot forward: ``(L m)[rcv]`` evaluated via receiver-local
    stencil stamps (block-invariant — XLA hoists it out of the vmap), then
    the per-shot weight."""
    lv = jnp.sum(jnp.ravel(m)[bs["sidx"]] * bs["scoef"], axis=0)  # (nrecv,)
    return lv * bs["wr"]


def _receiver_grid(grid_shape, nreceivers):
    """Factor ``nreceivers`` into a regular INTERIOR subgrid of the model:
    per-axis (start, stride, count), centered, with a ≥1-cell margin so
    every stencil tap of every receiver stays in bounds.

    Regular receiver geometry is both the realistic acquisition (constant
    receiver spacing) and the performance key: a separable subgrid can be
    sampled by per-axis gathers (major axis first — whole minor-axis rows
    move together; see :func:`_axis_sample`) instead of a flat
    element-by-element gather/scatter.

    Returns ``(starts, strides, counts)`` or ``None`` if the grid can't
    hold ``nreceivers`` with margins.
    """
    nd = len(grid_shape)

    def prime_factors(n):
        fs, p = [], 2
        while p * p <= n:
            while n % p == 0:
                fs.append(p)
                n //= p
            p += 1
        if n > 1:
            fs.append(n)
        return sorted(fs, reverse=True)

    counts = [1] * nd
    for f in prime_factors(int(nreceivers)):
        # give the factor to the axis with the most remaining room
        ax = max(range(nd), key=lambda a: (grid_shape[a] - 2) / (counts[a] * f))
        counts[ax] *= f
    if any(c > s - 2 for c, s in zip(counts, grid_shape)):
        return None
    starts, strides = [], []
    for s, c in zip(grid_shape, counts):
        interior = s - 2
        sr = max(1, interior // c)
        span = (c - 1) * sr
        starts.append(1 + (interior - span - 1) // 2)
        strides.append(sr)
    return tuple(starts), tuple(strides), tuple(counts)


# the ONE shared Laplacian implementation — bit-exactness between the fused
# and composed flagship paths depends on it
from ..ops.stencil import laplacian_nd as _lap  # noqa: E402


def _axis_sample(u, axes_idx):
    """Sample ``u`` on the receiver subgrid by successive per-axis gathers,
    MAJOR axis first: the big gather moves whole contiguous minor-axis rows,
    every later gather acts on an already-small array. Bit-exact against
    the flat gather."""
    g = u
    for ax, idx in enumerate(axes_idx):
        g = jnp.take(g, idx, axis=ax)
    return g


def _axis_deposit(g, grid_shape, axes_idx):
    """Adjoint of :func:`_axis_sample`: per-axis scatter-adds, MINOR axis
    first (while the array is small), finishing with the whole-row major
    scatter."""
    for ax in reversed(range(len(grid_shape))):
        shape = list(g.shape)
        shape[ax] = grid_shape[ax]
        z = jnp.zeros(shape, g.dtype)
        g = z.at[(slice(None),) * ax + (axes_idx[ax],)].add(g)
    return g


def _make_axis_sample_df(axes_idx):
    def df(m, m0, bs):
        return jnp.ravel(_axis_sample(m, axes_idx)) * bs["wr"]

    return df


def _make_axis_deposit_tail(grid_shape, counts, axes_idx, with_lap):
    """Lift of the receiver sums: per-axis deposit onto the grid, then (the
    fused operator) the dense Laplacian sweep.

    Running it after the cross-shard ``psum`` keeps the adjoint exactly in
    the range of ``L Pᵀ``: receivers are ≥2 cells apart, so each output of
    ``L`` is one deposited value times -2·nd or 1, exact in floating
    point. Summing per-shard Laplacians instead lets the collective round
    the centre and the arms of a stamp differently (its summation order
    may vary across the array), and LSQR amplifies that off-range rounding
    geometrically once it has converged."""
    def tail(g, sst):
        z = _axis_deposit(jnp.reshape(g, counts), grid_shape, axes_idx)
        return _lap(z) if with_lap else z

    return tail


def _make_sampled_stencil_df(grid_shape, counts, axes_idx):
    """Sweep-free flagship FORWARD kernel: ``(L m)[subgrid]`` without any
    dense O(grid) sweep. Per axis, gather the 3-block index set
    ``[idx-1, idx, idx+1]`` (one whole-row gather on the major axis,
    tiny gathers after), then combine the 2·nd+1 stencil taps on the small
    ``(3c0, 3c1, …)`` array — in the SAME add order as ``_lap`` so results
    are bit-identical to the composed operator. Model-grid traffic per
    forward: ~3·c0 rows read, nothing else.

    The matching ADJOINT is deliberately NOT the tap-transposed scatter
    (a scatter tail cannot fuse into the solver's next axpy/norm): the
    fused operator pairs this forward with
    ``_make_axis_deposit_tail(with_lap=True)``, the same linear transpose
    expressed as deposit-then-dense-sweep.

    Subgrid margins of ≥1 cell (guaranteed by :func:`_receiver_grid`) keep
    every ``idx±1`` in bounds."""
    nd = len(grid_shape)
    cat_idx = [jnp.concatenate([idx - 1, idx, idx + 1]) for idx in axes_idx]

    def _blk_slice(pos):
        return tuple(
            slice(b * c, (b + 1) * c) for b, c in zip(pos, counts)
        )

    center = (1,) * nd
    taps = [(center, -2.0 * nd)]
    for ax in range(nd):
        for b in (0, 2):
            taps.append((tuple(b if i == ax else 1 for i in range(nd)), 1.0))

    def df(m, m0, bs):
        E = m
        for ax in range(nd):
            E = jnp.take(E, cat_idx[ax], axis=ax)
        lv = None
        for pos, cf in taps:
            t = cf * E[_blk_slice(pos)]
            lv = t if lv is None else lv + t
        return jnp.ravel(lv) * bs["wr"]

    return df

def _make_stamp_tail(grid_shape):
    size = 1
    for s in grid_shape:
        size *= int(s)

    def tail(g, sst):
        """Fused adjoint lift ``L^T`` of the receiver sums: ONE scatter-add
        of the stencil stamps — never materializes the dense sampled field,
        so the only O(grid) cost is writing the output model."""
        vals = sst["scoef"] * g[None, :]  # (nstamp, nrecv)
        z = jnp.zeros((size,), g.dtype)
        return z.at[jnp.ravel(sst["sidx"])].add(jnp.ravel(vals)).reshape(
            grid_shape
        )

    return tail


def make_seismic_operator(
    grid_shape: Sequence[int],
    nshots: int,
    nreceivers: int,
    key: jax.Array,
    *,
    mesh: Optional[Mesh] = None,
    axis: str = "block",
    dtype=jnp.float32,
    impl: str = "fused",
) -> Operator:
    """Build the multi-shot linearized modeling operator ``A = S ∘ L``.

    Model space: ``grid_shape`` (2-D or 3-D). Range: ``(nshots, nreceivers)``.
    Per-shot state (stacked, sharded over the mesh block axis when given):
    receiver-point weights ``wr``; the receiver flat indices ``rcv`` are
    shared state (``op.jet.state["sstate"]["rcv"]`` with ``impl="fused"``).

    Receiver geometry is a FIXED regular interior subgrid shared by all
    shots (standard constant-spacing acquisition; see
    :func:`_receiver_grid` for why this is also the fast layout). When
    ``nreceivers`` can't be laid out as a subgrid with margins, a strided
    line with random jitter is used instead.

    ``impl="fused"`` (default): one stacked operator with the Laplacian
    sweep inlined into both kernels and the per-axis sample/deposit of
    :func:`_axis_sample`/:func:`_axis_deposit` (bit-exact, no flat
    gather/scatter). ``impl="composed"``: the explicit ``S ∘ L``
    composition through the framework algebra — same kernels, same math,
    exercises the combinator path.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    dom = Space(grid_shape, dtype)
    kw, kr = jax.random.split(key)

    ncells = dom.size
    grid_geom = _receiver_grid(grid_shape, nreceivers)
    if grid_geom is not None:
        starts, strides_g, counts = grid_geom
        import numpy as np

        axes_idx = [
            s + st * np.arange(c)
            for s, st, c in zip(starts, strides_g, counts)
        ]
        mesh_idx = np.stack(
            np.meshgrid(*axes_idx, indexing="ij"), axis=-1
        ).reshape(-1, len(grid_shape))
        rcv = jnp.asarray(
            np.ravel_multi_index(mesh_idx.T, grid_shape), dtype=jnp.int32
        )
    else:
        step = max(1, ncells // nreceivers)
        jitter = jax.random.randint(kr, (nreceivers,), 0, step)
        rcv = (jnp.arange(nreceivers) * step + jitter) % ncells  # (nrecv,)

    # per-shot gaussian illumination centered at a random source location,
    # evaluated AT THE RECEIVER POINTS only
    centers = jnp.stack(
        [
            jax.random.randint(jax.random.fold_in(kw, ax), (nshots,), 0, s)
            for ax, s in enumerate(grid_shape)
        ],
        axis=1,
    ).astype(dtype)
    sigma = jnp.asarray(max(grid_shape) / 4.0, dtype)
    rcv_coords = jnp.stack(
        jnp.unravel_index(rcv, grid_shape), axis=-1
    ).astype(dtype)  # (nrecv, nd)
    r2 = jnp.sum((rcv_coords[None, :, :] - centers[:, None, :]) ** 2, axis=-1)
    wr = jnp.exp(-0.5 * r2 / sigma**2)  # (nshots, nrecv)

    if impl not in ("fused", "composed"):
        raise ValueError(f"impl must be 'fused' or 'composed', got {impl!r}")

    if grid_geom is not None:
        axes_idx = tuple(
            jnp.asarray(s + st * jnp.arange(c))
            for s, st, c in zip(starts, strides_g, counts)
        )
        if impl == "fused":
            # Forward: sweep-free sampled stencil (reads ~3·c0 rows of the
            # grid, nothing else). Adjoint: per-axis deposit then the dense
            # Laplacian sweep — the same linear transpose, but ending in a
            # stencil whose output can fuse into the solver's following
            # axpy/norm (a scatter tail does not).
            return stacked_block_operator(
                nblocks=nshots,
                dom=dom,
                rng_block=Space((nreceivers,), dtype),
                bstate={"wr": wr},
                sstate={"rcv": rcv},
                df=_make_sampled_stencil_df(grid_shape, counts, axes_idx),
                stack_dft=_reduce_shots,
                dft_tail=_make_axis_deposit_tail(
                    grid_shape, counts, axes_idx, with_lap=True
                ),
                mesh=mesh,
                axis=axis,
            )
        S = stacked_block_operator(
            nblocks=nshots,
            dom=dom,
            rng_block=Space((nreceivers,), dtype),
            bstate={"wr": wr},
            df=_make_axis_sample_df(axes_idx),
            stack_dft=_reduce_shots,
            dft_tail=_make_axis_deposit_tail(
                grid_shape, counts, axes_idx, with_lap=False
            ),
            mesh=mesh,
            axis=axis,
        )
        return compose(S, laplacian_operator(grid_shape, dtype))

    if impl == "fused":
        # irregular geometry fallback: receiver-local gather/scatter stamps
        sidx, scoef = _laplacian_stamps(grid_shape, rcv, dtype)
        return stacked_block_operator(
            nblocks=nshots,
            dom=dom,
            rng_block=Space((nreceivers,), dtype),
            bstate={"wr": wr},
            sstate={"sidx": sidx, "scoef": scoef, "rcv": rcv},
            df=_stamp_df,
            stack_dft=_reduce_shots,
            dft_tail=_make_stamp_tail(grid_shape),
            mesh=mesh,
            axis=axis,
        )
    L = laplacian_operator(grid_shape, dtype)
    S = stacked_block_operator(
        nblocks=nshots,
        dom=dom,
        rng_block=Space((nreceivers,), dtype),
        bstate={"wr": wr},
        sstate={"rcv": rcv},
        df=_sample_df,
        stack_dft=_reduce_shots,
        dft_tail=_make_sample_tail(grid_shape),
        mesh=mesh,
        axis=axis,
    )
    return compose(S, L)


def make_seismic_problem(
    grid_shape: Sequence[int],
    nshots: int,
    nreceivers: int,
    seed: int = 0,
    *,
    mesh: Optional[Mesh] = None,
    noise: float = 0.0,
    dtype=jnp.float32,
    impl: str = "fused",
) -> Tuple[Operator, jax.Array, jax.Array]:
    """Operator + ground-truth reflectivity model + observed data.

    ``noise`` adds gaussian observation noise of that relative amplitude,
    making the least-squares problem inconsistent (no exact data fit) — use
    it for benchmarking so Krylov loops run their full iteration budget.
    """
    key = jax.random.PRNGKey(seed)
    k_op, k_m, k_n = jax.random.split(key, 3)
    A = make_seismic_operator(
        grid_shape, nshots, nreceivers, k_op, mesh=mesh, dtype=dtype,
        impl=impl,
    )
    # sparse spike reflectivity over a weak smooth background (the background
    # keeps the data nonzero even when few receivers neighbor a spike)
    k_s, k_bg = jax.random.split(k_m)
    flat = jnp.zeros((A.dom.size,), dtype)
    spikes = jax.random.choice(
        k_s, flat.shape[0], (max(4, flat.shape[0] // 200),), replace=False
    )
    bg = 0.05 * jax.random.normal(k_bg, (A.dom.size,), dtype)
    m_true = jnp.reshape(flat.at[spikes].set(1.0) + bg, A.dom.shape)
    d_obs = A(m_true)
    if noise > 0:
        scale = noise * jnp.std(d_obs)
        d_obs = d_obs + scale * jax.random.normal(k_n, d_obs.shape, dtype)
    return A, m_true, d_obs
