"""Distribution layer — mesh-sharded block operators.

The reference family's only parallelism axis is **block parallelism**: in
DistributedJets.jl (``docs/src/index.md:15``) the block rows of a
``@blockop`` operator (e.g. seismic shot gathers) live on remote Julia
workers, and the block-adjoint accumulation loop (``src/Jets.jl:1034-1057``)
plus ``BlockArray`` dot/norm reductions (``:834-856``) become cross-worker
reductions.

JAX re-design (SURVEY §2 ledger):

* homogeneous block rows are a **stacked leading axis** of one array — the
  per-block kernel is ``vmap``-ed over it, so each block's work is one slice
  of a single batched XLA program (zero per-block dispatch);
* the stacked axis is sharded over a ``jax.sharding.Mesh`` axis (``"block"``)
  with ``shard_map``; forward is embarrassingly parallel, the adjoint's
  block accumulation is a local reduction + ``jax.lax.psum`` over the mesh —
  exactly the reference's accumulation loop turned into a collective;
* solver-side inner products run under ``jit`` on sharded arrays, so XLA
  GSPMD inserts the all-reduces automatically: **the Krylov solvers are
  unchanged** between single-chip and pod-slice runs.

The stacked operator is still an ordinary :class:`LinearOperator` /
:class:`Operator` — it composes, sums, blocks, and solves like any other jet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space

__all__ = [
    "stacked_block_operator",
    "block_sharding",
    "shard_blocks",
    "replicate",
    "make_block_mesh",
]


def make_block_mesh(n_devices: Optional[int] = None, axis: str = "block") -> Mesh:
    """A 1-D device mesh over the block axis (shots).

    Axes are ``Auto`` (GSPMD-inferred shardings): solver-side reductions on
    sharded arrays then compile without per-op ``out_sharding`` annotations,
    while the operator's forward/adjoint still pin their collectives
    explicitly via ``shard_map``.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh(
        (len(devs),), (axis,), devices=devs,
        axis_types=(jax.sharding.AxisType.Auto,),
    )


def block_sharding(mesh: Mesh, axis: str = "block") -> NamedSharding:
    """Sharding that splits the leading (block) axis over the mesh."""
    return NamedSharding(mesh, P(axis))


def shard_blocks(x, mesh: Mesh, axis: str = "block"):
    """Place a stacked block array with its leading axis sharded over the mesh."""
    return jax.device_put(x, block_sharding(mesh, axis))


def replicate(x, mesh: Mesh):
    """Replicate a model-space array across the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


# ---------------------------------------------------------------------------
# Stacked (homogeneous) block operator
# ---------------------------------------------------------------------------
# A tall block column: every block maps the SAME model m to its own data
# block, with per-block parameters carried in stacked arrays:
#
#     d[b] = f(m, state[b])          forward  (vmap / shard_map over b)
#     m'   = sum_b f'(d[b], state[b])  adjoint (local sum + psum over mesh)
#
# This is the reference's N×1 @blockop (domain = child domain,
# src/Jets.jl:926-930) — the seismic multi-shot shape of BASELINE configs
# #4 and #5.


def _spec_like(tree, spec):
    return jax.tree_util.tree_map(lambda _: spec, tree)


_PVARY_PSUM_CACHE: Dict = {}


def _pvary_transpose_psums(mesh: Mesh, axis: str) -> bool:
    """Detect ONCE (per process / axis size) whether the vjp of a function
    of a replicated input, taken inside ``shard_map``, already performs the
    mesh-axis psum itself (the transpose of the implicit ``pvary``). This
    is a JAX-version-dependent replication-tracking behavior that
    ``_stacked_dft`` must compensate for — probing it beats hard-coding it
    (a future JAX change would otherwise silently mis-scale sharded
    ``shot_map='map'`` gradients; ADVICE r3).

    The probe: each shard scales the replicated scalar by ``axis_index+1``
    and takes the vjp; the psum of the resulting cotangents is
    ``n(n+1)/2`` when the inner vjp did NOT reduce, and ``n·n(n+1)/2``
    when it did.
    """
    n = int(mesh.shape[axis])
    if n == 1:
        return True  # indistinguishable — and the double-count is ×1
    key = (jax.__version__, n, str(getattr(mesh, "axis_types", None)))
    if key not in _PVARY_PSUM_CACHE:
        def shard_fn(x):
            w = (lax.axis_index(axis) + 1).astype(x.dtype)
            _, vjp = jax.vjp(lambda m: m * w, x)
            ct = jnp.ones_like(x)
            try:  # cotangent must carry the varying type of the output
                ct = lax.pcast(ct, axis, to="varying")
            except (AttributeError, TypeError):
                ct = lax.pvary(ct, (axis,))
            (g,) = vjp(ct)
            return lax.psum(g, axis)

        try:
            total = float(jax.jit(jax.shard_map(
                shard_fn, mesh=mesh, in_specs=P(), out_specs=P()
            ))(jnp.float32(1.0)))
            _PVARY_PSUM_CACHE[key] = total > n * (n + 1) / 2 + 0.5
        except Exception as e:  # noqa: BLE001
            # probe failed (exotic backend): fall back to the behavior
            # measured on jax 0.9.0 — the inner vjp DOES psum. Warn
            # loudly: if a future JAX both breaks the probe AND changes
            # the replication-transpose behavior, sharded shot_map='map'
            # gradients would be scaled by the axis size (ADVICE r4).
            import warnings

            warnings.warn(
                "pvary-transpose probe failed "
                f"({type(e).__name__}: {e}); assuming the jax-0.9.0 "
                "behavior (inner vjp psums over the mesh axis). If "
                "sharded shot_map gradients look scaled by the axis "
                "size, this assumption no longer holds.",
                RuntimeWarning, stacklevel=2,
            )
            _PVARY_PSUM_CACHE[key] = True
    return _PVARY_PSUM_CACHE[key]


def _block_map(state):
    """The per-block mapping transform: ``jax.vmap`` (default — one batched
    XLA program over the local shot stack) or ``lax.map`` (sequential scan
    over shots — holds one shot's wavefields and history at a time, which
    bounds memory where a batched stack would not fit)."""
    if state.get("shot_map", "vmap") == "map":
        return lambda f: (lambda xs: lax.map(f, xs))
    return jax.vmap


def _stacked_f(m, state):
    child_f, bstate, sstate = state["child_f"], state["bstate"], state["sstate"]
    mesh, axis = state["mesh"], state["axis"]
    bmap = _block_map(state)
    if mesh is None:
        return bmap(lambda bs: child_f(m, {**bs, **sstate}))(bstate)

    def shard_fn(m_rep, bst_shard, sst):
        return bmap(lambda bs: child_f(m_rep, {**bs, **sst}))(bst_shard)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), _spec_like(bstate, P(axis)), _spec_like(sstate, P())),
        out_specs=P(axis),
    )(m, bstate, sstate)


def _stacked_df(dm, m0, state):
    child_df, bstate, sstate = state["child_df"], state["bstate"], state["sstate"]
    mesh, axis = state["mesh"], state["axis"]
    bmap = _block_map(state)
    if mesh is None:
        return bmap(lambda bs: child_df(dm, m0, {**bs, **sstate}))(bstate)

    def shard_fn(dm_rep, m0_rep, bst_shard, sst):
        return bmap(lambda bs: child_df(dm_rep, m0_rep, {**bs, **sst}))(
            bst_shard
        )

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), _spec_like(bstate, P(axis)), _spec_like(sstate, P())),
        out_specs=P(axis),
    )(dm, m0, bstate, sstate)


def _stacked_dft(dd, m0, state):
    """Adjoint accumulation: local per-shard reduction, then one ``psum``
    over the block axis — the reference's cross-worker accumulation
    (src/Jets.jl:1034-1057) as a single collective.

    Two accumulation strategies:
    * ``child_dft`` — per-block adjoint, vmapped then summed (materializes a
      per-block model-space contribution; general but memory-heavy);
    * ``stack_dft(dd_stack, m0, bstate) -> model`` — whole-stack adjoint over
      the local shard in one shot (e.g. a reduce + single scatter-add);
      preferred for hot operators.

    A ``dft_tail(acc, sstate)`` is applied once to the accumulated sum,
    after the ``psum``: a linear lift that lets the collective carry a
    small reduced array (e.g. receiver sums) instead of the model.
    """
    child_dft, stack_dft = state["child_dft"], state["stack_dft"]
    tail = state["dft_tail"]
    bstate, sstate = state["bstate"], state["sstate"]
    mesh, axis = state["mesh"], state["axis"]

    bmap = _block_map(state)

    def local_adjoint(dd_loc, m0_loc, bst_loc, sst):
        if stack_dft is not None:
            return stack_dft(dd_loc, m0_loc, {**bst_loc, **sst})
        if state.get("shot_map", "vmap") == "map":
            contribs = lax.map(
                lambda db_bs: child_dft(db_bs[0], m0_loc,
                                        {**db_bs[1], **sst}),
                (dd_loc, bst_loc))
        else:
            contribs = jax.vmap(
                lambda d_b, bs: child_dft(d_b, m0_loc, {**bs, **sst}))(
                dd_loc, bst_loc)
        return jax.tree_util.tree_map(lambda c: jnp.sum(c, axis=0), contribs)

    def lift(acc, sst):
        return acc if tail is None else tail(acc, sst)

    if mesh is None:
        return lift(local_adjoint(dd, m0, bstate, sstate), sstate)

    def shard_fn(dd_shard, m0_rep, bst_shard, sst):
        res = local_adjoint(dd_shard, m0_rep, bst_shard, sst)
        # (with an inner vjp, its pvary transpose has already psum'd)
        if not getattr(child_dft, "_includes_psum", False):
            res = lax.psum(res, axis)
        return lift(res, sst)

    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(), _spec_like(bstate, P(axis)), _spec_like(sstate, P())),
        out_specs=P(),
    )(dd, m0, bstate, sstate)


def stacked_block_operator(
    *,
    nblocks: int,
    dom: Space,
    rng_block: Space,
    bstate: Dict[str, Any],
    df: Callable,
    f: Optional[Callable] = None,
    dft: Optional[Callable] = None,
    stack_dft: Optional[Callable] = None,
    dft_tail: Optional[Callable] = None,
    sstate: Optional[Dict[str, Any]] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "block",
    shot_map: str = "vmap",
) -> Operator:
    """Homogeneous tall block-column operator over a stacked block axis.

    Parameters
    ----------
    nblocks: number of blocks (shots). With a ``mesh``, must be divisible by
        the mesh axis size.
    dom: shared model space (the child domain — reference single-column rule).
    rng_block: per-block data space; the operator's range is
        ``(nblocks,) + rng_block.shape``.
    bstate: dict of stacked per-block parameter arrays (leading dim nblocks).
    sstate: dict of SHARED parameter arrays replicated across blocks (and
        across the mesh) — e.g. a fixed receiver geometry. Merged into the
        per-block state dict passed to the kernels; keys must not collide
        with ``bstate``.
    df / f / dft: child kernels with jet signatures operating on ONE block's
        (unstacked) state. ``dft=None`` derives the adjoint via
        ``jax.linear_transpose``. ``stack_dft(dd, m0, state)`` instead
        consumes the whole (local) stack at once.
    dft_tail: optional linear map ``(acc, sstate) -> model`` applied to the
        adjoint accumulation after the cross-shard ``psum`` (needs ``dft``
        or ``stack_dft``); their output is then whatever ``dft_tail`` lifts.
    mesh / axis: optional device mesh; the stacked axis shards over ``axis``
        and the adjoint accumulates with ``psum`` over it.
    shot_map: "vmap" (default — one batched program over the local shots) or
        "map" (``lax.map`` sequential scan over local shots — one shot's
        wavefields and history in memory at a time).
    """
    if shot_map not in ("vmap", "map"):
        raise ValueError(f"shot_map must be 'vmap' or 'map', got {shot_map!r}")
    if dft_tail is not None and dft is None and stack_dft is None:
        raise ValueError("dft_tail needs a hand-written dft or stack_dft")
    sstate = dict(sstate or {})
    for k, v in bstate.items():
        if k in sstate:
            raise ValueError(f"state key {k!r} appears in both bstate and sstate")
        if v.shape[0] != nblocks:
            raise ValueError(
                f"bstate[{k!r}] leading dim {v.shape[0]} != nblocks {nblocks}"
            )
    if mesh is not None:
        ax_size = mesh.shape[axis]
        if nblocks % ax_size:
            raise ValueError(
                f"nblocks {nblocks} not divisible by mesh axis {axis!r} "
                f"size {ax_size}"
            )
        # Commit the parameter arrays to their mesh placement NOW — with
        # make_array_from_callback so the SAME factory works in a
        # multi-process (multi-host) session, where each process holds only
        # its own shards (the DistributedJets story: per-worker block rows,
        # docs/src/index.md:15). Arrays that are already global (e.g. built
        # by runner.assemble_global from host-local slabs) pass through.
        from .runner import distribute_blocks, replicate_global

        import numpy as _np

        def _place(v, place_fn):
            if isinstance(v, jax.Array) and not v.is_fully_addressable:
                return v  # already a global (multi-process) array
            if not isinstance(v, (jax.Array, _np.ndarray)):
                return v  # static config (ints/tuples) — not device data
            return place_fn(v)

        bstate = {
            k: _place(v, lambda a: distribute_blocks(a, mesh, axis))
            for k, v in bstate.items()
        }
        sstate = {
            k: _place(v, lambda a: replicate_global(a, mesh))
            for k, v in sstate.items()
        }
    rng = Space((nblocks,) + rng_block.shape, rng_block.dtype)
    state = {
        "child_f": f if f is not None else (lambda m, bs, __df=df: __df(m, None, bs)),
        "child_df": df,
        "child_dft": dft,
        "stack_dft": stack_dft,
        "dft_tail": dft_tail,
        "bstate": bstate,
        "sstate": sstate,
        "mesh": mesh,
        "axis": axis,
        "shot_map": shot_map,
    }
    # With no hand-written adjoint (per-block dft or whole-stack stack_dft),
    # transpose the WHOLE stacked (possibly shard_map-ed) forward at the jet
    # level: jax.linear_transpose turns the replicated-model broadcast into
    # the psum accumulation itself. (Transposing per block *inside* the shard
    # would double-count: the transpose of the implicit pvary is already a
    # psum.)
    have_adjoint = dft is not None or stack_dft is not None
    if not have_adjoint and shot_map == "map":
        # lax.map is not transposable in this JAX version (the scan
        # transpose trips over the invariant replicated-model input), so
        # the sequential mode gets its adjoint built explicitly: per-shot
        # vjp of the tangent, run sequentially by _stacked_dft's lax.map
        # branch, summed locally, and psum'd over the mesh axis — the same
        # accumulation structure, just stated instead of derived.
        def _auto_child_dft(d_b, m0, bs, __df=df):
            prim = m0 if m0 is not None else dom.zeros()
            _, vjp = jax.vjp(lambda dm: __df(dm, m0, bs), prim)
            (out,) = vjp(d_b)
            return out

        # Inside shard_map, this vjp's transpose of the REPLICATED model
        # input may already perform the psum over the block axis (the pvary
        # transpose; it does on jax 0.9.0 — measured: exactly axis-size ×) —
        # _stacked_dft must then skip its explicit psum or the accumulation
        # double-counts. Probed once per process rather than hard-coded;
        # the mesh dot-product gate in tests/test_parallel.py remains the
        # end-to-end check.
        _auto_child_dft._includes_psum = (
            _pvary_transpose_psums(mesh, axis) if mesh is not None else False
        )
        state["child_dft"] = _auto_child_dft
        have_adjoint = True
    j = Jet(
        dom=dom,
        rng=rng,
        f=_stacked_f,
        df=_stacked_df,
        dft=_stacked_dft if have_adjoint else None,
        upstate=_stacked_upstate if f is not None else None,
        state=state,
    )
    return (Operator if f is not None else LinearOperator)(j)


def _stacked_upstate(m0, state):
    # the model is shared across blocks; nothing block-local to refresh by
    # default (per-block derived state belongs in the child's df closure).
    return {}
