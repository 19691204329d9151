"""Heterogeneous block distribution — mixed-shape block rows on a mesh.

DistributedJets.jl distributes ARBITRARY ``@blockop`` rows over workers
(``docs/src/index.md:15``); rows there can differ in shape and kernel. XLA
is SPMD — one program per device — so a literal row-per-worker MPMD port
would fight the compiler. The JAX equivalent implemented here is
**group-stacking**:

1. partition the tall block column into groups of STRUCTURALLY IDENTICAL
   rows (same kernel functions, same domain/range spaces, same state-array
   shapes — only the state *values* differ);
2. stack each group's per-row state arrays along a leading block axis and
   turn the group into one :func:`stacked_block_operator` — the per-row
   kernel is ``vmap``-ed and, when the group size divides the mesh axis,
   sharded over it (forward embarrassingly parallel, adjoint accumulation
   one ``psum`` — the reference's cross-worker reduction,
   ``src/Jets.jl:1034-1057``);
3. recombine the groups with the ordinary :func:`block_operator`, whose
   adjoint sums the groups' (replicated) model contributions.

Heterogeneity therefore lives BETWEEN groups (different shapes/kernels),
while the hot per-device programs stay uniform — exactly what SPMD
compilation wants. Groups whose size does not divide the mesh axis stay unsharded and
still compute correctly (single-device stacked).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..core.block import block_operator
from ..core.blockspace import BlockVector
from ..core.jet import LinearOperator, Operator
from ..core.spaces import Space
from .sharded import shard_blocks, stacked_block_operator

__all__ = ["distribute_block_rows", "HeteroBlockLayout"]


def _is_array(v) -> bool:
    return isinstance(v, (jax.Array, np.ndarray))


def _structure_key(op: Operator):
    """Rows stack together iff everything except their state-array VALUES
    matches: kernels (by identity), spaces, state keys, array shapes.
    Non-array DYNAMIC state (operator children of combinators, nested
    pytrees) cannot be stacked along a block axis — such entries key by
    object identity, so those rows form singleton groups and still compute
    correctly (unsharded)."""
    from ..core.jet import _is_static_value

    jet = op.jet
    arr_sig, static_sig = [], []
    for k in sorted(jet.state):
        v = jet.state[k]
        if _is_array(v):
            arr_sig.append((k, tuple(v.shape), str(v.dtype)))
        elif _is_static_value(v):
            static_sig.append(k)
        else:
            static_sig.append((k, id(v)))  # unstackable: singleton group
    # normalize derived kernels: a linear jet's f / a self-adjoint dft are
    # fresh closures per construction — identity on them would make every
    # row a singleton; what matters is the underlying user kernel
    f_key = (
        "<linear-from-df>"
        if getattr(jet.f, "__wrapped_df__", None) is jet.df else jet.f
    )
    df_key = (
        "<tangent-from-f>"
        if getattr(jet.df, "__wrapped_f__", None) is jet.f else jet.df
    )
    dft_key = (
        "<self-adjoint>"
        if getattr(jet.dft, "__self_adjoint_from__", None) is jet.df
        else jet.dft
    )
    return (
        f_key, df_key, dft_key, jet.upstate, op.dom, op.rng,
        tuple(arr_sig), tuple(static_sig), type(op),
    )


def _statics_equal(a, b) -> bool:
    if callable(a) or callable(b):
        return a is b
    try:
        return bool(a == b)
    except Exception:  # unorderable config objects: identity
        return a is b


class HeteroBlockLayout:
    """The result of :func:`distribute_block_rows`.

    Attributes
    ----------
    operator: the distributed operator — a :func:`block_operator` over one
        stacked (and, where possible, mesh-sharded) operator per group.
    groups: per group, the list of ORIGINAL row indices it contains (rows
        are regrouped; use :meth:`pack`/:meth:`unpack` to convert data).
    """

    def __init__(self, operator: Operator, groups: List[List[int]],
                 group_spaces: List[Space], mesh: Optional[Mesh],
                 axis: str, sharded: List[bool]):
        self.operator = operator
        self.groups = groups
        self._group_spaces = group_spaces
        self._mesh = mesh
        self._axis = axis
        self.sharded = sharded

    def pack(self, blocks: Sequence[Any]) -> BlockVector:
        """Stack per-row data blocks (in ORIGINAL row order) into the
        operator's grouped range layout, sharding each sharded group's
        stack over the mesh."""
        out = []
        for gi, rows in enumerate(self.groups):
            stack = jnp.stack([jnp.asarray(blocks[i]) for i in rows])
            if self.sharded[gi]:
                stack = shard_blocks(stack, self._mesh, self._axis)
            out.append(stack)
        return BlockVector(out, self.operator.rng)

    def unpack(self, bv: BlockVector) -> List[Any]:
        """Split a grouped range vector back into per-row blocks in
        ORIGINAL row order."""
        n = sum(len(g) for g in self.groups)
        blocks: List[Any] = [None] * n
        for gi, rows in enumerate(self.groups):
            stack = bv.getblock(gi)
            for k, i in enumerate(rows):
                blocks[i] = stack[k]
        return blocks


def _make_group_operator(
    ops: Sequence[LinearOperator],
    mesh: Optional[Mesh],
    axis: str,
) -> Tuple[Operator, bool]:
    """Stack structurally-identical rows into ONE stacked block operator:
    per-row state arrays gain a leading block dim, static state is verified
    equal and captured in the kernel closures (it must stay jit-static —
    e.g. conv pad tuples)."""
    proto = ops[0].jet
    keys = sorted(proto.state)
    arr_keys = [k for k in keys if _is_array(proto.state[k])]
    static_keys = [k for k in keys if k not in arr_keys]
    static = {k: proto.state[k] for k in static_keys}
    for op in ops[1:]:
        for k in static_keys:
            if not _statics_equal(op.jet.state[k], static[k]):
                raise ValueError(
                    f"group rows disagree on static state {k!r}"
                )
    bstate: Dict[str, Any] = {
        k: jnp.stack([jnp.asarray(op.jet.state[k]) for op in ops])
        for k in arr_keys
    }

    child_df = proto.df
    child_dft = proto.dft if callable(proto.dft) else None

    def df(dm, m0, bs):
        return child_df(dm, m0, {**bs, **static})

    dft = None
    if child_dft is not None:
        def dft(dd, m0, bs):  # noqa: E306
            return child_dft(dd, m0, {**bs, **static})

    nrows = len(ops)
    use_mesh = mesh is not None and nrows % mesh.shape[axis] == 0
    stacked = stacked_block_operator(
        nblocks=nrows,
        dom=ops[0].dom,
        rng_block=ops[0].rng,
        bstate=bstate,
        df=df,
        dft=dft,
        mesh=mesh if use_mesh else None,
        axis=axis,
    )
    return stacked, use_mesh


def distribute_block_rows(
    rows: Sequence[Operator],
    mesh: Optional[Mesh] = None,
    axis: str = "block",
) -> HeteroBlockLayout:
    """Distribute a HETEROGENEOUS tall block column over a device mesh.

    ``rows[i]`` maps the SHARED model space to its own data block (the
    reference's N×1 ``@blockop``, domain rule ``src/Jets.jl:926-930``); rows
    may mix shapes and kernels freely. Rows are grouped by structure, each
    group stacked into one vmapped operator and — when its size divides the
    mesh axis — sharded over it; the grouped operator's forward/adjoint are
    mathematically identical to the original ``block_operator(rows)`` (up to
    row regrouping: see :meth:`HeteroBlockLayout.pack`).

    All rows must be linear (solver use-case; linearize first otherwise).
    """
    rows = list(rows)
    if not rows:
        raise ValueError("no rows")
    dom = rows[0].dom
    from ..core.jet import AdjointOperator

    for op in rows:
        if not isinstance(op, LinearOperator):
            raise TypeError(
                "distribute_block_rows requires linear rows (linearize "
                "nonlinear operators first)"
            )
        if isinstance(op, AdjointOperator):
            raise TypeError(
                "adjoint-wrapped rows cannot be stacked directly; "
                "materialize the adjoint kernel in a plain operator first"
            )
        if op.dom != dom:
            raise ValueError("rows must share one model domain")

    order: List[Any] = []
    by_key: Dict[Any, List[int]] = {}
    for i, op in enumerate(rows):
        k = _structure_key(op)
        if k not in by_key:
            by_key[k] = []
            order.append(k)
        by_key[k].append(i)

    groups = [by_key[k] for k in order]
    group_ops, sharded = [], []
    for rows_idx in groups:
        gop, used = _make_group_operator(
            [rows[i] for i in rows_idx], mesh, axis
        )
        group_ops.append(gop)
        sharded.append(used)

    # a 1-column block operator over the group-stacked rows: the range is a
    # BlockSpace (one block per group) whichever way the grouping fell out,
    # so pack/unpack and solver reductions are uniform
    op = block_operator([[gop] for gop in group_ops])
    return HeteroBlockLayout(
        op, groups, [g.rng for g in group_ops], mesh, axis, sharded
    )
