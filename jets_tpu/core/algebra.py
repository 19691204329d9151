"""Operator algebra — L2: composition, sums, scalar scaling, vec.

JAX re-design of the reference's combinators (Jets.jl composite
``src/Jets.jl:518-623``, sum ``:625-731``, scalar ``:1156-1164``, vec
``:1126-1154``). The reference's defining trick is kept: **a combinator is not
a new class — it is just another jet** whose kernels are module-level
functions and whose child operators live in the jet's ``state``
(``src/Jets.jl:522,628,1129,1162``). Because operators are pytrees, a whole
composite chain applied under ``jit`` traces into ONE XLA program — the
reference's per-stage allocation (``src/Jets.jl:524-528``) disappears into
XLA fusion.

Combinator dispatch ("which combinator is this jet?") follows the reference's
dispatch-on-``f!``-type scheme (``src/Jets.jl:578``): we test kernel function
identity (``op.jet.f is _composite_f``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

from .jet import (
    AdjointOperator,
    Jet,
    LinearOperator,
    Operator,
)
from .spaces import Space

__all__ = [
    "compose",
    "add",
    "subtract",
    "scale",
    "vec",
    "is_composite",
    "is_sum",
]


def _wrap(x) -> Operator:
    """Auto-wrap plain matrices into linear operators (reference matrix
    interop, ``src/Jets.jl:573-576,691-708``)."""
    if isinstance(x, Operator):
        return x
    if hasattr(x, "ndim") and getattr(x, "ndim", None) == 2:
        from ..ops.matrix import matrix_operator

        return matrix_operator(jnp.asarray(x))
    raise TypeError(f"cannot interpret {type(x).__name__} as an operator")


def _is_linear(op: Operator) -> bool:
    return isinstance(op, LinearOperator)


# ---------------------------------------------------------------------------
# Composition (reference src/Jets.jl:518-623)
# ---------------------------------------------------------------------------


def _composite_f(m, state):
    """Forward: apply children right-to-left (innermost first)."""
    for child in reversed(state["ops"]):
        m = child(m)
    return m


def _composite_df(dm, m0, state):
    """Tangent: children must be linear (i.e. pinned via linearize)."""
    for child in reversed(state["ops"]):
        if not isinstance(child, LinearOperator):
            raise ValueError(
                "tangent of a nonlinear composite requires linearize(op, m0) first"
            )
        dm = child(dm)
    return dm


def _composite_dft(dd, m0, state):
    """Adjoint: reversed children adjoints, (A∘B)^H = B^H ∘ A^H
    (reference ``JetComposite_df′!``, src/Jets.jl:536-540)."""
    for child in state["ops"]:
        dd = child.adjoint_apply(dd)
    return dd


def _composite_upstate(m0, state):
    """Linearization-point propagation (reference ``point!`` specialization,
    src/Jets.jl:578-589): pin each child at the *propagated* intermediate
    point, running the forward chain innermost-out."""
    new_rev = []
    m = m0
    for child in reversed(state["ops"]):
        new_rev.append(child.linearize(m))
        m = child(m)
    return {"ops": tuple(reversed(new_rev))}


def is_composite(op: Operator) -> bool:
    return op.jet.f is _composite_f


def compose(*operators) -> Operator:
    """``compose(A, B, ...)`` = A ∘ B ∘ … (rightmost applied first).

    Chains flatten (reference ``jops_comp``, src/Jets.jl:542-550); the result
    is linear iff every child is (src/Jets.jl:569-570).
    """
    ops = []
    for op in operators:
        op = _wrap(op)
        if is_composite(op) and not isinstance(op, AdjointOperator):
            ops.extend(op.jet.state["ops"])
        else:
            ops.append(op)
    if len(ops) == 1:
        return ops[0]
    for a, b in zip(ops[:-1], ops[1:]):
        if a.dom != b.rng:
            raise ValueError(
                f"compose: domain/range mismatch: {a.dom} (domain of left) != "
                f"{b.rng} (range of right)"
            )
    j = Jet(
        dom=ops[-1].dom,
        rng=ops[0].rng,
        f=_composite_f,
        df=_composite_df,
        dft=_composite_dft,
        upstate=_composite_upstate,
        state={"ops": tuple(ops)},
    )
    cls = LinearOperator if all(_is_linear(o) for o in ops) else Operator
    return cls(j)


# ---------------------------------------------------------------------------
# Sums (reference src/Jets.jl:625-731)
# ---------------------------------------------------------------------------


def _sum_f(m, state):
    acc = None
    for sgn, child in zip(state["sgns"], state["ops"]):
        term = child(m)
        term = term if sgn > 0 else -term
        acc = term if acc is None else acc + term
    return acc


def _sum_df(dm, m0, state):
    acc = None
    for sgn, child in zip(state["sgns"], state["ops"]):
        if not isinstance(child, LinearOperator):
            raise ValueError(
                "tangent of a nonlinear sum requires linearize(op, m0) first"
            )
        term = child(dm)
        term = term if sgn > 0 else -term
        acc = term if acc is None else acc + term
    return acc


def _sum_dft(dd, m0, state):
    acc = None
    for sgn, child in zip(state["sgns"], state["ops"]):
        term = child.adjoint_apply(dd)
        term = term if sgn > 0 else -term
        acc = term if acc is None else acc + term
    return acc


def _sum_upstate(m0, state):
    """All children linearize at the *same* point (reference ``point!``
    forwarding, src/Jets.jl:710-715)."""
    return {"ops": tuple(child.linearize(m0) for child in state["ops"])}


def is_sum(op: Operator) -> bool:
    return op.jet.f is _sum_f


def _terms(op: Operator, sgn: int):
    """Flatten nested sums with sign bookkeeping (reference flipsgn/sgns,
    src/Jets.jl:657-676): ``A - (B - C)`` distributes to ``A - B + C``."""
    op = _wrap(op)
    if is_sum(op) and not isinstance(op, AdjointOperator):
        s = op.jet.state
        out = []
        for child_sgn, child in zip(s["sgns"], s["ops"]):
            out.append((sgn * child_sgn, child))
        return out
    return [(sgn, op)]


def _make_sum(terms) -> Operator:
    sgns = tuple(int(s) for s, _ in terms)
    ops = tuple(o for _, o in terms)
    dom, rng = ops[0].dom, ops[0].rng
    for o in ops[1:]:
        if o.dom != dom or o.rng != rng:
            raise ValueError(
                f"sum: all operators need matching spaces; got {o.dom}->{o.rng} "
                f"vs {dom}->{rng}"
            )
    j = Jet(
        dom=dom,
        rng=rng,
        f=_sum_f,
        df=_sum_df,
        dft=_sum_dft,
        upstate=_sum_upstate,
        state={"ops": ops, "sgns": sgns},
    )
    cls = LinearOperator if all(_is_linear(o) for o in ops) else Operator
    return cls(j)


def add(A, B) -> Operator:
    return _make_sum(_terms(A, +1) + _terms(B, +1))


def subtract(A, B) -> Operator:
    return _make_sum(_terms(A, +1) + _terms(B, -1))


# ---------------------------------------------------------------------------
# Scalar scaling (reference src/Jets.jl:1156-1164)
# ---------------------------------------------------------------------------


def _scale_df(dm, m0, state):
    return state["a"] * dm


def _scale_dft(dd, m0, state):
    return jnp.conj(state["a"]) * dd


def scale(a, A) -> Operator:
    """``a * A`` — scaling composed onto ``A``, as in the reference
    (``(aI) ∘ A``, src/Jets.jl:1159-1164)."""
    A = _wrap(A)
    rng = A.rng
    dt = jnp.result_type(rng.dtype, a)
    if dt != rng.dtype:
        raise TypeError(
            f"scaling a {rng.dtype} operator by {a!r} would promote to {dt}; "
            "cast the scalar first"
        )
    j = Jet(dom=rng, rng=rng, df=_scale_df, dft=_scale_dft, state={"a": a})
    return compose(LinearOperator(j), A)


# ---------------------------------------------------------------------------
# vec — 1-D view of an operator (reference src/Jets.jl:1126-1154)
# ---------------------------------------------------------------------------


def _vec_f(m, state):
    op = state["op"]
    # space-owned ravel: works for plain arrays AND BlockVectors
    return op.rng.ravel(op(op.dom.reshape(m)))


def _vec_df(dm, m0, state):
    op = state["op"]
    if not isinstance(op, LinearOperator):
        raise ValueError("tangent of vec(op) requires linearize first")
    return op.rng.ravel(op(op.dom.reshape(dm)))


def _vec_dft(dd, m0, state):
    op = state["op"]
    return op.dom.ravel(op.adjoint_apply(op.rng.reshape(dd)))


def _vec_upstate(m0, state):
    op = state["op"]
    return {"op": op.linearize(op.dom.reshape(m0))}


def vec(A) -> Operator:
    """Adapter exposing any operator over flattened 1-D spaces so 1-D-only
    consumers can use it (reference ``JopVec``, src/Jets.jl:1129-1154).

    No-op if the operator is already 1-D→1-D over dense or symmetric
    spaces (src/Jets.jl:1130). Block spaces are always adapted: the
    reference's ``BlockArray`` is a true ``AbstractVector`` a 1-D solver
    can consume directly, but our ``BlockVector`` is a pytree — ``vec``
    flattens it. An n-D :class:`SymmetricSpace` cannot be vec'd: its
    multiplicity-weighted inner product has no flat-``Space`` equivalent,
    and silently dropping the weights would break every adjoint downstream.
    """
    from .blockspace import BlockSpace
    from .spaces import MappedSymmetricSpace, SymmetricSpace

    A = _wrap(A)
    if A.dom.ndim == 1 and A.rng.ndim == 1 and not (
        isinstance(A.dom, BlockSpace) or isinstance(A.rng, BlockSpace)
    ):
        return A
    for sp in (A.dom, A.rng):
        if isinstance(sp, (SymmetricSpace, MappedSymmetricSpace)) and sp.ndim > 1:
            raise NotImplementedError(
                "vec() of an operator over an n-D SymmetricSpace would drop "
                "its multiplicity weights; reshape at the call site instead"
            )
    j = Jet(
        dom=Space((A.dom.size,), A.dom.dtype),
        rng=Space((A.rng.size,), A.rng.dtype),
        f=_vec_f,
        df=_vec_df,
        dft=_vec_dft,
        upstate=_vec_upstate,
        state={"op": A},
    )
    return (LinearOperator if _is_linear(A) else Operator)(j)
