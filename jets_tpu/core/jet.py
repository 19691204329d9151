"""The jet core — L1 of the framework.

A *jet* is a function together with a linearization point: forward map ``f``,
tangent map ``df`` (the Jacobian action at ``m0``), and adjoint tangent map
``dft``. This is the JAX re-design of the reference's core record
(Jets.jl ``Jet``, ``src/Jets.jl:131-301``) and operator wrappers
(``JopNl``/``JopLn``/``JopAdjoint``, ``src/Jets.jl:194-403``).

Design deltas from the reference, deliberate and documented:

* **Immutability.** The reference's ``Jet`` is mutable and ``jacobian!``
  aliases shared state (pinned by ``test/runtests.jl:203-217``). JAX is
  functional: here ``point``/``jacobian``/``with_state`` return *new* pytrees;
  there is no aliasing footgun and every operator is safe to close over in a
  ``jit``.
* **Adjoint by construction.** The reference requires a hand-written
  ``df′!`` (defaulting to self-adjoint when omitted, ``src/Jets.jl:170-188``).
  Here a missing ``dft`` is *derived from ``df`` via ``jax.linear_transpose``*
  — correct by construction, including the complex case (conjugation wrap).
  Pass ``dft="self"`` for the reference's self-adjoint default, or a callable
  to override with a faster hand-written adjoint (validated by the
  dot-product gate, ``verify.py``).
* **Operators are pytrees.** Arrays in ``m0``/``state`` are leaves; spaces and
  kernel functions are static aux data. Operators therefore pass through
  ``jit``/``vmap``/``shard_map`` boundaries and solvers can take them as
  arguments without retracing per instance.

Kernel signature convention (all pure):

* forward:  ``f(m, state) -> d``
* tangent:  ``df(dm, m0, state) -> dd``
* adjoint:  ``dft(dd, m0, state) -> dm``
* state refresh: ``upstate(m0, state) -> dict`` of updates merged into state
  (reference ``upstate!``, ``src/Jets.jl:297-301``)

``state`` is a plain dict. Array-valued entries are traced pytree leaves;
non-array entries (ints, shapes, strings) are treated as static aux so they
can parameterize shapes inside jit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from .spaces import Space

__all__ = [
    "Jet",
    "Operator",
    "LinearOperator",
    "AdjointOperator",
    "jet_of",
    "point",
    "linearize",
    "jacobian",
    "adjoint",
    "state",
    "with_state",
    "perfstat",
    "close",
]


def _is_static_value(v) -> bool:
    """True if ``v`` is jit-static config (hashable, no array data).

    Anything else — arrays, operators, pytrees containing arrays — is a
    dynamic child traced through jit. Callables count as static (kernel
    functions); tuples are static only if every element is.
    """
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        return True
    if isinstance(v, (Space, jnp.dtype, jax.sharding.Mesh)):
        return True
    if callable(v) and not isinstance(v, Operator):
        return True
    if isinstance(v, tuple):
        return all(_is_static_value(e) for e in v)
    return False


def _split_state(s: Dict[str, Any]):
    """Split state into (dynamic pytree dict, static hashable tuple)."""
    dyn, sta = {}, []
    for k in sorted(s):
        v = s[k]
        if _is_static_value(v):
            sta.append((k, v))
        else:
            if isinstance(v, list):
                v = tuple(v)
            dyn[k] = v
    return dyn, tuple(sta)


class Jet:
    """Immutable (function, linearization point) record.

    Reference: ``src/Jets.jl:133-188``. Constructor defaulting rules kept:
    no ``f`` ⇒ linear (``f`` = ``df``); no ``df`` ⇒ ``f`` is linear and is its
    own tangent. ``dft=None`` ⇒ derived via ``jax.linear_transpose``;
    ``dft="self"`` ⇒ self-adjoint (``dft`` = ``df``), the reference default.
    """

    __slots__ = ("dom", "rng", "f", "df", "dft", "upstate", "m0", "_state",
                 "perfstat_fn", "close_fn")

    def __init__(
        self,
        *,
        dom: Space,
        rng: Space,
        f: Optional[Callable] = None,
        df: Optional[Callable] = None,
        dft: Any = None,
        upstate: Optional[Callable] = None,
        m0: Any = None,
        state: Optional[Dict[str, Any]] = None,
        perfstat: Optional[Callable] = None,
        close: Optional[Callable] = None,
    ):
        if f is None and df is None:
            raise ValueError("Jet needs at least one of f (forward) / df (tangent)")
        if f is None:
            # Linear jet: forward IS the tangent (reference :170-188).
            f = _linear_forward_from_df(df)
        if df is None:
            df = _tangent_from_linear_f(f)
        if dft == "self":
            dft = _self_adjoint_from_df(df)
        sset = object.__setattr__
        sset(self, "dom", dom)
        sset(self, "rng", rng)
        sset(self, "f", f)
        sset(self, "df", df)
        sset(self, "dft", dft)  # None => derive via linear_transpose on demand
        sset(self, "upstate", upstate)
        sset(self, "m0", m0)
        sset(self, "_state", dict(state or {}))
        sset(self, "perfstat_fn", perfstat)
        sset(self, "close_fn", close)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("Jet is immutable; use point()/with_state()")

    # -- state -------------------------------------------------------------
    @property
    def state(self) -> Dict[str, Any]:
        return dict(self._state)

    def replace(self, **kw) -> "Jet":
        cfg = dict(
            dom=self.dom, rng=self.rng, f=self.f, df=self.df, dft=self.dft,
            upstate=self.upstate, m0=self.m0, state=self._state,
            perfstat=self.perfstat_fn, close=self.close_fn,
        )
        cfg.update(kw)
        return Jet(**cfg)

    # -- linearization point (reference point!/point, :297-301) -------------
    def at(self, m0) -> "Jet":
        """Return a new jet pinned at ``m0``; runs the ``upstate`` hook."""
        s = self._state
        if self.upstate is not None:
            s = {**s, **self.upstate(m0, dict(s))}
        return self.replace(m0=m0, state=s)

    # -- kernels -----------------------------------------------------------
    def apply_f(self, m):
        return self.f(m, dict(self._state))

    def apply_df(self, dm):
        return self.df(dm, self.m0, dict(self._state))

    def apply_dft(self, dd):
        dft = self.dft
        if dft is not None:
            return dft(dd, self.m0, dict(self._state))
        return self._transpose_apply(dd)

    def _transpose_apply(self, dd):
        """Adjoint derived from ``df`` via linear transpose.

        For complex spaces the adjoint is the conjugate transpose:
        ``A^H d = conj(A^T conj(d))``.
        """
        m0, st = self.m0, dict(self._state)
        primal = self.dom.shape_dtype()
        lin = lambda dm: self.df(dm, m0, st)
        complex_dom = jnp.issubdtype(self.dom.dtype, jnp.complexfloating)
        complex_rng = jnp.issubdtype(self.rng.dtype, jnp.complexfloating)
        tfun = jax.linear_transpose(lin, primal)
        d_in = jnp.conj(dd) if complex_rng else dd
        (out,) = tfun(d_in)
        return jnp.conj(out) if complex_dom else out

    def __repr__(self) -> str:
        kind = "linear" if self.f is getattr(self.df, "__wrapped_df__", None) else "jet"
        return f"Jet({self.dom} -> {self.rng})"


def _linear_forward_from_df(df):
    def f(m, state, __df=df):
        return __df(m, None, state)

    f.__wrapped_df__ = df
    return f


def _tangent_from_linear_f(f):
    def df(dm, m0, state, __f=f):
        return __f(dm, state)

    df.__wrapped_f__ = f  # derivation marker (see parallel/hetero grouping)
    return df


def _self_adjoint_from_df(df):
    def dft(dd, m0, state, __df=df):
        return __df(dd, m0, state)

    dft.__self_adjoint_from__ = df
    return dft


# ---------------------------------------------------------------------------
# Operator wrappers (reference JopNl/JopLn/JopAdjoint, src/Jets.jl:194-403)
# ---------------------------------------------------------------------------


class Operator:
    """A (possibly nonlinear) operator wrapping a jet — reference ``JopNl``.

    Apply with ``A(m)`` or ``A @ m``. ``A @ B`` composes when ``B`` is an
    operator (see ``algebra.py``). ``jacobian(A, m0)`` returns a pinned
    :class:`LinearOperator`.
    """

    __slots__ = ("jet",)

    def __init__(self, jet: Jet):
        object.__setattr__(self, "jet", jet)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError(f"{type(self).__name__} is immutable")

    # -- spaces ------------------------------------------------------------
    @property
    def dom(self) -> Space:
        return self.jet.dom

    @property
    def rng(self) -> Space:
        return self.jet.rng

    # reference domain/range/shape/size (:325-345)
    @property
    def domain(self) -> Space:
        return self.dom

    @property
    def range(self) -> Space:
        return self.rng

    @property
    def shape(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return (self.rng.shape, self.dom.shape)

    @property
    def size(self) -> Tuple[int, int]:
        return (self.rng.size, self.dom.size)

    @property
    def state(self) -> Dict[str, Any]:
        return self.jet.state

    # -- application -------------------------------------------------------
    def __call__(self, m):
        return self.jet.apply_f(m)

    def _compose_or_apply(self, other):
        """``A @ B`` composes when ``B`` is an operator; a raw 2-D array that
        is NOT a member of the domain is auto-wrapped into a matrix operator
        and composed (reference matrix interop, src/Jets.jl:573-576);
        anything shaped like a domain member is applied."""
        from . import algebra

        if isinstance(other, Operator):
            return algebra.compose(self, other)
        shp = getattr(other, "shape", None)
        if shp is not None and tuple(shp) != self.dom.shape and len(shp) == 2:
            return algebra.compose(self, algebra._wrap(jnp.asarray(other)))
        return self(other)

    def __matmul__(self, other):
        return self._compose_or_apply(other)

    def __mul__(self, other):
        from . import algebra

        if jnp.isscalar(other) or isinstance(other, (int, float, complex)):
            return algebra.scale(other, self)
        return self._compose_or_apply(other)

    def __rmul__(self, a):
        from . import algebra

        if jnp.isscalar(a) or isinstance(a, (int, float, complex)):
            return algebra.scale(a, self)
        return NotImplemented

    def __add__(self, other):
        from . import algebra

        return algebra.add(self, other)

    def __sub__(self, other):
        from . import algebra

        return algebra.subtract(self, other)

    def __neg__(self):
        from . import algebra

        return algebra.scale(-1.0, self)

    # -- linearization -----------------------------------------------------
    def linearize(self, m0) -> "LinearOperator":
        """Pin at ``m0`` → linear operator (reference ``jacobian``, :374-375).

        Always functional: returns an independent new operator (the
        reference's aliasing ``jacobian!`` has no counterpart here).
        """
        return LinearOperator(self.jet.at(m0))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.dom} -> {self.rng})"


class LinearOperator(Operator):
    """Linear operator, possibly pinned at a linearization point ``m0`` —
    reference ``JopLn`` (``src/Jets.jl:209-224``).

    Application routes through the *tangent* kernel ``df`` at ``m0``;
    ``A.H`` / ``adjoint(A)`` gives the lazy adjoint (O(1), reference
    ``src/Jets.jl:382-383``).
    """

    def __call__(self, m):
        return self.jet.apply_df(m)

    @property
    def H(self) -> "AdjointOperator":
        return AdjointOperator(self)

    @property
    def T(self) -> "AdjointOperator":
        # For real spaces adjoint == transpose.
        return self.H

    def adjoint_apply(self, d):
        return self.jet.apply_dft(d)

    def linearize(self, m0) -> "LinearOperator":
        # Linearizing a linear operator is itself (reference JopLn jacobian).
        return self


class AdjointOperator(LinearOperator):
    """Lazy adjoint wrapper — reference ``JopAdjoint`` (``src/Jets.jl:226-228``).

    Domain and range swap (``src/Jets.jl:322-323``); ``adjoint`` is involutive
    (``src/Jets.jl:383``).
    """

    __slots__ = ("op",)

    def __init__(self, op: LinearOperator):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "jet", op.jet)

    @property
    def dom(self) -> Space:
        return self.op.rng

    @property
    def rng(self) -> Space:
        return self.op.dom

    def __call__(self, d):
        return self.op.adjoint_apply(d)

    def adjoint_apply(self, m):
        return self.op(m)

    @property
    def H(self) -> LinearOperator:
        return self.op  # involutive unwrap

    def __repr__(self) -> str:
        return f"Adjoint({self.op!r})"


# ---------------------------------------------------------------------------
# Free-function verbs (parity with the reference's module-level API)
# ---------------------------------------------------------------------------


def jet_of(op: Operator) -> Jet:
    """Reference ``jet(A)``."""
    return op.jet


def point(op: Operator):
    """Reference ``point(A)`` — the pinned linearization point (or None)."""
    return op.jet.m0


def linearize(F: Operator, m0) -> LinearOperator:
    """Pin ``F`` at ``m0`` (functional ``jacobian``)."""
    return F.linearize(m0)


def jacobian(F: Operator, m0) -> LinearOperator:
    """Alias of :func:`linearize` — reference ``jacobian`` (:374-375)."""
    return F.linearize(m0)


def adjoint(A: LinearOperator) -> LinearOperator:
    return A.H


def state(op: Operator, key: Optional[str] = None):
    """Reference ``state(A[, key])`` (:264-272, composite lookup :607-623)."""
    s = op.jet.state
    if key is None:
        return s
    if key in s:
        return s[key]
    # search child operators (composite/sum/block state bags)
    hits = []
    for v in s.values():
        ops = v if isinstance(v, (tuple, list)) else [v]
        for child in ops:
            if isinstance(child, Operator):
                try:
                    hits.append(state(child, key))
                except KeyError:
                    pass
    if not hits:
        raise KeyError(key)
    if len(hits) > 1:
        raise KeyError(f"state key {key!r} is ambiguous across child operators")
    return hits[0]


def with_state(op: Operator, **updates) -> Operator:
    """Functional ``state!`` — returns a new operator with merged state
    (reference merge semantics, ``src/Jets.jl:272``)."""
    new_jet = op.jet.replace(state={**op.jet._state, **updates})
    if isinstance(op, AdjointOperator):
        return AdjointOperator(type(op.op)(new_jet))
    return type(op)(new_jet)


def perfstat(op: Operator):
    """Per-operator perf metrics hook (reference ``perfstat``, :281).

    Combinators search children for the first non-None stat
    (reference :597-605, :723-731)."""
    j = op.jet
    if j.perfstat_fn is not None:
        return j.perfstat_fn(j)
    for v in j.state.values():
        ops = v if isinstance(v, (tuple, list)) else [v]
        for child in ops:
            if isinstance(child, Operator):
                s = perfstat(child)
                if s is not None:
                    return s
    return None


def close(op: Operator) -> None:
    """Release external resources held by an operator, recursing through
    combinator children (reference ``close``, :290, :591-595, :717-721,
    :1120-1124)."""
    j = op.jet
    if j.close_fn is not None:
        j.close_fn(j)
    for v in j.state.values():
        ops = v if isinstance(v, (tuple, list)) else [v]
        for child in ops:
            if isinstance(child, Operator):
                close(child)


# ---------------------------------------------------------------------------
# Pytree registration: operators pass through jit/vmap/shard_map.
# Arrays in (m0, dynamic state) are leaves; everything else is aux.
# ---------------------------------------------------------------------------


def _jet_flatten(j: Jet):
    dyn, sta = _split_state(j._state)
    keys = tuple(sorted(dyn))
    children = (j.m0, tuple(dyn[k] for k in keys))
    aux = (j.dom, j.rng, j.f, j.df, j.dft, j.upstate, keys, sta,
           j.perfstat_fn, j.close_fn)
    return children, aux


def _jet_unflatten(aux, children):
    dom, rng, f, df, dft, upstate, keys, sta, pstat, closef = aux
    m0, dynvals = children
    s = dict(zip(keys, dynvals))
    s.update(dict(sta))
    return Jet(dom=dom, rng=rng, f=f, df=df, dft=dft, upstate=upstate,
               m0=m0, state=s, perfstat=pstat, close=closef)


jax.tree_util.register_pytree_node(Jet, _jet_flatten, _jet_unflatten)


def _op_flatten(op):
    return (op.jet,), None


for _cls in (Operator, LinearOperator):
    jax.tree_util.register_pytree_node(
        _cls,
        _op_flatten,
        lambda aux, children, _cls=_cls: _cls(children[0]),
    )


def _adj_flatten(op: AdjointOperator):
    return (op.op,), None


def _adj_unflatten(aux, children):
    return AdjointOperator(children[0])


jax.tree_util.register_pytree_node(AdjointOperator, _adj_flatten, _adj_unflatten)
