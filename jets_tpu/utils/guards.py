"""Numerical sanity guards — the framework's "sanitizer" layer.

The reference has no race detection or sanitizers (single-threaded pure
Julia; SURVEY §5) — correctness is guarded mathematically by the gates. In
a compiled, asynchronous accelerator setting a NaN born inside a jitted Krylov loop
silently poisons everything downstream, so we add an explicit guard layer:

* :func:`checked` wraps any operator so every apply/adjoint validates its
  output for NaN/Inf via ``jax.experimental.checkify`` (errors surface at
  the jit boundary with the operator's name);
* :func:`assert_finite` validates any pytree eagerly (host-side).

Wrap operators with ``checked`` in debugging runs; production runs use the
raw operators (zero overhead).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..core.jet import Jet, LinearOperator, Operator

__all__ = ["checked", "assert_finite"]


def assert_finite(tree, name: str = "value") -> None:
    """Host-side finiteness check of every leaf (eager; forces transfer)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = jax.device_get(leaf)
        if not jnp.isfinite(jnp.asarray(a)).all():
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)} contains NaN/Inf"
            )


def _check(x, tag):
    def per_leaf(leaf):
        checkify.check(
            jnp.isfinite(leaf).all(), f"non-finite output of {tag}"
        )
        return leaf

    return jax.tree_util.tree_map(per_leaf, x)


def checked(op: Operator, name: str = "operator") -> Operator:
    """Return an operator whose forward/tangent/adjoint outputs are checked
    for NaN/Inf. Run the enclosing jit under ``checkify.checkify`` to
    surface the error, e.g.::

        err, out = checkify.checkify(lambda: checked(A, "A")(m))()
        err.throw()
    """
    j = op.jet

    def f(m, state, __f=j.f):
        return _check(__f(m, state), f"{name}.forward")

    def df(dm, m0, state, __df=j.df):
        return _check(__df(dm, m0, state), f"{name}.tangent")

    dft = j.dft
    if dft is not None and not isinstance(dft, str):
        _dft = dft

        def dft(dd, m0, state, __dft=_dft):
            return _check(__dft(dd, m0, state), f"{name}.adjoint")

    new_jet = Jet(
        dom=j.dom, rng=j.rng, f=f, df=df, dft=dft, upstate=j.upstate,
        m0=j.m0, state=j.state, perfstat=j.perfstat_fn, close=j.close_fn,
    )
    from ..core.jet import AdjointOperator

    if isinstance(op, AdjointOperator):
        raise TypeError("wrap the underlying operator, not its adjoint")
    return type(op)(new_jet)
