"""Nonlinear first-order solvers — NLCG and L-BFGS as ``lax.while_loop``
XLA programs.

The reference family solves nonlinear inversion (FWI) with an outer
linearize-and-Krylov loop (see ``gauss_newton.py``); production COFII
workflows equally use gradient-based nonlinear optimization on
``phi(m) = 1/2 ||F(m) - d||^2``. These are the JAX versions:

* the WHOLE optimization — line searches included — is one compiled
  ``lax.while_loop``; no host round-trips per iteration;
* gradients of the least-squares objective come from the framework's
  adjoint machinery (``g = J(m)^H r`` via ``linearize`` + adjoint tangent),
  not from autodiff through the forward propagator — same structure the
  reference family uses (adjoint-state method), and it honors hand-written
  adjoints;
* L-BFGS memory is a fixed-size ring buffer of stacked raveled pairs
  (``mem × n`` arrays) — static shapes, ``lax.fori_loop`` two-loop
  recursion, matmul-friendly;
* line search is backtracking Armijo (nested ``while_loop``, capped
  halvings), monotone and NaN-safe at exact minima.

State is an explicit NamedTuple pytree — checkpoint/resume like the Krylov
solvers (SURVEY §5).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.flatten_util import ravel_pytree

from ..core.jet import Operator, adjoint, linearize
from ..utils import tree as tr

__all__ = [
    "nlcg",
    "lbfgs",
    "least_squares_objective",
    "NLCGState",
    "LBFGSState",
    "OptResult",
]


def least_squares_objective(F: Operator, d) -> Callable:
    """Return ``fg(m) -> (phi, grad)`` for ``phi = 1/2 ||F(m) - d||^2`` with
    the gradient computed by the adjoint-state route ``g = J(m)^H r``
    (framework adjoints, not autodiff through the propagator)."""

    def fg(m):
        r = tr.sub(F(m), d)
        phi = 0.5 * jnp.real(F.rng.dot(r, r))
        J = linearize(F, m)
        g = adjoint(J)(r)
        return phi, g

    return fg


class OptResult(NamedTuple):
    m: Any
    iterations: jax.Array
    phi: jax.Array
    gnorm: jax.Array
    history: jax.Array  # phi per iteration (inf-padded)
    state: Any


def _dot(x, y):
    xf, _ = ravel_pytree(x)
    yf, _ = ravel_pytree(y)
    return jnp.real(jnp.vdot(xf, yf))


def _norm(x):
    return jnp.sqrt(_dot(x, x))


def _make_proj(bounds):
    """Box-constraint machinery from ``bounds = (lo, hi)`` — each side is
    ``None`` (unbounded), a scalar (applied to every leaf), or a pytree
    congruent with the model (per-leaf bounds, e.g. a BlockVector bounding
    only the velocity block). Returns ``(proj, pgrad)`` where ``proj``
    clips onto the box and ``pgrad`` masks gradient components that point
    out of the box at active constraints; ``None`` for unconstrained
    problems so the solvers keep their exact unconstrained trace."""
    if bounds is None:
        return None
    lo, hi = bounds
    if lo is None and hi is None:
        return None

    def _leafwise(f, b, *trees):
        """Map ``f(leaf..., bound_leaf)`` with ``b`` either congruent with
        the model pytree (per-leaf bounds) or broadcast to every leaf."""
        try:
            congruent = (jax.tree_util.tree_structure(b)
                         == jax.tree_util.tree_structure(trees[0]))
        except Exception:
            congruent = False
        if congruent:
            return tr.tmap(f, *trees, b)
        return tr.tmap(lambda *xs: f(*xs, b), *trees)

    def proj(m):
        if lo is not None:
            m = _leafwise(jnp.maximum, lo, m)
        if hi is not None:
            m = _leafwise(jnp.minimum, hi, m)
        return m

    def pgrad(m, g):
        """Active-set projected gradient: at an active lower bound only
        components that keep the point feasible (g <= 0, since the step is
        ``-g``) survive; symmetrically at the upper bound. This measures
        first-order optimality WITHOUT forming ``m - g`` (whose projection
        underflows in f32 whenever ``|g| << ulp(|m|)`` — exactly the FWI
        regime: velocity ~1.5e3, gradient ~1e-16)."""
        if lo is not None:
            g = _leafwise(
                lambda gg, x, b: jnp.where(x <= b, jnp.minimum(gg, 0), gg),
                lo, g, m)
        if hi is not None:
            g = _leafwise(
                lambda gg, x, b: jnp.where(x >= b, jnp.maximum(gg, 0), gg),
                hi, g, m)
        return g

    return proj, pgrad


def _pgnorm(m, g, proj):
    """Projected-gradient norm — the first-order optimality measure for box
    constraints (reduces exactly to ``||g||`` when unconstrained)."""
    if proj is None:
        return _norm(g)
    _, pgrad = proj
    return _norm(pgrad(m, g))


def _armijo(fg, m, phi, g, p, alpha0, *, c1, ls_max, proj=None):
    """Backtracking line search: largest ``alpha0 / 2^k`` (k < ls_max)
    satisfying ``phi(m + a p) <= phi + c1 a <g,p>``. Returns
    ``(m_new, phi_new, g_new, alpha, ok)``. If every trial fails, the
    original point is kept and ``ok=False`` — callers must reseed their
    step size rather than trust ``alpha``. With ``proj`` the trial point
    is projected onto the box and the sufficient-decrease term becomes
    ``c1 <g, P(m + a p) - m>`` (projected-backtracking, Bertsekas)."""
    gTp = _dot(g, p)

    def cond(c):
        alpha, k, done, *_ = c
        return (~done) & (k < ls_max)

    def body(c):
        alpha, k, _done, _m, _phi, _g = c
        m_try = tr.xpay(m, alpha, p)
        if proj is not None:
            m_try = proj(m_try)
            # Bertsekas decrease term c1·<g, P(m+αp)−m>. For p = −g it is
            # always ≤ 0, but for NLCG/L-BFGS directions it can turn
            # POSITIVE at active constraints (the projection bends the step
            # toward +g), which would accept a trial with a higher
            # objective. Clamp at 0 so acceptance always requires
            # non-increase (ADVICE r3).
            dec = jnp.minimum(c1 * _dot(g, tr.sub(m_try, m)), 0.0)
        else:
            dec = c1 * alpha * gTp
        phi_try, g_try = fg(m_try)
        ok = phi_try <= phi + dec
        return (
            jnp.where(ok, alpha, 0.5 * alpha),
            k + 1,
            ok,
            tr.tmap(lambda a, b: jnp.where(ok, a, b), m_try, _m),
            jnp.where(ok, phi_try, _phi),
            tr.tmap(lambda a, b: jnp.where(ok, a, b), g_try, _g),
        )

    alpha, _k, done, m_new, phi_new, g_new = lax.while_loop(
        cond, body, (alpha0, 0, False, m, phi, g)
    )
    return m_new, phi_new, g_new, alpha, done


class NLCGState(NamedTuple):
    m: Any
    phi: jax.Array
    g: Any
    p: Any
    alpha: jax.Array
    g0norm: jax.Array  # ||grad|| at the ORIGINAL start — stable across resume
    i: jax.Array


@partial(jax.jit, static_argnames=("fg", "maxiter", "ls_max"))
def nlcg(
    fg: Callable,
    m0,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    ls_max: int = 25,
    c1: float = 1e-4,
    bounds=None,
    state: NLCGState = None,
) -> OptResult:
    """Nonlinear conjugate gradients (Polak–Ribière+ with automatic restart
    to steepest descent when the PR beta goes negative or the direction
    loses descent). ``bounds=(lo, hi)`` switches to the projected variant
    (trial points clipped onto the box, projected-gradient stopping rule) —
    the velocity-bound constraint of production FWI."""
    pb = _make_proj(bounds)
    proj = None if pb is None else pb[0]
    if state is None:
        if proj is not None:
            m0 = proj(m0)
        phi0, g0 = fg(m0)
        st = NLCGState(
            m0, phi0, g0, tr.scale(-1.0, g0),
            1.0 / jnp.maximum(_norm(g0), 1e-30),
            _pgnorm(m0, g0, pb), jnp.asarray(0),
        )
    else:
        st = state
    # relative-tolerance baseline travels WITH the state, so a resumed run
    # continues the original stopping criterion instead of demanding a
    # further tol-factor reduction from wherever it resumed
    g0norm = st.g0norm
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=st.phi.dtype)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (_pgnorm(st.m, st.g, pb) > tol * g0norm)

    def body(carry):
        st, hist = carry
        # ensure descent: restart along -g if <g,p> >= 0
        gTp = _dot(st.g, st.p)
        p = tr.tmap(
            lambda pp, gg: jnp.where(gTp < 0, pp, -gg), st.p, st.g
        )
        m, phi, g, alpha, ok = _armijo(
            fg, st.m, st.phi, st.g, p,
            jnp.maximum(st.alpha, 1e-30) * 2.0, c1=c1, ls_max=ls_max,
            proj=proj,
        )
        # a fully-failed search keeps the point; reseed the step from the
        # gradient scale instead of letting alpha collapse toward 0
        alpha = jnp.where(
            ok, alpha, 1.0 / jnp.maximum(_norm(g), 1e-30)
        )
        # Polak–Ribière+ beta with restart floor at 0
        y = tr.sub(g, st.g)
        denom = jnp.maximum(_dot(st.g, st.g), 1e-30)
        beta = jnp.maximum(_dot(g, y) / denom, 0.0)
        p_new = tr.tmap(lambda gg, pp: -gg + beta * pp, g, p)
        hist = hist.at[st.i].set(phi)
        return NLCGState(m, phi, g, p_new, alpha, st.g0norm, st.i + 1), hist

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return OptResult(st.m, st.i, st.phi, _pgnorm(st.m, st.g, pb), hist, st)


class LBFGSState(NamedTuple):
    m: Any
    phi: jax.Array
    g: Any
    S: jax.Array  # (mem, n) model-step ring buffer
    Y: jax.Array  # (mem, n) gradient-step ring buffer
    rho: jax.Array  # (mem,) 1/<y,s>
    head: jax.Array  # next write slot
    count: jax.Array  # filled slots (<= mem)
    alpha: jax.Array
    g0norm: jax.Array  # ||grad|| at the ORIGINAL start — stable across resume
    i: jax.Array


@partial(jax.jit, static_argnames=("fg", "maxiter", "mem", "ls_max"))
def lbfgs(
    fg: Callable,
    m0,
    *,
    maxiter: int = 100,
    mem: int = 10,
    tol: float = 1e-6,
    ls_max: int = 25,
    c1: float = 1e-4,
    bounds=None,
    state: LBFGSState = None,
) -> OptResult:
    """Limited-memory BFGS with two-loop recursion over a fixed ``mem``-pair
    ring buffer and backtracking Armijo line search, all inside one
    ``lax.while_loop``. ``bounds=(lo, hi)`` switches to the projected
    variant (each side ``None`` | scalar | model-congruent pytree — e.g.
    bound only the velocity block of a BlockVector model)."""
    pb = _make_proj(bounds)
    proj = None if pb is None else pb[0]
    if state is None:
        if proj is not None:
            m0 = proj(m0)
        phi0, g0 = fg(m0)  # single trace of the objective graph
    else:
        g0 = state.g
    gflat0, unravel = ravel_pytree(g0)
    n = gflat0.shape[0]
    dt = gflat0.dtype
    if state is None:
        st = LBFGSState(
            m0, phi0, g0,
            jnp.zeros((mem, n), dt), jnp.zeros((mem, n), dt),
            jnp.zeros((mem,), dt),
            jnp.asarray(0), jnp.asarray(0), jnp.asarray(1.0, dt),
            _pgnorm(m0, g0, pb), jnp.asarray(0),
        )
    else:
        st = state
    g0norm = st.g0norm  # original baseline, stable across resume
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=st.phi.dtype)

    def two_loop(g, S, Y, rho, head, count):
        """H g via the standard two-loop recursion; slot order newest-first
        through the ring buffer."""
        q = ravel_pytree(g)[0]

        def slot(j):
            # j = 0 is newest: slot index (head - 1 - j) mod mem
            return jnp.mod(head - 1 - j, mem)

        def bwd(j, carry):
            q, a = carry
            k = slot(j)
            valid = j < count
            aj = jnp.where(valid, rho[k] * jnp.dot(S[k], q), 0.0)
            q = q - aj * Y[k]
            return q, a.at[k].set(aj)

        q, a = lax.fori_loop(0, mem, bwd, (q, jnp.zeros((mem,), dt)))
        # initial Hessian scale gamma = <s,y>/<y,y> of the newest pair
        k_new = slot(0)
        yy = jnp.dot(Y[k_new], Y[k_new])
        gamma = jnp.where(
            (count > 0) & (yy > 0),
            (1.0 / jnp.maximum(rho[k_new], 1e-30)) / jnp.maximum(yy, 1e-30),
            1.0,
        )
        r = gamma * q

        def fwd(j, r):
            # oldest-first: j = 0 is oldest stored pair
            k = slot(count - 1 - j)
            valid = j < count
            b = jnp.where(valid, rho[k] * jnp.dot(Y[k], r), 0.0)
            return r + jnp.where(valid, (a[k] - b), 0.0) * S[k]

        r = lax.fori_loop(0, mem, fwd, r)
        return unravel(r)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (_pgnorm(st.m, st.g, pb) > tol * g0norm)

    def body(carry):
        st, hist = carry
        Hg = two_loop(st.g, st.S, st.Y, st.rho, st.head, st.count)
        p = tr.scale(-1.0, Hg)
        gTp = _dot(st.g, p)
        # safeguard: fall back to steepest descent if not a descent dir
        p = tr.tmap(lambda pp, gg: jnp.where(gTp < 0, pp, -gg), p, st.g)
        alpha0 = jnp.where(st.count > 0, jnp.asarray(1.0, st.alpha.dtype),
                           1.0 / jnp.maximum(_norm(st.g), 1e-30))
        m, phi, g, alpha, _ok = _armijo(
            fg, st.m, st.phi, st.g, p, alpha0, c1=c1, ls_max=ls_max,
            proj=proj,
        )
        s_f = ravel_pytree(tr.sub(m, st.m))[0]
        y_f = ravel_pytree(tr.sub(g, st.g))[0]
        sy = jnp.dot(s_f, y_f)
        accept = sy > 1e-12 * jnp.maximum(
            jnp.linalg.norm(s_f) * jnp.linalg.norm(y_f), 1e-30
        )
        S = jnp.where(accept, st.S.at[st.head].set(s_f), st.S)
        Y = jnp.where(accept, st.Y.at[st.head].set(y_f), st.Y)
        rho = jnp.where(
            accept,
            st.rho.at[st.head].set(1.0 / jnp.where(accept, sy, 1.0)),
            st.rho,
        )
        head = jnp.where(accept, jnp.mod(st.head + 1, mem), st.head)
        count = jnp.where(accept, jnp.minimum(st.count + 1, mem), st.count)
        hist = hist.at[st.i].set(phi)
        return (
            LBFGSState(
                m, phi, g, S, Y, rho, head, count, alpha, st.g0norm,
                st.i + 1,
            ),
            hist,
        )

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return OptResult(st.m, st.i, st.phi, _pgnorm(st.m, st.g, pb), hist, st)
