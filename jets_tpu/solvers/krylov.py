"""Krylov solvers — CG, CGLS, LSQR as ``lax.while_loop`` XLA programs.

The reference has no in-repo solvers; its canonical solve is
``lsqr(vec(A), vec(d))`` through IterativeSolvers.jl (docs
``docs/src/index.md:238-246``, ``vec`` bridge ``src/Jets.jl:1143-1152``).
Here solvers are first-class XLA programs:

* each iteration is a traced loop body — two operator applications plus a
  handful of fused BLAS-1 reductions — compiled once by XLA;
* solvers consume operators *directly* (operators are pytrees); no ``vec``
  adapter is needed because model/data vectors are pytrees (arrays or
  :class:`BlockVector`), and inner products are delegated to the operator's
  spaces so block/symmetric weighting is automatic;
* on a sharded block operator the space reductions become ``psum``-backed
  collectives (see ``jets_tpu/parallel``) and the same solver code runs
  on several devices: **the solver is oblivious to distribution**;
* solver state is an explicit, checkpointable pytree: every solver takes an
  optional ``state`` to resume from and returns its final state
  (SURVEY §5 — checkpoint/resume of Krylov recurrence vectors).

Stopping: iterations cap at ``maxiter`` (static, sizes the residual-history
buffer) or when the residual estimate drops below ``tol * ||b||``. Residual
histories are fixed-size arrays written with ``.at[i].set`` — XLA-friendly,
no host callbacks in the hot loop.
"""
from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.jet import LinearOperator
from ..utils import tree as tr

__all__ = ["cg", "cgls", "lsqr", "lsmr", "minres", "gmres", "bicgstab", "chebyshev", "estimate_spectral_bounds", "CGState", "CGLSState", "LSQRState", "LSMRState", "MINRESState", "GMRESState", "BiCGStabState", "ChebyshevState"]


def _real(x):
    return jnp.real(x)


def _normalize(space, vct):
    """Return (vct/‖vct‖, ‖vct‖) with a safe division at exact zero."""
    n = space.norm(vct)
    safe = jnp.where(n > 0, n, 1.0)
    return tr.scale(1.0 / safe, vct), n


def _sym_ortho(a, bb):
    """Stable Givens rotation (c, s, r) with the (0, 0) -> (1, 0, 0)
    convention so recurrences stay NaN-free after exact convergence
    (alpha/beta collapse to 0 once the Krylov space is exhausted)."""
    r = jnp.sqrt(a**2 + bb**2)
    rsafe = jnp.where(r > 0, r, 1.0)
    c = jnp.where(r > 0, a / rsafe, 1.0)
    s = jnp.where(r > 0, bb / rsafe, 0.0)
    return c, s, r


# ---------------------------------------------------------------------------
# CG — Hermitian positive-definite systems A x = b
# ---------------------------------------------------------------------------


class CGState(NamedTuple):
    x: Any
    r: Any
    p: Any
    rho: jax.Array
    rnorm: jax.Array  # carried so cond() costs no extra reduction
    i: jax.Array


class SolveResult(NamedTuple):
    x: Any
    iterations: jax.Array
    resnorm: jax.Array
    history: jax.Array  # residual-norm estimate per iteration (inf-padded)
    state: Any  # final solver state — pass back via ``state=`` to resume


@partial(jax.jit, static_argnames=("maxiter",))
def cg(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    M: Optional[LinearOperator] = None,
    state: Optional[CGState] = None,
) -> SolveResult:
    """(Preconditioned) conjugate gradients on a Hermitian positive-definite
    operator.

    ``A`` must be self-adjoint on its space; this is exactly what the
    dot-product gate (``verify.dot_product_test``) certifies. ``M`` is an
    optional SPD preconditioner applying the approximate INVERSE of ``A``
    (e.g. a diagonal/Jacobi operator); with ``M`` set, ``rho`` tracks
    ``<r, M r>`` and the stopping test still uses the true residual norm.

    Unpreconditioned bodies are memory-lean: ``rho = <r, r>`` IS the
    squared residual norm, so the stopping-test reduction folds away
    (prefer :func:`cgls` for least squares: the normal operator costs an
    extra pass)."""
    dom = A.dom
    bnorm = dom.norm(b)
    precond = (lambda r: M(r)) if M is not None else (lambda r: r)
    if state is None:
        x = dom.zeros() if x0 is None else x0
        r = tr.sub(b, A(x))
        z = precond(r)
        p = z
        rho = _real(dom.dot(r, z))
        st = CGState(x, r, p, rho, dom.norm(r), jnp.asarray(0))
    else:
        st = state
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=bnorm.dtype)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (st.rnorm > tol * bnorm)

    def body(carry):
        st, hist = carry
        q = A(st.p)
        pq = _real(dom.dot(st.p, q))
        alpha = jnp.where(pq > 0, st.rho / jnp.where(pq > 0, pq, 1.0), 0.0)
        if M is None:
            x = tr.xpay(st.x, alpha, st.p)
            r = tr.xpay(st.r, -alpha, q)
            rho_new = _real(dom.dot(r, r))
            beta = jnp.where(
                st.rho > 0, rho_new / jnp.where(st.rho > 0, st.rho, 1.0), 0.0
            )
            p = tr.xpay(r, beta, st.p)
            rnorm = jnp.sqrt(rho_new)
        else:
            x = tr.xpay(st.x, alpha, st.p)
            r = tr.xpay(st.r, -alpha, q)
            z = precond(r)
            rho_new = _real(dom.dot(r, z))
            beta = jnp.where(
                st.rho > 0, rho_new / jnp.where(st.rho > 0, st.rho, 1.0), 0.0
            )
            p = tr.xpay(z, beta, st.p)
            rnorm = dom.norm(r)
        hist = hist.at[st.i].set(rnorm)
        return CGState(x, r, p, rho_new, rnorm, st.i + 1), hist

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# CGLS — least squares min ||A x - b||, normal equations in stable form
# ---------------------------------------------------------------------------


class CGLSState(NamedTuple):
    x: Any
    r: Any  # data-space residual b - A x
    s: Any  # model-space gradient A' r
    p: Any
    gamma: jax.Array  # ||s||^2
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter",))
def cgls(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[CGLSState] = None,
) -> SolveResult:
    """CGLS: conjugate gradients on the normal equations without forming
    ``A'A`` — one forward and one adjoint application per iteration.

    Stops when ``||A' r||`` (the normal-equation residual) falls below
    ``tol * ||A' b||``.
    """
    dom, rng = A.dom, A.rng
    s_b = A.adjoint_apply(b)
    snorm0 = dom.norm(s_b)
    if state is None:
        if x0 is None:
            x = dom.zeros()
            r = b
            s = s_b
        else:
            x = x0
            r = tr.sub(b, A(x))
            s = A.adjoint_apply(r)
        gamma = _real(dom.dot(s, s))
        st = CGLSState(x, r, s, s, gamma, jnp.asarray(0))
    else:
        st = state
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=snorm0.dtype)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (jnp.sqrt(st.gamma) > tol * snorm0)

    def body(carry):
        st, hist = carry
        q = A(st.p)
        delta = _real(rng.dot(q, q))
        # guarded divisions: at exact convergence delta/gamma collapse to 0;
        # idle (alpha=beta=0) instead of poisoning the carry with NaN
        alpha = jnp.where(delta > 0, st.gamma / jnp.where(delta > 0, delta, 1.0), 0.0)
        x = tr.xpay(st.x, alpha, st.p)
        r = tr.xpay(st.r, -alpha, q)
        s = A.adjoint_apply(r)
        gamma_new = _real(dom.dot(s, s))
        beta = jnp.where(
            st.gamma > 0, gamma_new / jnp.where(st.gamma > 0, st.gamma, 1.0), 0.0
        )
        p = tr.xpay(s, beta, st.p)
        hist = hist.at[st.i].set(rng.norm(r))
        return CGLSState(x, r, s, p, gamma_new, st.i + 1), hist

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, rng.norm(st.r), hist, st)


# ---------------------------------------------------------------------------
# LSQR — Paige & Saunders Golub-Kahan bidiagonalization
# ---------------------------------------------------------------------------


class LSQRState(NamedTuple):
    x: Any
    u: Any  # data-space Lanczos vector
    v: Any  # model-space Lanczos vector
    w: Any  # search direction
    alpha: jax.Array
    phibar: jax.Array  # ||r|| estimate
    rhobar: jax.Array
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter",))
def lsqr(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    damp: float = 0.0,
    state: Optional[LSQRState] = None,
) -> SolveResult:
    """LSQR (Paige & Saunders 1982) for ``min ||A x - b||^2 + damp^2 ||x||^2``.

    One forward and one adjoint application per iteration; the Golub-Kahan
    recurrence scalars are fused reductions, so a distributed block operator
    costs exactly two collective rounds per iteration. ``phibar`` tracks the
    residual norm without ever forming ``r``.

    Memory-lean recurrence: the model-space Lanczos vector is kept
    UNNORMALIZED in ``state.v`` (``‖v‖ = state.alpha``; the mathematical
    ``v`` is ``state.v / alpha``) and the ``1/alpha`` factors fold into the
    recurrence scalars, removing the explicit model-vector scale pass.
    Scalar recurrences are identical to the textbook form.
    """
    dom, rng = A.dom, A.rng

    if state is None:
        if x0 is None:
            x = dom.zeros()
            r0 = b
        else:
            x = x0
            r0 = tr.sub(b, A(x))
        u, beta = _normalize(rng, r0)
        v_hat = A.adjoint_apply(u)  # unnormalized; ‖v_hat‖ = alpha
        alpha = dom.norm(v_hat)
        a_safe = jnp.where(alpha > 0, alpha, 1.0)
        w = tr.scale(1.0 / a_safe, v_hat)
        st = LSQRState(x, u, v_hat, w, alpha, beta, alpha, jnp.asarray(0))
    else:
        st = state
    # stopping baseline is ALWAYS ||b|| (the scipy/standard convention), so
    # a resumed run continues the exact same criterion as a fresh one
    bnorm = rng.norm(b)
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=st.phibar.dtype)
    damp = jnp.asarray(damp, dtype=st.phibar.dtype)

    def cond(carry):
        st, _ = carry
        # phibar carries a sign through the rotations; only its magnitude is
        # the residual-norm estimate
        return (st.i < maxiter) & (jnp.abs(st.phibar) > tol * bnorm)

    def body(carry):
        st, hist = carry
        # bidiagonalization with v stored unnormalized (v_math = v/alpha):
        #   beta u' = A v_math - alpha u  →  A(v)/alpha - alpha u
        a_safe = jnp.where(st.alpha > 0, st.alpha, 1.0)
        u_next = tr.axpy(
            -st.alpha, st.u, tr.scale(1.0 / a_safe, A(st.v))
        )  # data-space scale: cheap
        u_next, beta = _normalize(rng, u_next)
        #   alpha' v_math' = A' u' - beta v_math  →  v' = A'u' - (beta/alpha) v
        v_hat = tr.axpy(-beta / a_safe, st.v, A.adjoint_apply(u_next))
        alpha = dom.norm(v_hat)
        # eliminate damping (regularization) via an extra rotation
        c1, _, rhobar1 = _sym_ortho(st.rhobar, damp)
        phibar1 = c1 * st.phibar
        # plane rotation on the bidiagonal
        c, s, rho = _sym_ortho(rhobar1, beta)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1
        rho_safe = jnp.where(rho > 0, rho, 1.0)
        t1 = jnp.where(rho > 0, phi / rho_safe, 0.0)
        t2 = jnp.where(rho > 0, -theta / rho_safe, 0.0)
        # x' = x + t1 w and w' = v_hat/alpha' + t2 w — one two-output pass
        an_safe = jnp.where(alpha > 0, alpha, 1.0)
        inv_a = 1.0 / an_safe
        x = tr.xpay(st.x, t1, st.w)
        w = tr.tmap(lambda vh, ww: inv_a * vh + t2 * ww, v_hat, st.w)
        hist = hist.at[st.i].set(jnp.abs(phibar))
        return LSQRState(x, u_next, v_hat, w, alpha, phibar, rhobar, st.i + 1), hist

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, jnp.abs(st.phibar), hist, st)


# ---------------------------------------------------------------------------
# LSMR — Fong & Saunders (2011): MINRES applied to the normal equations via
# Golub-Kahan bidiagonalization. Monotonic in ||A'r||; the standard
# companion to LSQR (IterativeSolvers.jl ships both — the reference's docs
# route solves through that package, docs/src/index.md:238-246).
# ---------------------------------------------------------------------------


class LSMRState(NamedTuple):
    x: Any
    u: Any
    v: Any
    h: Any        # search direction
    hbar: Any     # second recurrence direction
    alpha: jax.Array
    alphabar: jax.Array
    zeta: jax.Array
    zetabar: jax.Array
    rho: jax.Array
    rhobar: jax.Array
    cbar: jax.Array
    sbar: jax.Array
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter",))
def lsmr(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    damp: float = 0.0,
    state: Optional[LSMRState] = None,
) -> SolveResult:
    """LSMR for ``min ||A x - b||^2 + damp^2 ||x||^2``.

    Same per-iteration cost as LSQR (one forward + one adjoint apply, fused
    scalar recurrences) but monotonically decreases ``||A' r||`` — often the
    better stopping behavior for ill-conditioned inversion. The history
    buffer records the ``||A' r||`` estimate ``|zetabar|``.

    Memory-lean recurrence (mirrors lsqr's): ``state.v`` holds the
    UNNORMALIZED Golub-Kahan vector (``‖v‖ = state.alpha``); the
    ``1/alpha`` factors fold into the update scalars so the explicit
    model-vector normalization pass disappears. LSMR carries one more
    model array than LSQR, so its per-iteration floor is higher."""
    dom, rng = A.dom, A.rng

    damp = jnp.asarray(damp)

    if state is None:
        if x0 is None:
            x = dom.zeros()
            r0 = b
        else:
            x = x0
            r0 = tr.sub(b, A(x))
        u, beta = _normalize(rng, r0)
        v_hat = A.adjoint_apply(u)  # unnormalized; ‖v_hat‖ = alpha
        alpha = dom.norm(v_hat)
        a_safe = jnp.where(alpha > 0, alpha, 1.0)
        h0 = tr.scale(1.0 / a_safe, v_hat)
        zetabar = alpha * beta
        st = LSMRState(
            x=x, u=u, v=v_hat, h=h0, hbar=tr.scale(0.0, h0),
            alpha=alpha, alphabar=alpha, zeta=jnp.zeros_like(alpha),
            zetabar=zetabar, rho=jnp.ones_like(alpha),
            rhobar=jnp.ones_like(alpha), cbar=jnp.ones_like(alpha),
            sbar=jnp.zeros_like(alpha), i=jnp.asarray(0),
        )
    else:
        st = state
    # stopping baseline recomputed identically on fresh AND resumed runs
    norm_atb = dom.norm(A.adjoint_apply(b))
    damp = damp.astype(st.zetabar.dtype)
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=st.zetabar.dtype)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (jnp.abs(st.zetabar) > tol * norm_atb)

    def body(carry):
        st, hist = carry
        # Golub-Kahan step, v stored unnormalized (v_math = v/alpha)
        a_safe = jnp.where(st.alpha > 0, st.alpha, 1.0)
        u_next = tr.axpy(-st.alpha, st.u, tr.scale(1.0 / a_safe, A(st.v)))
        u_next, beta = _normalize(rng, u_next)
        #   v' = A'u' - (beta/alpha) v ; alpha' = ‖v'‖
        v_next = tr.axpy(-beta / a_safe, st.v, A.adjoint_apply(u_next))
        alpha = dom.norm(v_next)
        # rotation eliminating damp
        chat, shat, alphahat = _sym_ortho(st.alphabar, damp)
        # rotation on the bidiagonal
        rho_old = st.rho
        c, s, rho = _sym_ortho(alphahat, beta)
        thetanew = s * alpha
        alphabar = c * alpha
        # second rotation (MINRES part)
        rhobar_old = st.rhobar
        thetabar = st.sbar * rho
        cbar_rho = st.cbar * rho
        cbar, sbar, rhobar = _sym_ortho(cbar_rho, thetanew)
        zeta = cbar * st.zetabar
        zetabar = -sbar * st.zetabar
        # update scalars (1/alpha' folded into the h recurrence)
        rho_s = jnp.where(rho_old > 0, rho_old, 1.0)
        rb_s = jnp.where(rhobar_old > 0, rhobar_old, 1.0)
        c_hb = -(thetabar * rho) / (rho_s * rb_s)
        rrb = jnp.where(rho * rhobar > 0, rho * rhobar, 1.0)
        c_x = zeta / rrb
        c_h = -(thetanew / jnp.where(rho > 0, rho, 1.0))
        inv_a = 1.0 / jnp.where(alpha > 0, alpha, 1.0)
        hbar = tr.tmap(lambda h_, hb: h_ + c_hb * hb, st.h, st.hbar)
        x = tr.xpay(st.x, c_x, hbar)
        h = tr.tmap(lambda vh, h_: inv_a * vh + c_h * h_, v_next, st.h)
        hist = hist.at[st.i].set(jnp.abs(zetabar))
        return (
            LSMRState(x=x, u=u_next, v=v_next, h=h, hbar=hbar, alpha=alpha,
                      alphabar=alphabar, zeta=zeta, zetabar=zetabar, rho=rho,
                      rhobar=rhobar, cbar=cbar, sbar=sbar, i=st.i + 1),
            hist,
        )

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, jnp.abs(st.zetabar), hist, st)


# ---------------------------------------------------------------------------
# MINRES — symmetric (possibly INDEFINITE) systems A x = b (Paige &
# Saunders 1975). Completes the Krylov family: CG needs positive definite;
# MINRES only needs self-adjoint (what the dot-product gate certifies).
# ---------------------------------------------------------------------------


class MINRESState(NamedTuple):
    x: Any
    v: Any  # current Lanczos vector (normalized)
    v_old: Any
    w1: Any  # previous two update directions
    w0: Any
    beta: jax.Array
    eta: jax.Array  # |eta| = current residual norm
    gamma1: jax.Array
    gamma0: jax.Array
    sigma1: jax.Array
    sigma0: jax.Array
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter",))
def minres(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[MINRESState] = None,
) -> SolveResult:
    """MINRES on a self-adjoint operator (definite OR indefinite): minimizes
    ``||A x - b||`` over the Krylov space — monotone residual, one operator
    application and one Lanczos three-term recurrence per iteration, fused
    Givens rotations."""
    dom = A.dom
    bnorm = dom.norm(b)

    def _safe(x):
        return jnp.where(x > 0, x, 1.0)

    if state is None:
        x = dom.zeros() if x0 is None else x0
        r = tr.sub(b, A(x)) if x0 is not None else b
        beta1 = dom.norm(r)
        v = tr.scale(1.0 / _safe(beta1), r)
        zero = tr.tmap(jnp.zeros_like, v)
        one = jnp.asarray(1.0, beta1.dtype)
        nul = jnp.asarray(0.0, beta1.dtype)
        st = MINRESState(
            x, v, zero, zero, zero,
            nul, beta1, one, one, nul, nul, jnp.asarray(0),
        )
    else:
        st = state

    hist0 = jnp.full((maxiter,), jnp.inf, dtype=st.eta.dtype)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (jnp.abs(st.eta) > tol * bnorm)

    def body(carry):
        st, hist = carry
        Av = A(st.v)
        alpha = _real(dom.dot(st.v, Av))
        v_next = tr.tmap(
            lambda av, vv, vo: av - alpha * vv - st.beta * vo,
            Av, st.v, st.v_old,
        )
        beta_next = dom.norm(v_next)
        v_next = tr.scale(1.0 / _safe(beta_next), v_next)
        # apply the two previous rotations to the new tridiagonal column
        delta = st.gamma1 * alpha - st.gamma0 * st.sigma1 * st.beta
        rho2 = st.sigma1 * alpha + st.gamma0 * st.gamma1 * st.beta
        rho3 = st.sigma0 * st.beta
        rho1 = jnp.sqrt(delta * delta + beta_next * beta_next)
        gamma = jnp.where(rho1 > 0, delta / _safe(rho1), 1.0)
        sigma = jnp.where(rho1 > 0, beta_next / _safe(rho1), 0.0)
        w_next = tr.tmap(
            lambda vv, w0, w1: (vv - rho3 * w0 - rho2 * w1) / _safe(rho1),
            st.v, st.w0, st.w1,
        )
        x = tr.xpay(st.x, gamma * st.eta, w_next)
        eta = -sigma * st.eta
        hist = hist.at[st.i].set(jnp.abs(eta))
        return (
            MINRESState(
                x, v_next, st.v, w_next, st.w1,
                beta_next, eta, gamma, st.gamma1, sigma, st.sigma1,
                st.i + 1,
            ),
            hist,
        )

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, jnp.abs(st.eta), hist, st)


# ---------------------------------------------------------------------------
# BiCGStab — square nonsymmetric systems, two applies per iteration
# ---------------------------------------------------------------------------


class BiCGStabState(NamedTuple):
    x: Any
    r: Any
    rhat: Any  # fixed shadow residual
    p: Any
    v: Any
    rho: jax.Array
    alpha: jax.Array
    omega: jax.Array
    rnorm: jax.Array
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter",))
def bicgstab(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    state: Optional[BiCGStabState] = None,
) -> SolveResult:
    """BiCGStab (van der Vorst) for a SQUARE, possibly nonsymmetric
    operator: adjoint-free — two forward applies per iteration, no ``A^H``
    needed (unlike CGLS/LSQR which solve the least-squares problem).
    Breakdown-safe: every division is guarded so the recurrence parks at
    the current iterate instead of producing NaNs, and the fatal Lanczos
    breakdown (``rho = <rhat, r> = 0`` with a nonzero residual) exits the
    loop immediately instead of burning the remaining iterations — detect
    it via ``result.iterations < maxiter`` with ``result.residual`` above
    tolerance. The milder ``<rhat, v> = 0`` breakdown parks ``alpha`` at
    zero for one step (the omega half-step may still progress); a flat
    tail in ``result.history`` is the signal to restart with a fresh
    shadow residual."""
    dom = A.dom

    def _sdiv(num, den):
        ok = jnp.abs(den) > 0
        return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)

    if state is None:
        x = dom.zeros() if x0 is None else x0
        r = tr.sub(b, A(x)) if x0 is not None else b
        zero = tr.tmap(jnp.zeros_like, r)
        # rho/alpha/omega live in the operator's field (rho = <rhat, r> is
        # complex for complex operators)
        one = jnp.ones((), dom.dtype)
        st = BiCGStabState(x, r, r, zero, zero, one, one, one,
                           dom.norm(r), jnp.asarray(0))
    else:
        st = state
    bnorm = dom.norm(b)
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=bnorm.dtype)

    def cond(carry):
        st, _ = carry
        # abs(rho) == 0 after the first iteration is the fatal breakdown:
        # every subsequent step would be a no-op (alpha = omega = 0), so
        # stop instead of spending 2 operator applies/iter on nothing
        return ((st.i < maxiter) & (st.rnorm > tol * bnorm)
                & (jnp.abs(st.rho) > 0))

    def body(carry):
        st, hist = carry
        rho_new = dom.dot(st.rhat, st.r)
        beta = _sdiv(rho_new * st.alpha, st.rho * st.omega)
        p = tr.tmap(
            lambda r_, p_, v_: r_ + beta * (p_ - st.omega * v_),
            st.r, st.p, st.v,
        )
        v = A(p)
        alpha = _sdiv(rho_new, dom.dot(st.rhat, v))
        s = tr.xpay(st.r, -alpha, v)
        t = A(s)
        omega = _sdiv(dom.dot(t, s), dom.dot(t, t))
        x = tr.tmap(lambda x_, p_, s_: x_ + alpha * p_ + omega * s_,
                    st.x, p, s)
        r = tr.xpay(s, -omega, t)
        rnorm = dom.norm(r)
        hist = hist.at[st.i].set(rnorm)
        return (
            BiCGStabState(x, r, st.rhat, p, v, rho_new, alpha, omega,
                          rnorm, st.i + 1),
            hist,
        )

    st, hist = lax.while_loop(cond, body, (st, hist0))
    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# GMRES(restart) — square nonsymmetric systems, minimal residual
# ---------------------------------------------------------------------------


class GMRESState(NamedTuple):
    x: Any
    rnorm: jax.Array
    i: jax.Array  # total inner iterations so far (restart-boundary resume)


def _stack_zeros(leaves, m):
    return tuple(jnp.zeros((m,) + l.shape, l.dtype) for l in leaves)


def _row(stack, k):
    return tuple(
        lax.dynamic_index_in_dim(s, k, 0, keepdims=False) for s in stack
    )


def _set_row(stack, k, leaves):
    return tuple(
        lax.dynamic_update_index_in_dim(s, l, k, 0)
        for s, l in zip(stack, leaves)
    )


def _dot_all(stack, leaves):
    """<V_k, w> for ALL k at once: one fused batched reduction per leaf
    (classical Gram-Schmidt — no sequential dot chain).
    Conjugate-linear in the basis (complex-correct projection)."""
    parts = [
        jnp.tensordot(jnp.conj(s), l, axes=(tuple(range(1, s.ndim)),
                                            tuple(range(l.ndim))))
        for s, l in zip(stack, leaves)
    ]
    return sum(parts)


def _cgivens(f, g):
    """LAPACK ``lartg``-style Givens rotation for possibly-COMPLEX ``f`` and
    real-or-complex ``g``: returns ``(c, s, r)`` with ``c`` real, ``s``
    complex, ``[c s; -conj(s) c] @ [f; g] = [r; 0]`` — the complex
    generalization of :func:`_sym_ortho` (same ``(0,0) -> (1,0,0)``
    convention so exhausted recurrences stay NaN-free)."""
    af, ag = jnp.abs(f), jnp.abs(g)
    d = jnp.sqrt(af**2 + ag**2)
    dsafe = jnp.where(d > 0, d, 1.0)
    afsafe = jnp.where(af > 0, af, 1.0)
    phase = jnp.where(af > 0, f / afsafe, jnp.ones_like(f))
    c = jnp.where(d > 0, af / dsafe, 1.0)
    s = jnp.where(d > 0, phase * jnp.conj(g) / dsafe, jnp.zeros_like(f))
    r = phase * d
    return c, s, r


def _combine(stack, coeff):
    """sum_k coeff[k] * V_k, batched over the stacked basis."""
    return tuple(jnp.tensordot(coeff, s, axes=1) for s in stack)


@partial(jax.jit, static_argnames=("maxiter", "restart"))
def gmres(
    A: LinearOperator,
    b,
    x0=None,
    *,
    maxiter: int = 100,
    restart: int = 20,
    tol: float = 1e-6,
    state: Optional[GMRESState] = None,
) -> SolveResult:
    """Restarted GMRES for a SQUARE, nonsymmetric operator (real OR
    complex): minimizes ``||A x - b||`` over each restart-cycle Krylov space.

    Design: the Arnoldi basis is a stacked array (leading dim
    ``restart+1``) so orthogonalization is classical Gram-Schmidt run TWICE
    ("twice is enough") — two fused batched reductions per step instead of a
    sequential modified-GS dot chain; unfilled basis rows are zero so no
    masking is needed in the projection. Givens rotations (complex-general,
    :func:`_cgivens`) condense the Hessenberg column per step; the residual
    estimate ``|g[j+1]|`` is free. ``maxiter`` counts total inner
    iterations; resume is at restart granularity via ``state``."""
    dom = A.dom
    complex_dom = jnp.issubdtype(dom.dtype, jnp.complexfloating)
    m = int(restart)
    bnorm = dom.norm(b)
    # Hessenberg/rotation scalars live in the operator's field: complex for
    # complex operators (c stays real; s, H, g complex)
    hdtype = dom.dtype if complex_dom else bnorm.dtype
    leaves0, treedef = jax.tree_util.tree_flatten(b)

    if state is None:
        x = dom.zeros() if x0 is None else x0
        r = tr.sub(b, A(x)) if x0 is not None else b
        st = GMRESState(x, dom.norm(r), jnp.asarray(0))
    else:
        st = state
    hist0 = jnp.full((maxiter,), jnp.inf, dtype=bnorm.dtype)

    def _safe(v):
        return jnp.where(jnp.abs(v) > 0, v, 1.0)

    def cond(carry):
        st, _ = carry
        return (st.i < maxiter) & (st.rnorm > tol * bnorm)

    def cycle(carry):
        st, hist = carry
        r = tr.sub(b, A(st.x))
        beta = dom.norm(r)
        rl = jax.tree_util.tree_leaves(tr.scale(1.0 / _safe(beta), r))
        V = _set_row(_stack_zeros(leaves0, m + 1), 0, rl)
        H = jnp.zeros((m + 1, m), hdtype)
        cs = jnp.zeros((m,), bnorm.dtype)  # c is always real
        sn = jnp.zeros((m,), hdtype)
        g = jnp.zeros((m + 1,), hdtype).at[0].set(beta)

        def arnoldi(j, inner):
            V, H, cs, sn, g, hist = inner
            w = jax.tree_util.tree_leaves(
                A(jax.tree_util.tree_unflatten(treedef, _row(V, j)))
            )
            # CGS2: project twice against the whole (zero-padded) basis
            h = _dot_all(V, w)
            w = [wl - cl for wl, cl in zip(w, _combine(V, h))]
            h2 = _dot_all(V, w)
            w = [wl - cl for wl, cl in zip(w, _combine(V, h2))]
            h = h + h2
            wnorm = jnp.sqrt(sum(jnp.vdot(wl, wl).real for wl in w))
            V = _set_row(V, j + 1, [wl / _safe(wnorm) for wl in w])
            hcol = h.at[j + 1].set(wnorm)

            hcol = hcol.astype(hdtype)

            # apply previous rotations 0..j-1 to the new column
            def rot(k, hc):
                hk, hk1 = hc[k], hc[k + 1]
                on = k < j
                nk = jnp.where(on, cs[k] * hk + sn[k] * hk1, hk)
                nk1 = jnp.where(on, -jnp.conj(sn[k]) * hk + cs[k] * hk1, hk1)
                return hc.at[k].set(nk).at[k + 1].set(nk1)

            hcol = lax.fori_loop(0, m, rot, hcol)
            c, s, rr = _cgivens(hcol[j], hcol[j + 1])
            hcol = hcol.at[j].set(rr).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            gj = g[j]
            g = g.at[j].set(c * gj).at[j + 1].set(-jnp.conj(s) * gj)
            H = lax.dynamic_update_slice(H, hcol[:, None], (0, j))
            hist = hist.at[st.i + j].set(jnp.abs(g[j + 1]), mode="drop")
            return V, H, cs, sn, g, hist

        V, H, cs, sn, g, hist = lax.fori_loop(
            0, m, arnoldi, (V, H, cs, sn, g, hist)
        )
        R = H[:m, :m]
        # guard breakdown/early-convergence: dead columns get unit diagonal
        diag = jnp.diagonal(R)
        R = R + jnp.diag(jnp.where(jnp.abs(diag) > 0, 0.0, 1.0))
        y = jax.scipy.linalg.solve_triangular(R, g[:m], lower=False)
        dx = jax.tree_util.tree_unflatten(
            treedef, _combine(tuple(v[:m] for v in V), y)
        )
        x = tr.add(st.x, dx)
        rnorm = dom.norm(tr.sub(b, A(x)))
        return GMRESState(x, rnorm, st.i + m), hist

    st, hist = lax.while_loop(cond, cycle, (st, hist0))
    return SolveResult(st.x, st.i, st.rnorm, hist, st)


# ---------------------------------------------------------------------------
# Chebyshev semi-iteration — reduction-free SPD solver for multi-host runs
# ---------------------------------------------------------------------------


class ChebyshevState(NamedTuple):
    x: Any
    r: Any
    p: Any
    alpha: jax.Array
    beta: jax.Array
    i: jax.Array


@partial(jax.jit, static_argnames=("maxiter", "check_every"))
def chebyshev(
    A: LinearOperator,
    b,
    lmin: float,
    lmax: float,
    x0=None,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
    check_every: int = 10,
    state: Optional[ChebyshevState] = None,
) -> SolveResult:
    """Chebyshev semi-iteration on an SPD operator with spectrum inside
    ``[lmin, lmax]`` (estimate via :func:`estimate_spectral_bounds`).

    The multi-host scaling solver: unlike CG, the recurrence has **no inner
    products** — one operator apply and two axpys per iteration, so on a
    sharded block operator no per-iteration cross-host reduction exists at
    all (SURVEY §7's "fuse the reductions" taken to its limit). The residual
    norm (one collective) is evaluated only every ``check_every`` iterations
    for the stopping test and history.

    Caveats:

    - The stopping test runs at ``check_every`` granularity, so the loop can
      overshoot ``maxiter`` by up to ``check_every - 1`` inner iterations
      (and ``result.iterations`` reports the true count, which may exceed
      ``maxiter``); pass ``maxiter`` as a multiple of ``check_every`` for an
      exact budget. The chunk size cannot be clamped inside ``jit`` because
      ``fori_loop`` trip counts must be static.
    - ``lmin`` must be a true LOWER bound on the spectrum: Chebyshev
      *diverges* on eigenmodes below ``lmin`` (the iteration polynomial
      grows outside ``[lmin, lmax]``). An overestimated ``lmax`` merely
      slows convergence; prefer a known analytic floor when one exists —
      e.g. ``damp**2`` for the damped normal operator
      ``A^H A + damp^2 I`` — over a numerically estimated ``lmin``
      (see :func:`estimate_spectral_bounds`)."""
    dom = A.dom
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    bnorm = dom.norm(b)
    if state is None:
        x = dom.zeros() if x0 is None else x0
        r = tr.sub(b, A(x)) if x0 is not None else b
        st = ChebyshevState(
            x, r, tr.tmap(jnp.zeros_like, r),
            jnp.asarray(0.0, bnorm.dtype), jnp.asarray(0.0, bnorm.dtype),
            jnp.asarray(0),
        )
    else:
        st = state
    nchecks = -(-maxiter // check_every)
    hist0 = jnp.full((nchecks,), jnp.inf, dtype=bnorm.dtype)

    def cond(carry):
        st, _, rnorm = carry
        return (st.i < maxiter) & (rnorm > tol * bnorm)

    def body(carry):
        st, hist, rnorm = carry

        def inner(_, s):
            # standard Chebyshev recurrence on alpha/beta scalars — all
            # device-local, no reductions
            beta = jnp.where(
                s.i == 0,
                0.0,
                jnp.where(
                    s.i == 1,
                    0.5 * (delta * s.alpha) ** 2,
                    (0.5 * delta * s.alpha) ** 2,
                ),
            )
            alpha = jnp.where(
                s.i == 0, 1.0 / theta, 1.0 / (theta - beta / s.alpha)
            )
            p = tr.xpay(s.r, beta, s.p)
            x = tr.xpay(s.x, alpha, p)
            r = tr.xpay(s.r, -alpha, A(p))
            return ChebyshevState(x, r, p, alpha, beta, s.i + 1)

        st = lax.fori_loop(0, check_every, inner, st)
        rnorm = dom.norm(st.r)  # the only collective, every check_every its
        hist = hist.at[(st.i - 1) // check_every].set(rnorm, mode="drop")
        return st, hist, rnorm

    st, hist, rnorm = lax.while_loop(
        cond, body, (st, hist0, dom.norm(st.r))
    )
    return SolveResult(st.x, st.i, rnorm, hist, st)


def estimate_spectral_bounds(
    A: LinearOperator, key: Optional[jax.Array] = None, *, iters: int = 30,
    safety: float = 1.05,
):
    """(lmin, lmax) estimates for an SPD operator: power iteration for
    ``lmax`` (inflated by ``safety``), then power iteration on
    ``lmax I - A`` for ``lmin`` (deflated). Cheap setup for
    :func:`chebyshev`.

    The ``lmin`` deflation is deliberately aggressive: an unconverged power
    iteration on ``lmax I - A`` UNDERestimates ``lmax - lambda_min``, so the
    naive ``lmax - shift`` lands ABOVE the true smallest eigenvalue — fatal
    for Chebyshev (divergence), whereas an underestimated ``lmin`` only
    slows it. The shift is therefore inflated by ``safety`` before
    subtracting (a margin proportional to the spectral width, which stays
    meaningful when ``lambda_min << lmax``) and the result deflated by
    ``safety`` again. When an analytic floor exists (e.g. ``damp**2`` for a
    damped normal operator) prefer it over this estimate."""
    dom = A.dom
    if key is None:
        key = jax.random.PRNGKey(23)
    k1, k2 = jax.random.split(key)

    def power(op_apply, v0):
        def step(_, carry):
            v, lam = carry
            w = op_apply(v)
            lam = dom.norm(w)
            return tr.scale(1.0 / jnp.where(lam > 0, lam, 1.0), w), lam

        _, lam = lax.fori_loop(0, iters, step, (v0, jnp.asarray(0.0)))
        return lam

    v1, _ = _normalize(dom, dom.randn(k1))
    lmax = power(A, v1) * safety
    v2, _ = _normalize(dom, dom.randn(k2))
    lmin_shift = power(lambda v: tr.xpay(tr.scale(lmax, v), -1.0, A(v)), v2)
    lmin = jnp.maximum(lmax - safety * lmin_shift, 0.0) / safety
    return lmin, lmax
