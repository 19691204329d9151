"""Micro-benchmark suite — mirrors the reference's BenchmarkTools ``SUITE``
(``benchmark/benchmarks.jl``, 8 groups: JetSpace, Jet, JopLn, JopNl,
Composition, Block homogeneous/heterogeneous, vec).

The reference's implied contract (BASELINE.md): combinator/block abstraction
overhead ≈ 0 vs the base case. Here the analogous contract is that a
combinator applied under ``jit`` compiles to the same fused XLA program as
the hand-written base case; the suite reports both so the tax is visible.

Run: ``python benchmarks/micro.py [--device cpu|gpu]`` — prints one row per
entry (median of ``reps``).
"""
import argparse
import time

import jax
import jax.numpy as jnp

ROWS = []


def timeit(label, fn, *args, reps=30):
    fn(*args)  # warm / compile
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn(*args)
        jax.block_until_ready(r)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2] * 1e6
    ROWS.append((label, med))
    return med


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "gpu"])
    args = ap.parse_args()
    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")

    import jets_tpu as jt
    from jets_tpu.ops.diagonal import diagonal_operator
    from jets_tpu.ops.matrix import matrix_operator

    key = jax.random.PRNGKey(0)
    n = 100  # reference micro-op size (benchmark/benchmarks.jl uses 100)

    # --- group: Space (reference benchmarks.jl:7-16) ---
    sp = jt.Space((n,), jnp.float32)
    timeit("space/construct", lambda: jt.Space((n,), jnp.float32))
    timeit("space/rand", lambda: sp.rand(key))
    timeit("space/zeros", lambda: sp.zeros())
    timeit("space/reshape", lambda: sp.reshape(jnp.zeros(n)))

    # --- group: Jet (reference :24-32: construct, dom/rng, point, state,
    # state!, shape, size) ---
    _dw = lambda dx, x0, s: s["w"] * dx  # noqa: E731
    wj = jnp.ones(n)
    jet0 = jt.Jet(dom=sp, rng=sp, df=_dw, state={"w": wj})
    Fj = jt.LinearOperator(jet0)
    m0 = sp.rand(key)
    Fp = Fj.linearize(m0)
    timeit("jet/construct",
           lambda: jt.Jet(dom=sp, rng=sp, df=_dw, state={"w": wj}))
    timeit("jet/domain", lambda: jet0.dom)
    timeit("jet/range", lambda: jet0.rng)
    timeit("jet/point (pin)", lambda: Fj.linearize(m0))
    timeit("jet/point (read)", lambda: jt.point(Fp))
    timeit("jet/state", lambda: jt.state(Fj, "w"))
    timeit("jet/with_state", lambda: jt.with_state(Fj, w=wj))
    timeit("jet/shape", lambda: (jet0.rng.shape, jet0.dom.shape))
    timeit("jet/size", lambda: (jet0.rng.size, jet0.dom.size))

    # --- group: JopLn (diagonal, reference :42-52) ---
    w = jnp.arange(1.0, n + 1.0)
    D = diagonal_operator(w)
    m = sp.rand(key)
    apply_jit = jax.jit(lambda op, x: op(x))
    adj_jit = jax.jit(lambda op, x: op.H(x))
    timeit("linop/construct", lambda: diagonal_operator(w))
    timeit("linop/apply", apply_jit, D, m)
    timeit("linop/adjoint_apply", adj_jit, D, m)
    timeit("linop/adjoint_wrap", lambda: D.H)

    # --- group: JopNl (elementwise square, reference :63-71) ---
    F = jt.Operator(jt.Jet(dom=sp, rng=sp,
                           f=lambda x, s: x * x,
                           df=lambda dx, x0, s: 2 * x0 * dx, dft="self"))
    timeit("nlop/apply", apply_jit, F, m)
    timeit("nlop/linearize", lambda: F.linearize(m))
    J = F.linearize(m)
    timeit("nlop/jacobian_apply", apply_jit, J, m)

    # --- group: Composition (F∘A∘F∘A, reference :75-86) ---
    A4 = F @ D @ F @ D
    timeit("comp/construct", lambda: F @ D @ F @ D)
    timeit("comp/apply", apply_jit, A4, m)
    J4 = A4.linearize(m)
    timeit("comp/jacobian_apply", apply_jit, J4, m)
    timeit("comp/jacobian_adjoint", adj_jit, J4, m)
    # base case: hand-fused chain
    basef = jax.jit(lambda x: (lambda y: y * y)(w * (lambda z: z * z)(w * x)))
    timeit("comp/apply (base-case)", basef, m)

    # --- group: Block homogeneous (2x3 blockop, reference :100-124) ---
    ops = [[diagonal_operator(w) for _ in range(3)] for _ in range(2)]
    B = jt.block_operator(ops)
    mb = B.dom.rand(key)
    timeit("block/construct", lambda: jt.block_operator(ops))
    timeit("block/apply", apply_jit, B, mb)
    timeit("block/adjoint", adj_jit, B, B.rng.rand(key))
    timeit("block/getblock", lambda: jt.getblock(B, 1, 2))
    timeit("block/dot", jax.jit(lambda x, y: x.space.dot(x, y)), mb, mb)
    timeit("block/norm", jax.jit(lambda x: x.space.norm(x)), mb)
    timeit("block/fill", lambda: mb.fill(0.5))
    timeit("block/extrema", lambda: jax.block_until_ready(mb.extrema()))
    timeit("block/setblock", lambda: mb.setblock(1, jnp.ones(n)))
    # base case: flat array ops of the same total size
    flat = jnp.zeros(B.dom.size)
    timeit("block/dot (base-case)", jax.jit(jnp.vdot), flat, flat)
    timeit("block/norm (base-case)", jax.jit(jnp.linalg.norm), flat)
    timeit("block/fill (base-case)", jax.jit(lambda x: jnp.full_like(x, 0.5)),
           flat)
    timeit("block/extrema (base-case)",
           jax.jit(lambda x: (jnp.min(x), jnp.max(x))), flat)

    # --- group: Block heterogeneous (mixed JopBar/JopFoo-style blocks,
    # reference :139-157, with base-case pairs :153-156) ---
    Fh = jt.Operator(jt.Jet(dom=sp, rng=sp,
                            f=lambda x, s: x * x,
                            df=lambda dx, x0, s: 2 * x0 * dx, dft="self"))
    hops = [[Fh, diagonal_operator(w), Fh],
            [diagonal_operator(w), Fh, diagonal_operator(w)]]
    Bh = jt.block_operator(hops)
    mh = Bh.dom.rand(key)
    timeit("hblock/construct", lambda: jt.block_operator(hops))
    timeit("hblock/apply", apply_jit, Bh, mh)
    Jh = Bh.linearize(mh)
    timeit("hblock/jacobian", lambda: Bh.linearize(mh))
    timeit("hblock/jacobian_apply", apply_jit, Jh, mh)
    timeit("hblock/adjoint", adj_jit, Jh, Jh.rng.rand(key))
    timeit("hblock/getblock", lambda: jt.getblock(Bh, 1, 2))
    dh = Bh.rng.rand(key)
    timeit("hblock/dot", jax.jit(lambda x, y: x.space.dot(x, y)), dh, dh)
    timeit("hblock/norm", jax.jit(lambda x: x.space.norm(x)), dh)
    # base case: the same mixed math hand-written on flat slices
    wfull = jnp.concatenate([w, w, w])

    def _hbase(x):
        a, b2, c = x[:n], x[n:2 * n], x[2 * n:]
        r0 = a * a + w * b2 + c * c
        r1 = w * a + b2 * b2 + w * c
        return jnp.concatenate([r0, r1])

    timeit("hblock/apply (base-case)", jax.jit(_hbase), jnp.ravel(wfull))
    flat2 = jnp.zeros(Bh.rng.size)
    timeit("hblock/dot (base-case)", jax.jit(jnp.vdot), flat2, flat2)

    # --- group: vec (reference :173-185) ---
    sp2 = jt.Space((10, n // 10), jnp.float32)
    D2 = diagonal_operator(sp2.rand(key))
    V = jt.vec(D2)
    mv = V.dom.rand(key)
    timeit("vec/construct", lambda: jt.vec(D2))
    timeit("vec/apply", apply_jit, V, mv)
    timeit("vec/adjoint", adj_jit, V, mv)

    # --- group: jets_tpu extras (beyond the reference's 8 groups) ---
    from jets_tpu.ops import (
        bandpass_operator, gradient_operator, taper_operator, wavelet_operator,
    )
    from jets_tpu.solvers import lsqr

    spw = jt.Space((64, 64), jnp.float32)
    W = wavelet_operator(spw, "db2", levels=2)
    mw = spw.rand(key)
    timeit("extras/wavelet_apply", apply_jit, W, mw)
    timeit("extras/wavelet_adjoint", adj_jit, W, mw)
    Bp = bandpass_operator(jt.Space((1024,), jnp.float32), 0.004, 10.0, 60.0)
    timeit("extras/bandpass_apply", apply_jit, Bp, Bp.dom.rand(key))
    G = gradient_operator(spw)
    timeit("extras/gradient_apply", apply_jit, G, mw)
    T = taper_operator(spw, (8, 8))
    timeit("extras/taper_apply", apply_jit, T, mw)
    Dl = diagonal_operator(jt.Space((1000,), jnp.float32).rand(key) + 0.5)
    bl = Dl.rng.rand(key)
    timeit("extras/lsqr_20iters",
           lambda: jax.block_until_ready(
               lsqr(Dl, bl, maxiter=20, tol=0.0).x))
    from jets_tpu.solvers import bicgstab, chebyshev, gmres
    timeit("extras/gmres_1cycle",
           lambda: jax.block_until_ready(
               gmres(Dl, bl, maxiter=20, restart=20, tol=0.0).x))
    timeit("extras/bicgstab_20iters",
           lambda: jax.block_until_ready(
               bicgstab(Dl, bl, maxiter=20, tol=0.0).x))
    timeit("extras/chebyshev_20iters",
           lambda: jax.block_until_ready(
               chebyshev(Dl, bl, 0.25, 2.5, maxiter=20, tol=0.0,
                         check_every=10).x))

    print(f"\n{'entry':38s} {'median us':>12s}")
    print("-" * 52)
    for label, med in ROWS:
        print(f"{label:38s} {med:12.1f}")


if __name__ == "__main__":
    main()
