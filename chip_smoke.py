#!/usr/bin/env python3
"""Smoke test of the main paths on one NVIDIA GPU, at full size.

    python chip_smoke.py               # phases A-D on one card
    python chip_smoke.py --four-cards  # the multi-card paths, on four cards

Phases (all in this one process, which owns the card):

* A — 2-D flagship LSQR: 2048² model, 64 shots × 4096 receivers, 100
  iterations, against a numpy float64 reference of the operator written
  here (sharing no code with ``jets_tpu``) and scipy's LSQR on it.
* B — the same checks for the 3-D flagship: 256³, 16 shots, 30 iterations.
* C — 3-D isotropic FWI gradient at 256³ (nt=160, int8 stored adjoint):
  traces against the same operator in float64 on the host CPU, the int8
  gradient against the float64 autodiff gradient, the f32-stored gradient
  against autodiff on the card.
* D — VTI and TTI int8 gradients at 256³ against autodiff on the card (the
  TTI tilt/azimuth blocks also with the f32 store), and
  the 16-shot ``multishot_wave_operator`` (``shot_map="map"``, int8)
  against the single-shot operator.

``--four-cards`` runs only the multi-device paths, each against its
one-card run: shot-sharded 2-D LSQR, the 16-shot iso gradient over a
4-card mesh, and the GSPMD grid-sharded iso forward.

Every check prints its measured value beside its limit and raises on
failure. Timing lines are informational (median of 5 ``block_until_ready``
runs after a warm-up). The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed.
Exits non-zero without a GPU; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ONE_CARD_PHASES = ("A", "B", "C", "D")
FOUR_CARD_PHASES = ("four_cards",)


# ---------------------------------------------------------------------------
# plain numpy float64 reference of the flagship operator
#     d_b = w_b[rcv] · (L m)[rcv],   L = zero-boundary (2·nd+1)-point
# Laplacian with unit spacing; adjoint m = L(Σ_b Pᵀ(w_b · d_b)).
# ---------------------------------------------------------------------------


def np_laplacian(m):
    """Zero-boundary second-difference Laplacian, unit spacing."""
    nd = m.ndim
    p = np.pad(m, 1)
    out = -2.0 * nd * m
    for ax in range(nd):
        lo = [slice(1, -1)] * nd
        hi = [slice(1, -1)] * nd
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        out = out + p[tuple(lo)] + p[tuple(hi)]
    return out


class FlagshipReference:
    """The flagship's forward and adjoint in numpy float64, given the
    receiver flat indices ``rcv`` (nrecv,) and weights ``wr``
    (nshots, nrecv)."""

    def __init__(self, grid, rcv, wr):
        self.grid = tuple(int(s) for s in grid)
        self.rcv = np.asarray(rcv, np.int64)
        self.wr = np.asarray(wr, np.float64)

    @classmethod
    def of(cls, A):
        st = A.jet.state
        return cls(A.dom.shape, np.asarray(st["sstate"]["rcv"]),
                   np.asarray(st["bstate"]["wr"]))

    def forward(self, m):
        lm = np_laplacian(np.asarray(m, np.float64).reshape(self.grid))
        return self.wr * lm.reshape(-1)[self.rcv][None, :]

    def adjoint(self, d):
        g = np.sum(np.asarray(d, np.float64) * self.wr, axis=0)
        z = np.zeros(int(np.prod(self.grid)))
        np.add.at(z, self.rcv, g)
        return np_laplacian(z.reshape(self.grid))

    def scipy_lsqr(self, d, iters):
        """scipy's LSQR on this operator, ``iters`` iterations from 0."""
        from scipy.sparse.linalg import LinearOperator, lsqr

        n = int(np.prod(self.grid))
        shape_d = self.wr.shape
        op = LinearOperator(
            (int(np.prod(shape_d)), n), dtype=np.float64,
            matvec=lambda x: self.forward(x).reshape(-1),
            rmatvec=lambda y: self.adjoint(y.reshape(shape_d)).reshape(-1))
        out = lsqr(op, np.asarray(d, np.float64).reshape(-1), atol=0.0,
                   btol=0.0, conlim=1e300, iter_lim=iters)
        return out[0].reshape(self.grid)


# ---------------------------------------------------------------------------
# command line, output format, checks
# ---------------------------------------------------------------------------


def select_phases(argv):
    """Phases to run for ``argv``: A-D by default, only the four-card
    phase with ``--four-cards``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths (needs 4 GPUs)")
    args = ap.parse_args(argv)
    return FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES


def result_line(device, count):
    """The last output line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": int(count)}})


def card_label():
    """``name, power limit`` of the first card, as nvidia-smi reports."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def log(msg):
    print(msg, flush=True)


def check(name, value, limit, *, at_least=False):
    """Print ``value`` against ``limit`` and fail unless value ≤ limit
    (≥ with ``at_least``)."""
    ok = value >= limit if at_least else value <= limit
    rel = ">=" if at_least else "<="
    log(f"CHECK {name}: {value:.3e} (need {rel} {limit:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: {value!r} violates {rel} {limit!r}")


def rel_err(a, b):
    """Norm-wise relative difference ‖a − b‖ / ‖b‖ (in float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def assert_live(name, x):
    amp = float(np.max(np.abs(np.asarray(x))))
    log(f"live {name}: max|.| = {amp:.3e}")
    if not amp > 0.0:
        raise AssertionError(f"{name} is identically zero: vacuous check")


def median_time(fn, *args, reps=5):
    """Median seconds of ``reps`` blocked runs after one warm-up run."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


class Ctx:
    """What every phase needs: the card label and the host CPU device."""

    def __init__(self, label):
        import jax

        self.label = label
        self.cpu = jax.devices("cpu")[0]

    def timing(self, what, value, unit):
        log(f"TIME {what}: {value:.1f} {unit} [{self.label}]")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def flagship_phase(ctx, grid, nshots, nrecv, iters):
    """Forward/adjoint against the numpy reference, the dot-product test,
    and ``iters`` LSQR iterations against scipy's on the reference."""
    import jax
    import jax.numpy as jnp

    import jets_tpu as jt
    from jets_tpu.models.seismic import make_seismic_problem
    from jets_tpu.solvers import lsqr

    A, m_true, d = make_seismic_problem(grid, nshots, nrecv, noise=0.05,
                                        dtype=jnp.float32)
    ref = FlagshipReference.of(A)
    apply = jax.jit(lambda op, x: op(x))
    applyh = jax.jit(lambda op, y: op.H(y))
    d64 = np.asarray(d, np.float64)
    assert_live("data", d64)
    check("forward vs numpy f64 (rel)",
          rel_err(apply(A, m_true), ref.forward(np.asarray(m_true))), 1e-5)
    check("adjoint vs numpy f64 (rel)",
          rel_err(applyh(A, d), ref.adjoint(d64)), 1e-5)

    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    lhs, rhs = jax.jit(jt.dot_product_test)(A, A.dom.randn(k1),
                                           A.rng.randn(k2))
    check("dot-product test on the card (rel)",
          abs(float(lhs) - float(rhs)) / abs(float(lhs)), 1e-4)

    res = lsqr(A, d, maxiter=iters, tol=0.0)
    # the residual estimate is multiplied by |s| ≤ 1 each iteration, with s
    # rounded in float32, so it may grow by an ulp: allow 8 ulps
    hist = np.asarray(res.history, np.float64)[:iters]
    check("LSQR residual estimate, largest relative increase",
          float(np.max(np.diff(hist) / hist[:-1])), 8 * 2.0 ** -23)
    x_card = np.asarray(res.x, np.float64)
    rr_card = rel_err(ref.forward(x_card), d64)
    x_ref = ref.scipy_lsqr(d64, iters)
    rr_ref = rel_err(ref.forward(x_ref), d64)
    log(f"LSQR relative residual after {iters} iterations: card "
        f"{rr_card:.6e}, scipy {rr_ref:.6e}")
    check("LSQR relative residual vs scipy (abs diff)",
          abs(rr_card - rr_ref), 1e-3)
    t = median_time(lambda b: lsqr(A, b, maxiter=iters, tol=0.0), d)
    ctx.timing(f"LSQR {grid} {nshots} shots x {nrecv} rcv", iters / t,
               "iterations/s")


def phase_a(ctx):
    flagship_phase(ctx, (2048, 2048), 64, 4096, 100)


def phase_b(ctx):
    flagship_phase(ctx, (256, 256, 256), 16, 4096, 30)


GRID3 = (256, 256, 256)


def wave_geometry(grid=GRID3, nt=160):
    """``bench.py``'s gradient geometry: source at the centre, 128
    receivers every 2 cells on the x-line through it."""
    cz, cy, cx = (s // 2 for s in grid)
    rcv = np.ravel_multi_index(
        (np.full(grid[2] // 2, cz), np.full(grid[2] // 2, cy),
         np.arange(0, grid[2], 2)), grid).astype(np.int32)
    return dict(nt=nt, dt=5e-4, dx=10.0, freq=15.0,
                src_idx=int(np.ravel_multi_index((cz, cy, cx), grid)),
                rcv_idx=rcv, sponge_width=12)


def velocity(grid, seed=0):
    import jax
    import jax.numpy as jnp

    return 1500.0 + 20.0 * jax.random.normal(jax.random.PRNGKey(seed), grid,
                                             jnp.float32)


def phase_c(ctx, grid=GRID3, nt=160, remat=16):
    import jax
    import jax.numpy as jnp

    from jets_tpu.ops.wave import wave_propagator

    kw = wave_geometry(grid, nt)
    F8 = wave_propagator(grid, store_adjoint="int8", dtype=jnp.float32,
                         **kw)
    c = velocity(grid)
    fwd = jax.jit(lambda op, m: op(m))
    grad = jax.jit(lambda op, m, r: op.linearize(m).H(r))
    d_c = fwd(F8, c)
    resid = fwd(F8, 1.02 * c) - d_c
    assert_live("traces", d_c)
    assert_live("residual", resid)

    with jax.enable_x64(True), jax.default_device(ctx.cpu):
        F64 = wave_propagator(grid, remat_blocks=remat, dtype=jnp.float64,
                              **kw)
        c64 = jnp.asarray(np.asarray(c, np.float64))
        d64 = np.asarray(fwd(F64, c64))
        g64 = np.asarray(grad(F64, c64,
                              jnp.asarray(np.asarray(resid, np.float64))))
    check("iso traces, card f32 vs CPU f64 (rel)", rel_err(d_c, d64), 1e-4)

    g8 = grad(F8, c, resid)
    assert_live("int8 gradient", g8)
    check("iso int8 gradient vs CPU f64 autodiff (cosine)",
          cosine(g8, g64), 0.999, at_least=True)

    F32 = wave_propagator(grid, store_adjoint="f32", dtype=jnp.float32, **kw)
    Fad = wave_propagator(grid, remat_blocks=remat, dtype=jnp.float32, **kw)
    g32 = grad(F32, c, resid)
    gad = grad(Fad, c, resid)
    assert_live("autodiff gradient", gad)
    check("iso f32-store gradient vs card autodiff (rel)",
          rel_err(g32, gad), 1e-4)

    ctx.timing(f"iso forward {grid} nt={nt}",
               median_time(fwd, F8, c) / nt * 1e6, "us/step")
    ctx.timing(f"iso int8 gradient {grid} nt={nt}",
               median_time(grad, F8, c, resid) / nt * 1e6, "us/step")


def _aniso_model(F, grid, vals, c):
    import jax.numpy as jnp

    m = F.dom.zeros().setblock(0, c)
    for b, v in enumerate(vals[1:], start=1):
        m = m.setblock(b, jnp.full(grid, v, jnp.float32))
    return m


# The TTI tilt/azimuth gradients are built from mixed derivatives of the
# stored fields, which amplify the int8 history's quantization noise, so
# with the int8 store these two blocks are held to a wider limit than the
# velocity/Thomsen blocks; phase D checks the same blocks with the f32
# store at the usual limit, which shows the loss is the store's.
TILT_COSINE = 0.995
TILT_BLOCKS = (3, 4)


def phase_d(ctx, grid=GRID3, nt=60, remat=6, nshots=16, nt_multi=40):
    import jax
    import jax.numpy as jnp

    from jets_tpu.ops.wave import (multishot_wave_operator,
                                   tti_wave_propagator, vti_wave_propagator,
                                   wave_propagator)

    fwd = jax.jit(lambda op, m: op(m))
    grad = jax.jit(lambda op, m, r: op.linearize(m).H(r))
    kw = wave_geometry(grid, nt)
    c = jnp.full(grid, 1500.0, jnp.float32)
    for name, ctor, vals in (
            ("vti", vti_wave_propagator, (1500.0, 0.1, 0.05)),
            ("tti", tti_wave_propagator, (1500.0, 0.1, 0.05, 0.2, 0.7))):
        F8 = ctor(grid, store_adjoint="int8", dtype=jnp.float32, **kw)
        Fad = ctor(grid, remat_blocks=remat, dtype=jnp.float32, **kw)
        m = _aniso_model(F8, grid, vals, c)
        resid = fwd(F8, m.setblock(0, 1.02 * c)) - fwd(F8, m)
        assert_live(f"{name} residual", resid)
        g8 = grad(F8, m, resid)
        gad = grad(Fad, m, resid)
        for b in range(len(vals)):
            assert_live(f"{name} autodiff gradient block {b}",
                        gad.getblock(b))
            check(f"{name} int8 gradient block {b} vs autodiff (cosine)",
                  cosine(g8.getblock(b), gad.getblock(b)),
                  TILT_COSINE if b in TILT_BLOCKS else 0.999,
                  at_least=True)
        ctx.timing(f"{name} int8 gradient {grid} nt={nt}",
                   median_time(grad, F8, m, resid) / nt * 1e6, "us/step")
        if name == "tti":
            g32 = grad(ctor(grid, store_adjoint="f32", dtype=jnp.float32,
                            **kw), m, resid)
            for b in TILT_BLOCKS:
                log(f"tti f32-store gradient block {b} vs autodiff (rel): "
                    f"{rel_err(g32.getblock(b), gad.getblock(b)):.3e}")
                check(f"tti f32-store gradient block {b} vs autodiff "
                      "(cosine)", cosine(g32.getblock(b), gad.getblock(b)),
                      0.999, at_least=True)
            del g32

    kwm = wave_geometry(grid, nt_multi)
    kwm.pop("src_idx")
    cz, cy, _ = (s // 2 for s in grid)
    srcs = np.ravel_multi_index(
        (np.full(nshots, cz), np.full(nshots, cy),
         16 + ((grid[2] - 32) // nshots) * np.arange(nshots)), grid)
    Fm = multishot_wave_operator(grid, srcs, store_adjoint="int8",
                                 shot_map="map", dtype=jnp.float32, **kwm)
    F1 = wave_propagator(grid, src_idx=int(srcs[0]), dtype=jnp.float32,
                         **kwm)
    cv = velocity(grid)
    dm = fwd(Fm, cv)
    assert_live("multishot traces, shot 0", dm[0])
    check("multishot shot 0 vs single-shot operator (rel)",
          rel_err(dm[0], fwd(F1, cv)), 1e-5)
    rm = fwd(Fm, 1.02 * cv) - dm
    gm = grad(Fm, cv, rm)
    assert_live("multishot int8 gradient", gm)
    if not np.isfinite(np.asarray(gm)).all():
        raise AssertionError("multishot gradient is not finite")
    ctx.timing(f"multishot {nshots} shots int8 gradient {grid} "
               f"nt={nt_multi}", median_time(grad, Fm, cv, rm)
               / (nt_multi * nshots) * 1e6, "us/shot-step")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')} "
        f"[{ctx.label}]")


def _bytes_in_use(devs):
    """Bytes in use per device, or None where the backend keeps no
    statistics (the host CPU)."""
    stats = [d.memory_stats() for d in devs]
    return [None if s is None else int(s.get("bytes_in_use", 0))
            for s in stats]


def _check_all_cards_hold(name, devs, before, *arrays):
    """Every card holds a shard of ``arrays`` and, where the backend keeps
    memory statistics, more bytes than ``before`` the run."""
    held = set()
    for x in arrays:
        held |= {sh.device for sh in x.addressable_shards}
    missing = [d for d in devs if d not in held]
    if missing:
        raise AssertionError(f"{name}: no shard on {missing}")
    after = _bytes_in_use(devs)
    log(f"{name}: bytes in use per card {after} (before {before})")
    for i, (b, a) in enumerate(zip(before, after)):
        if a is not None and not a > b:
            raise AssertionError(
                f"{name}: card {i} holds nothing new ({b} -> {a} bytes)")


def phase_four_cards(ctx, grid2=(2048, 2048), nshots2=64, nrecv=4096,
                     iters=30, grid3=GRID3, nt=40, nshots=16, nt_fwd=160):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jets_tpu.models.seismic import make_seismic_problem
    from jets_tpu.ops.wave import multishot_wave_operator, wave_propagator
    from jets_tpu.parallel.sharded import make_block_mesh, shard_blocks
    from jets_tpu.solvers import lsqr

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    devs = devs[:4]
    mesh = make_block_mesh(4)
    fwd = jax.jit(lambda op, m: op(m))
    grad = jax.jit(lambda op, m, r: op.linearize(m).H(r))

    # shot-sharded 2-D LSQR: shots over the 4 cards, psum adjoint
    A1, m1, d = make_seismic_problem(grid2, nshots2, nrecv, noise=0.05,
                                     dtype=jnp.float32)
    before = _bytes_in_use(devs)
    A4, _, _ = make_seismic_problem(grid2, nshots2, nrecv, mesh=mesh,
                                    dtype=jnp.float32)
    d4 = shard_blocks(d, mesh)
    r4 = lsqr(A4, d4, maxiter=iters, tol=0.0)
    _check_all_cards_hold("sharded LSQR", devs, before, d4)
    r1 = lsqr(A1, d, maxiter=iters, tol=0.0)
    apply = jax.jit(lambda op, x: op(x))
    applyh = jax.jit(lambda op, y: op.H(y))
    check("shot-sharded forward vs one card (rel)",
          rel_err(apply(A4, m1), apply(A1, m1)), 1e-5)
    check("shot-sharded psum adjoint vs one card (rel)",
          rel_err(applyh(A4, d4), applyh(A1, d)), 1e-5)
    h1 = np.asarray(r1.history, np.float64)
    h4 = np.asarray(r4.history, np.float64)
    check(f"shot-sharded LSQR residual history over {iters} iterations vs "
          "one card (max rel)", float(np.max(np.abs(h4 - h1) / h1)), 1e-5)
    ref = FlagshipReference.of(A1)
    d64 = np.asarray(d, np.float64)
    rr1 = rel_err(ref.forward(np.asarray(r1.x)), d64)
    rr4 = rel_err(ref.forward(np.asarray(r4.x)), d64)
    check(f"shot-sharded LSQR relative residual after {iters} iterations vs "
          "one card (rel)", abs(rr4 - rr1) / rr1, 1e-5)
    check(f"shot-sharded LSQR x after {iters} iterations vs one card (rel)",
          rel_err(r4.x, r1.x), 1e-5)
    ctx.timing(f"sharded LSQR {grid2} {nshots2} shots on 4 cards",
               iters / median_time(
                   lambda b: lsqr(A4, b, maxiter=iters, tol=0.0), d4),
               "iterations/s")
    del A4, d4, r4

    # 16-shot iso gradient, shots over the 4 cards
    kw = wave_geometry(grid3, nt)
    kw.pop("src_idx")
    cz, cy, _ = (s // 2 for s in grid3)
    srcs = np.ravel_multi_index(
        (np.full(nshots, cz), np.full(nshots, cy),
         16 + ((grid3[2] - 32) // nshots) * np.arange(nshots)), grid3)
    c = velocity(grid3)
    F1 = multishot_wave_operator(grid3, srcs, store_adjoint="int8",
                                 shot_map="map", dtype=jnp.float32, **kw)
    r = fwd(F1, 1.02 * c) - fwd(F1, c)
    g1 = grad(F1, c, r)
    assert_live("multishot gradient, one card", g1)
    before = _bytes_in_use(devs)
    F4 = multishot_wave_operator(grid3, srcs, store_adjoint="int8",
                                 shot_map="map", mesh=mesh,
                                 dtype=jnp.float32, **kw)
    r4 = shard_blocks(r, mesh)
    g4 = grad(F4, c, r4)
    _check_all_cards_hold("mesh multishot gradient", devs, before, r4)
    check(f"{nshots}-shot iso gradient on 4 cards vs one card (rel)",
          rel_err(g4, g1), 1e-5)
    del F4, r4, g4

    # GSPMD grid-sharded iso forward: the wavefields split over z
    kwf = wave_geometry(grid3, nt_fwd)
    ws = NamedSharding(make_block_mesh(4, axis="grid"), P("grid"))
    Fs = wave_propagator(grid3, wavefield_sharding=ws, dtype=jnp.float32,
                         **kwf)
    F0 = wave_propagator(grid3, dtype=jnp.float32, **kwf)
    d0 = fwd(F0, c)
    before = _bytes_in_use(devs)
    cs = jax.device_put(c, ws)
    ds = fwd(Fs, cs)
    _check_all_cards_hold("grid-sharded forward", devs, before, cs)
    assert_live("grid-sharded traces", ds)
    check("grid-sharded iso forward vs one card (rel)", rel_err(ds, d0),
          1e-5)
    ctx.timing(f"grid-sharded iso forward {grid3} on 4 cards nt={nt_fwd}",
               median_time(fwd, Fs, cs) / nt_fwd * 1e6, "us/step")


PHASES = {"A": phase_a, "B": phase_b, "C": phase_c, "D": phase_d,
          "four_cards": phase_four_cards}


def main(argv=None):
    phases = select_phases(sys.argv[1:] if argv is None else argv)
    label = card_label()
    log(label)
    import jax

    log(f"jax {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform!r}); refusing "
              "to run", file=sys.stderr)
        return 2
    import jets_tpu

    if Path(jets_tpu.__file__).resolve().parents[1] != HERE:
        print(f"chip_smoke: jets_tpu must come from {HERE}, got "
              f"{jets_tpu.__file__}", file=sys.stderr)
        return 2
    from jets_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    ctx = Ctx(label)
    for name in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        PHASES[name](ctx)
        log(f"== phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(label)
    print(result_line(dev, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
