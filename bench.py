"""Headline benchmark: LSQR iterations/s on the multi-shot seismic-style
linearized inversion (BASELINE.json north star), single device, plus the
3-D wave-propagator, FWI-gradient, multishot and anisotropic stages.

Prints ONE JSON line: ``{"metric": ..., "value": N, "unit": ..., ...}``
with the device it ran on (name and power limit on a GPU).

Timing: every timed call ends in ``block_until_ready``; each figure is a
MARGINAL cost ``(t(HI) - t(LO)) / (HI - LO)`` between two iteration or
time-step budgets, which cancels the fixed dispatch and setup cost; each
``t`` is the median of three runs after a warm-up.
"""
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.solvers import lsqr
from jets_tpu.utils.compile_cache import enable_compile_cache


def _stage(msg, _t0=[None]):
    if _t0[0] is None:
        _t0[0] = time.time()
    print(f"[bench +{time.time() - _t0[0]:.0f}s] {msg}", file=sys.stderr,
          flush=True)


GRID = (2048, 2048)
NSHOTS = 64
NRECV = 4096
LO, HI = 100, 2100


def _timed(fn, args):
    """Median wall time of three ``block_until_ready`` runs of ``fn(*args)``
    after one warm-up run; returns ``(seconds, last result)``."""
    r = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[1], r


def _device_label():
    d = jax.devices()[0]
    if d.platform != "gpu":
        return f"{d.platform}:{d.device_kind}"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return f"{d.device_kind} ({smi})"


def main():
    enable_compile_cache()
    _stage("building problem")
    # 5% observation noise keeps the LS problem inconsistent so the solver
    # runs its full iteration budget (no early exact-fit exit).
    A, m_true, d_obs = make_seismic_problem(
        GRID, NSHOTS, NRECV, seed=0, noise=0.05, dtype=jnp.float32
    )

    jax.block_until_ready(d_obs)
    _stage("problem ready; compiling/timing lsqr LO")

    # ---- LSQR iterations/s (marginal cost between two iteration budgets)
    t_lo, res_lo = _timed(
        lambda b: lsqr(A, b, maxiter=LO, tol=0.0), (d_obs,))
    _stage(f"lsqr LO done ({t_lo*1e3:.0f} ms/call); lsqr HI")
    t_hi, res_hi = _timed(
        lambda b: lsqr(A, b, maxiter=HI, tol=0.0), (d_obs,))
    _stage(f"lsqr HI done ({t_hi*1e3:.0f} ms/call); matvec pair loop")
    assert int(res_hi.iterations) == HI and int(res_lo.iterations) == LO
    iters_per_s = (HI - LO) / max(t_hi - t_lo, 1e-9)

    # ---- 3-D flagship (config #5 shape): LSQR iterations/s
    _stage("building 3-D problem")
    A3, _, d3 = make_seismic_problem(
        (256, 256, 256), 16, 4096, seed=0, noise=0.05, dtype=jnp.float32
    )
    jax.block_until_ready(d3)
    _stage("timing 3-D lsqr")
    t3_lo, _ = _timed(lambda b: lsqr(A3, b, maxiter=50, tol=0.0), (d3,))
    t3_hi, _ = _timed(lambda b: lsqr(A3, b, maxiter=450, tol=0.0), (d3,))
    iters3d_per_s = 400 / max(t3_hi - t3_lo, 1e-9)
    _stage(f"3-D lsqr done ({1e3/iters3d_per_s:.2f} ms/iter); matvec loop")

    # ---- 3-D wave step (marginal between nt budgets)
    _stage("timing 3-D wave step")
    from jets_tpu.ops.wave import wave_propagator

    wshape = (256, 256, 256)
    c0 = jax.block_until_ready(jnp.full(wshape, 1500.0, jnp.float32))

    def wave_time(nt):
        F = wave_propagator(wshape, nt=nt, dt=5e-4, dx=10.0, freq=15.0,
                            src_idx=7, sponge_width=12, dtype=jnp.float32)
        g = jax.jit(lambda c: jnp.sum(F(c) ** 2))
        t, _ = _timed(g, (c0,))
        return t

    wt_lo, wt_hi = wave_time(20), wave_time(220)
    wave_step_us = (wt_hi - wt_lo) / 200 * 1e6
    _stage(f"wave step done ({wave_step_us:.0f} us/step); gradient step")

    # ---- 3-D FWI gradient step (stored-int8 forward + reverse sweep —
    # the production imaging hot path). us per TIME STEP of the whole
    # gradient (both sweeps), marginal between nt budgets.
    import numpy as np

    grcv = jnp.asarray([np.ravel_multi_index((128, 128, x), wshape)
                        for x in range(0, 256, 2)], jnp.int32)
    gkw = dict(dt=5e-4, dx=10.0, freq=15.0,
               src_idx=int(np.ravel_multi_index((128, 128, 128), wshape)),
               rcv_idx=grcv, sponge_width=12, dtype=jnp.float32)

    def grad_time(nt):
        F = wave_propagator(wshape, nt=nt, store_adjoint="int8", **gkw)
        g = jax.jit(lambda c: jnp.sum(F.linearize(c).H(
            jnp.ones((nt, grcv.shape[0]), jnp.float32))))
        t, _ = _timed(g, (c0,))
        return t

    grad_step_us = (grad_time(220) - grad_time(20)) / 200 * 1e6
    _stage(f"gradient step done ({grad_step_us:.0f} us/step); multishot")

    # ---- config-#5-scale multishot (256^3, 16 shots, sequential
    # shot_map='map'): forward and gradient cost per shot-step.
    from jets_tpu.ops.wave import multishot_wave_operator

    NSH = 16
    msrc = jnp.asarray(
        np.ravel_multi_index(
            (np.full(NSH, 128), np.full(NSH, 128),
             16 + 14 * np.arange(NSH)), wshape), jnp.int32)

    def ms_times(nt):
        F = multishot_wave_operator(
            wshape, msrc, nt=nt, dt=5e-4, dx=10.0, freq=15.0,
            rcv_idx=grcv, sponge_width=12, store_adjoint="int8",
            shot_map="map", dtype=jnp.float32)
        gf = jax.jit(lambda c: jnp.sum(F(c) ** 2))
        tf, _ = _timed(gf, (c0,))
        gg = jax.jit(lambda c: jnp.sum(F.linearize(c).H(
            jnp.ones((NSH, nt, grcv.shape[0]), jnp.float32))))
        tg, _ = _timed(gg, (c0,))
        return tf, tg

    msf_lo, msg_lo = ms_times(20)
    msf_hi, msg_hi = ms_times(120)
    ms_fwd_us = (msf_hi - msf_lo) / 100 / NSH * 1e6
    ms_grad_us = (msg_hi - msg_lo) / 100 / NSH * 1e6
    _stage(f"multishot done (fwd {ms_fwd_us:.0f}, grad {ms_grad_us:.0f} "
           "us/shot-step); TTI step")

    # ---- 3-D TTI coupled step (f32 and bf16-rounded coefficients)
    from jets_tpu.ops.wave import tti_wave_propagator

    def tti_time(nt, cd):
        F = tti_wave_propagator(wshape, nt=nt, dt=5e-4, dx=10.0, freq=15.0,
                                src_idx=7, sponge_width=12,
                                coeff_dtype=cd, dtype=jnp.float32)

        @jax.jit
        def build(v):
            full = lambda x: jnp.full(wshape, x, jnp.float32)  # noqa: E731
            m = F.dom.zeros()
            for i, val in enumerate((v, 0.1, 0.05, 0.2, 0.7)):
                m = m.setblock(i, full(val))
            return m

        g = jax.jit(lambda v: jnp.sum(F(build(v)) ** 2))
        t, _ = _timed(g, (jnp.float32(1500.0),))
        return t

    tti_step_us = (tti_time(60, None) - tti_time(10, None)) / 50 * 1e6
    _stage(f"TTI f32 step done ({tti_step_us:.0f} us/step); bf16 coeffs")
    tti16_step_us = (tti_time(60, jnp.bfloat16)
                     - tti_time(10, jnp.bfloat16)) / 50 * 1e6
    _stage(f"TTI bf16 step done ({tti16_step_us:.0f} us/step); VTI grad")

    # ---- anisotropic FWI gradient steps (stored-int8 sweeps). us per
    # time step of the whole gradient (both sweeps), marginal between nt
    # budgets; the summed return depends on EVERY gradient block (DCE
    # guard).
    from jets_tpu.ops.wave import vti_wave_propagator

    def aniso_grad_time(ctor, nt, vals, cd=None):
        extra = {} if cd is None else {"coeff_dtype": cd}
        F = ctor(wshape, nt=nt, store_adjoint="int8", **extra, **gkw)

        @jax.jit
        def g(v):
            full = lambda x: jnp.full(wshape, x, jnp.float32)  # noqa: E731
            m = F.dom.zeros().setblock(0, full(v))
            for b, val in enumerate(vals[1:], start=1):
                m = m.setblock(b, full(val))
            gb = F.linearize(m).H(
                jnp.ones((nt, grcv.shape[0]), jnp.float32))
            out = jnp.sum(gb.getblock(0))
            for b in range(1, len(vals)):
                out = out + jnp.sum(gb.getblock(b))
            return out

        t, _ = _timed(g, (jnp.float32(1500.0),))
        return t

    VVALS = (1500.0, 0.1, 0.05)
    TVALS = (1500.0, 0.1, 0.05, 0.2, 0.7)
    vti_grad_step_us = (aniso_grad_time(vti_wave_propagator, 160, VVALS)
                        - aniso_grad_time(vti_wave_propagator, 20, VVALS)
                        ) / 140 * 1e6
    _stage(f"VTI grad step done ({vti_grad_step_us:.0f} us/step); TTI grad")
    tti_grad_step_us = (aniso_grad_time(tti_wave_propagator, 60, TVALS)
                        - aniso_grad_time(tti_wave_propagator, 10, TVALS)
                        ) / 50 * 1e6
    _stage(f"TTI grad step done ({tti_grad_step_us:.0f} us/step); bf16")
    tti16_grad_step_us = (
        aniso_grad_time(tti_wave_propagator, 60, TVALS, jnp.bfloat16)
        - aniso_grad_time(tti_wave_propagator, 10, TVALS, jnp.bfloat16)
    ) / 50 * 1e6
    _stage(f"TTI bf16 grad done ({tti16_grad_step_us:.0f} us/step); matvec")

    # ---- matvec pairs/s (fused chained loop, marginal between trip counts)
    pair = jax.jit(
        lambda m, k: jnp.sum(
            lax.fori_loop(0, k, lambda i, v: A.H(A(v)) * (1.0 - 1e-9), m)
        )
    )
    t1, _ = _timed(pair, (m_true, 5))
    t2, _ = _timed(pair, (m_true, 2005))
    pair_ms = (t2 - t1) / 2000 * 1e3
    matvecs_per_s = 2 * 2000 / max(t2 - t1, 1e-9)
    _stage("matvec pair done; emitting result")

    resid_rel = float(res_hi.resnorm) / float(A.rng.norm(d_obs))

    print(
        json.dumps(
            {
                "metric": "lsqr_iterations_per_s",
                "value": round(iters_per_s, 3),
                "unit": "iter/s",
                "matvecs_per_s": round(matvecs_per_s, 3),
                "matvec_pair_ms": round(pair_ms, 4),
                "lsqr3d_iterations_per_s": round(iters3d_per_s, 3),
                "lsqr3d_iter_ms": round(1e3 / iters3d_per_s, 4),
                "config3d": "grid=(256,256,256), nshots=16, nrecv=4096, f32",
                "wave3d_step_us": round(wave_step_us, 2),
                "wave3d_gcell_steps_per_s": round(
                    256**3 / wave_step_us / 1e3, 2),
                "wave3d_grad_step_us": round(grad_step_us, 2),
                "ms3d_fwd_us_per_shot_step": round(ms_fwd_us, 2),
                "ms3d_grad_us_per_shot_step": round(ms_grad_us, 2),
                "ms3d_config": f"grid={wshape}, nshots=16, map+int8",
                "tti3d_step_us": round(tti_step_us, 2),
                "tti3d_bf16_step_us": round(tti16_step_us, 2),
                "vti3d_grad_step_us": round(vti_grad_step_us, 2),
                "tti3d_grad_step_us": round(tti_grad_step_us, 2),
                "tti3d_bf16_grad_step_us": round(tti16_grad_step_us, 2),
                "relative_residual": round(resid_rel, 6),
                "config": f"grid={GRID}, nshots={NSHOTS}, nrecv={NRECV}, f32",
                "device": _device_label(),
            }
        )
    )


if __name__ == "__main__":
    main()
