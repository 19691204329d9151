"""Wave-propagator step-cost benchmark (marginal over two nt budgets).

Measures the ``ops/wave.py`` propagators on the backend JAX selects: the
marginal cost between two trip counts, each run ended by
``block_until_ready``, best of three runs after a warm-up.

Usage::

    python benchmarks/wave_step.py 2d          # 512^2 f32, nt 200/3200
    python benchmarks/wave_step.py 3d          # 256^3 f32, nt 20/220
    python benchmarks/wave_step.py 3d --physics vti

Prints ``us/step`` and ``Gcell*steps/s`` with the device it ran on.
"""
import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from jets_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dims", choices=["2d", "3d"])
    ap.add_argument("--physics", default="iso",
                    choices=["iso", "vti", "tti", "q", "vd", "vdq",
                             "cpml"])
    ap.add_argument("--order", type=int, default=2)
    args = ap.parse_args()
    enable_compile_cache()

    from jets_tpu.ops import wave as W

    if args.dims == "2d":
        shape, lo, hi = (512, 512), 200, 3200
    else:
        shape, lo, hi = (256, 256, 256), 20, 220

    mk = jax.jit(lambda b: jnp.zeros(shape, jnp.float32) + b)
    cs = [mk(jnp.float32(1500.0 + 10.0 * i)) for i in range(4)]
    for c in cs:
        c.block_until_ready()
    ncell = float(np.prod(shape))
    apply_j = jax.jit(lambda op, m: jnp.sum(op(m) ** 2))

    def build(nt):
        kw = dict(nt=nt, dt=5e-4, dx=10.0, freq=15.0, src_idx=7,
                  dtype=jnp.float32)
        if args.physics == "iso":
            return W.wave_propagator(
                shape, sponge_width=12, space_order=args.order, **kw)
        if args.physics == "vti":
            return W.vti_wave_propagator(
                shape, sponge_width=12, space_order=args.order, **kw)
        if args.physics == "tti":
            return W.tti_wave_propagator(
                shape, sponge_width=12, space_order=args.order, **kw)
        if args.physics == "q":
            return W.q_wave_propagator(
                shape, sponge_width=12, space_order=args.order, **kw)
        if args.physics == "vd":
            return W.vd_wave_propagator(shape, sponge_width=12, **kw)
        if args.physics == "vdq":
            return W.vdq_wave_propagator(shape, sponge_width=12, **kw)
        return W.cpml_wave_propagator(shape, pml_width=12,
                                      space_order=args.order, **kw)

    def model_for(F, c):
        from jets_tpu.core.blockspace import BlockSpace

        if not isinstance(F.dom, BlockSpace):
            return c
        m = F.dom.zeros().setblock(0, c)
        fills = {"vti": (0.1, 0.05),
                 "tti": ((0.1, 0.05, 0.2, 0.7)[:len(F.dom.spaces) - 1]),
                 "q": (50.0,), "vd": (1e-3,),
                 "vdq": (1e-3, 50.0)}[args.physics]
        for i, v in enumerate(fills, start=1):
            m = m.setblock(i, jnp.full(shape, v, jnp.float32))
        return m

    def run_for(nt):
        F = build(nt)

        def run(c):
            return jax.block_until_ready(apply_j(F, model_for(F, c)))

        run(cs[0])
        ts = []
        for c in cs[1:]:
            t0 = time.perf_counter()
            run(c)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_lo, t_hi = run_for(lo), run_for(hi)
    per_step = (t_hi - t_lo) / (hi - lo)
    print(f"{args.physics} {shape} order={args.order}: "
          f"{per_step*1e6:.2f} us/step  {ncell/per_step/1e9:.1f} "
          f"Gcell*steps/s  (device {jax.devices()[0]})")


if __name__ == "__main__":
    main()
