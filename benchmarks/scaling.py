"""Scaling-efficiency harness — iterations/s at 1, 2, 4, ... devices
(the BASELINE target: ≥80% iterations/s scaling efficiency at N≥2 hosts).

The contract is WEAK scaling, which is what block (shot) parallelism
promises: each device carries a FIXED number of shots (``--shots`` is the
per-device count), so an N-device run solves an N×-larger multi-shot
problem, and efficiency is simply ``iters_per_s(N) / iters_per_s(1)`` —
it measures exactly the per-iteration cost added by the collectives (the
two psum/all-reduce rounds of the LSQR body). Strong scaling of a
fixed-size Krylov solve is NOT the target: an iteration is a sequential
critical path, and the per-iteration work here is HBM-bound model sweeps
that do not shrink with more shots' devices.

On several GPUs this measures the scaling of the distributed LSQR
(block-sharded shots, psum adjoint). On one machine without them, run it
on the virtual CPU backend to validate the harness and the collective
paths — NOTE the virtual devices share one host's cores, so N× the work
on the same silicon cannot hold iters/s constant; the virtual-CPU curve
validates correctness/structure, not interconnect bandwidth:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --grid 256 --shots 4

Timing: marginal cost between two iteration budgets, each run ended by a
scalar host read.
"""
import argparse
import json
import time

import jax

import jax.numpy as jnp

from jets_tpu.models.seismic import make_seismic_problem
from jets_tpu.parallel.sharded import make_block_mesh, shard_blocks
from jets_tpu.solvers import lsqr
from jets_tpu.utils.compile_cache import enable_compile_cache


def _marginal_iters_per_s(A, d_obs, lo, hi, mesh=None):
    bs = [d_obs] * 4
    if mesh is not None:
        bs = [shard_blocks(b, mesh) for b in bs]
    jax.block_until_ready(bs)

    def timed(maxiter):
        r = lsqr(A, bs[0], maxiter=maxiter, tol=0.0)
        float(r.resnorm)
        ts = []
        for b in bs[1:]:
            t0 = time.perf_counter()
            r = lsqr(A, b, maxiter=maxiter, tol=0.0)
            float(r.resnorm)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_lo = timed(lo)
    t_hi = timed(hi)
    return (hi - lo) / max(t_hi - t_lo, 1e-9)


_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8,
                "c64": 8, "c128": 16}


def _shape_bytes(tok: str) -> int:
    """Bytes of one HLO shape token like ``f32[24,16]{1,0}``."""
    import re

    m = re.match(r"([a-z0-9]+)\[([\d,]*)\]", tok)
    if not m:
        return 0
    dt, dims = m.groups()
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dt, 4)


def hlo_collective_audit(hlo_text: str):
    """Count collectives (and their payload bytes) per HLO computation in
    an optimized module, highlighting while-loop bodies — the measurable
    form of 'k collective rounds per solver iteration'."""
    import re

    kinds = ("all-reduce", "all-gather", "reduce-scatter",
             "collective-permute", "all-to-all")
    cur = None
    per_comp = {}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if ls.endswith("{") and "->" in ls and "(" in ls:
            cur = ls.split()[0].lstrip("%")
            continue
        for kind in kinds:
            if re.search(rf"\b{kind}(?:-start|-done)?\(", ls) and "=" in ls:
                if f"{kind}-done" in ls:
                    continue  # count start/done pairs once
                lhs = ls.split("=", 1)[0]
                shp = ls.split("=", 1)[1].strip()
                # result shape: possibly a tuple "(f32[..], f32[..])"
                mt = re.match(r"\(([^)]*)\)", shp)
                toks = ([t.strip() for t in mt.group(1).split(",") if "[" in t]
                        if mt else [shp.split()[0]])
                nb = sum(_shape_bytes(t) for t in toks)
                d = per_comp.setdefault(cur or "entry",
                                        {k: 0 for k in kinds} | {"bytes": 0})
                d[kind] += 1
                d["bytes"] += nb
    # surface loop bodies (they run once PER ITERATION): read them off the
    # while instructions' body= attributes
    body_names = set(re.findall(r"body=%([\w\.\-]+)", hlo_text))
    bodies = {k: v for k, v in per_comp.items() if k in body_names}
    return {"per_iteration_bodies": bodies, "all_computations": per_comp}


def audit_distributed_lsqr(n_devices: int = 8):
    """Compile the three distribution paths on the virtual mesh and report
    collectives per solver iteration / per FWI gradient step."""
    import numpy as np

    from jets_tpu.ops.wave import multishot_wave_operator
    from jets_tpu.parallel.gspmd import (make_mesh_2d, shard_data,
                                         shard_model)

    out = {}
    mesh = make_block_mesh(n_devices)
    A, _, d = make_seismic_problem((64, 64), n_devices * 2, 64, seed=0,
                                   mesh=mesh, dtype=jnp.float32)
    db = shard_blocks(d, mesh)
    txt = jax.jit(
        lambda b: lsqr(A, b, maxiter=5, tol=0.0).resnorm
    ).lower(db).compile().as_text()
    out["shard_map_lsqr"] = hlo_collective_audit(txt)["per_iteration_bodies"]

    if n_devices % 2 == 0:
        mesh2 = make_mesh_2d(n_devices // 2, 2)
        A2, _, d2 = make_seismic_problem((64, 64), n_devices * 2, 64,
                                         seed=0, dtype=jnp.float32)
        txt2 = jax.jit(
            lambda b, x0: lsqr(A2, b, x0=x0, maxiter=5, tol=0.0).resnorm
        ).lower(shard_data(d2, mesh2),
                shard_model(A2.dom.zeros(), mesh2)).compile().as_text()
        out["gspmd_2d_lsqr"] = \
            hlo_collective_audit(txt2)["per_iteration_bodies"]

    grid = (16, 16)
    srcs = jnp.asarray(np.ravel_multi_index(
        (np.full(n_devices, 8), 2 + np.arange(n_devices) % 12), grid),
        jnp.int32)
    Fw = multishot_wave_operator(
        grid, srcs, nt=12, dt=8e-4, dx=10.0, freq=18.0, sponge_width=3,
        store_adjoint="int8", mesh=mesh, shot_map="map", dtype=jnp.float32)
    c0 = jnp.full(grid, 1500.0, jnp.float32)
    dobs = Fw(c0 * 1.02)
    txt3 = jax.jit(
        lambda c, do: jnp.sum(Fw.linearize(c).H(Fw(c) - do))
    ).lower(c0, dobs).compile().as_text()
    a3 = hlo_collective_audit(txt3)
    # one psum per gradient — it is OUTSIDE the time loop (whole-program
    # count is the meaningful number here)
    tot = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                          "collective-permute", "all-to-all")}
    tot["bytes"] = 0
    for comp in a3["all_computations"].values():
        for k in tot:
            tot[k] += comp[k]
    out["map_mode_fwi_gradient_whole_program"] = tot

    # --- grid-sharded 3-D wave step: HALO traffic per time step, from the
    # compiled while-loop body of the GSPMD XLA step
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jets_tpu.ops.wave import wave_propagator

    gmesh = make_block_mesh(n_devices, axis="grid")
    ws = NamedSharding(gmesh, P("grid"))
    wshape = (8 * n_devices, 8, 128)
    wsrc = int(np.ravel_multi_index((4 * n_devices, 4, 64), wshape))
    wkw = dict(nt=16, dt=8e-4, dx=10.0, freq=18.0, src_idx=wsrc,
               sponge_width=3, dtype=jnp.float32)
    cg = jax.device_put(jnp.full(wshape, 1500.0, jnp.float32), ws)

    def _body_totals(txt):
        a = hlo_collective_audit(txt)["per_iteration_bodies"]
        t = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "collective-permute", "all-to-all")}
        t["bytes"] = 0
        for comp in a.values():
            for k in t:
                t[k] += comp[k]
        return t

    Fg = wave_propagator(wshape, wavefield_sharding=ws, **wkw)
    txtg = jax.jit(lambda c: Fg(c)).lower(cg).compile().as_text()
    out["grid_sharded_wave_step_halo_xla"] = _body_totals(txtg)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--shots", type=int, default=8,
                    help="shots PER DEVICE (weak scaling)")
    ap.add_argument("--nrecv", type=int, default=1024)
    ap.add_argument("--lo", type=int, default=50)
    ap.add_argument("--hi", type=int, default=550)
    ap.add_argument("--counts", type=str, default="",
                    help="comma-separated device counts (default: powers of 2)")
    ap.add_argument("--audit", action="store_true",
                    help="compile the distributed paths and report "
                         "collectives/bytes per solver iteration from the "
                         "optimized HLO (checkable on the virtual mesh)")
    args = ap.parse_args()
    enable_compile_cache()

    if args.audit:
        print(json.dumps(audit_distributed_lsqr(
            min(8, len(jax.devices()))), indent=1))
        return

    n_avail = len(jax.devices())
    if args.counts:
        counts = [int(c) for c in args.counts.split(",")]
    else:
        counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    rows = []
    base = None
    for n in counts:
        mesh = make_block_mesh(n) if n > 1 else None
        nshots = args.shots * n  # weak scaling: fixed per-device shot count
        A, m_true, d_obs = make_seismic_problem(
            (args.grid, args.grid), nshots, args.nrecv, seed=0,
            mesh=mesh, noise=0.05, dtype=jnp.float32,
        )
        ips = _marginal_iters_per_s(A, d_obs, args.lo, args.hi, mesh=mesh)
        if base is None:
            base = ips
        eff = ips / base  # weak-scaling efficiency: iters/s vs 1 device
        rows.append({"devices": n, "shots": nshots,
                     "iters_per_s": round(ips, 2),
                     "scaling_efficiency": round(eff, 3)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "metric": "lsqr_weak_scaling_iters_per_s",
        "shots_per_device": args.shots,
        "grid": args.grid,
        "device": str(jax.devices()[0].platform),
        "note": ("virtual-CPU devices share one host's cores: the curve "
                 "validates the collective structure, not interconnect "
                 "bandwidth"
                 if jax.devices()[0].platform == "cpu" else
                 str(jax.devices()[0].device_kind)),
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
