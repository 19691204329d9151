"""Observability — per-operator perf metrics and profiler traces.

The reference's only observability hooks are ``perfstat`` (author-overridable
per-operator metric object, ``src/Jets.jl:281``) and the PkgBenchmark
workflow. JAX equivalents:

* :func:`instrument` — attach a perfstat function reporting an analytic
  cost model (FLOPs, bytes moved) to any operator; combinators surface it
  through ``jets_tpu.perfstat`` exactly like the reference;
* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace of the wrapped region;
* :func:`op_cost` — analytic cost estimate from the operator's spaces
  (bandwidth-bound default: bytes in + bytes out).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import jax
import numpy as np

from ..core.jet import Operator, with_state

__all__ = ["op_cost", "instrument", "trace"]


def op_cost(op: Operator, *, flops_per_elem: float = 1.0) -> dict:
    """Analytic cost model from the operator's spaces: a bandwidth-bound
    apply reads the domain and writes the range once."""
    in_bytes = op.dom.size * np.dtype(op.dom.dtype).itemsize
    out_bytes = op.rng.size * np.dtype(op.rng.dtype).itemsize
    return {
        "bytes_in": int(in_bytes),
        "bytes_out": int(out_bytes),
        "bytes_total": int(in_bytes + out_bytes),
        "flops": float(flops_per_elem * max(op.dom.size, op.rng.size)),
    }


def instrument(op: Operator, stat_fn: Optional[Callable] = None) -> Operator:
    """Return a copy of ``op`` whose ``perfstat`` reports ``stat_fn(jet)``
    (default: the analytic :func:`op_cost`)."""
    from ..core.jet import AdjointOperator

    if isinstance(op, AdjointOperator):
        raise TypeError("instrument the underlying operator, not its adjoint")
    cost = op_cost(op)
    fn = stat_fn if stat_fn is not None else (lambda jet, _c=cost: _c)
    new_jet = op.jet.replace(perfstat=fn)
    return type(op)(new_jet)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region into ``logdir`` (TensorBoard / xprof readable):

    >>> with trace("/tmp/jets_trace"):
    ...     res = lsqr(A, b, maxiter=100)
    ...     jax.block_until_ready(res.x)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
