"""JAX's persistent compilation cache, in one place for every entry point.

A cold 3-D propagator or LSQR program takes seconds to minutes to compile;
with the cache on, a rerun of the same program on the same machine starts
in seconds. The cache key includes the directory, so the directory is a
fixed path: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads the
variable itself, so nothing is set in code), else ``<checkout>/.jax_cache``.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]


def enable_compile_cache() -> str:
    """Turn the persistent cache on (for programs that take at least a
    second to compile) and return its directory. With
    ``$JAX_COMPILATION_CACHE_DIR`` set this only reports it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
