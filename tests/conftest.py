"""Test configuration: run on a virtual 8-device CPU mesh.

The sharding/collective paths are validated on
``xla_force_host_platform_device_count=8``; float64 is on for the
precision-sensitive gates. Tests marked ``gpu`` need the card and skip
here; on a machine with one they run with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# float64 for precision-sensitive gate tests (set the config flag directly,
# so an earlier jax import cannot preempt the environment variable).
jax.config.update("jax_enable_x64", True)
