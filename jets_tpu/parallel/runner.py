"""Multi-host runner utilities.

The reference family's distribution story (DistributedJets.jl) places block
rows on remote Julia workers and loads each worker's shot gathers locally.
The JAX equivalent: one JAX process per host, a global mesh over every
device, the stacked block (shot) axis sharded across it, and each host
reading ONLY the shot gathers whose blocks live on its devices (host-local
IO; SURVEY §2 ledger / §7 build plan).

Single-host sessions work unchanged: :func:`init_distributed` is a no-op
without coordinator env vars, and :func:`local_block_range` returns the
full range.

Typical multi-host entrypoint::

    from jets_tpu.parallel import runner, sharded

    runner.init_distributed()                  # reads the coordinator env
    mesh = sharded.make_block_mesh()           # all devices, "block" axis
    lo, hi = runner.local_block_range(nshots, mesh)
    d_local = store.read_shots(lo, hi)         # host-local IO
    d = runner.assemble_global(d_local, (nshots, *shot_shape), mesh)
    res = lsqr(A, d, ...)                      # unchanged solver
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_distributed",
    "local_block_range",
    "assemble_global",
    "distribute_blocks",
    "replicate_global",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize multi-process JAX across hosts.

    Arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``).
    With no coordinator address a single-process session is left
    untouched. Returns the process index.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes or _int_env("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")
    if addr is not None:
        jax.distributed.initialize(
            coordinator_address=addr, num_processes=nproc, process_id=pid
        )
    return jax.process_index()


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def local_block_range(
    nblocks: int, mesh: Mesh, axis: str = "block"
) -> Tuple[int, int]:
    """The contiguous ``[lo, hi)`` range of block indices whose shards live
    on THIS process's devices — the set of shot gathers this host must load.

    Blocks are laid out contiguously over the mesh axis (the
    ``NamedSharding(mesh, P(axis))`` layout used by
    :func:`~jets_tpu.parallel.sharded.shard_blocks`).
    """
    ax_size = mesh.shape[axis]
    if nblocks % ax_size:
        raise ValueError(f"nblocks {nblocks} not divisible by mesh axis {ax_size}")
    per_dev = nblocks // ax_size
    # mesh axis positions of this process's addressable devices
    axis_idx = list(mesh.axis_names).index(axis)
    devs = np.asarray(mesh.devices)
    local = set(jax.local_devices())
    local_pos = sorted(
        {
            idx[axis_idx]
            for idx in np.ndindex(devs.shape)
            if devs[idx] in local
        }
    )
    if not local_pos:
        return 0, 0
    lo, hi = local_pos[0], local_pos[-1] + 1
    if local_pos != list(range(lo, hi)):
        raise ValueError(
            "this host's devices are not contiguous on the block axis; "
            "use a mesh built from jax.devices() default order"
        )
    return lo * per_dev, hi * per_dev


def distribute_blocks(x, mesh: Mesh, axis: str = "block") -> jax.Array:
    """Place a FULL stacked block array (available on every process) with
    its leading axis sharded over the mesh — the multi-process-safe
    counterpart of :func:`~jets_tpu.parallel.sharded.shard_blocks`.

    Uses ``jax.make_array_from_callback`` so each process materializes only
    the shards its own devices hold; on a single process this degenerates to
    an ordinary committed ``device_put``. Use :func:`assemble_global` instead
    when each host only HAS its local slab (host-local IO)."""
    x = np.asarray(x)
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def replicate_global(x, mesh: Mesh) -> jax.Array:
    """Replicate an array (identical on every process) across the whole
    mesh — multi-process-safe (each process supplies its local copies)."""
    x = np.asarray(x)
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def assemble_global(
    local_blocks,
    global_shape: Sequence[int],
    mesh: Mesh,
    axis: str = "block",
) -> jax.Array:
    """Build a globally-sharded stacked block array from THIS host's block
    slab (``local_blocks``, the ``[lo, hi)`` range of
    :func:`local_block_range`). Every host calls this with its own slab;
    no cross-host data movement happens (each shard is placed on the local
    devices that own it)."""
    sharding = NamedSharding(mesh, P(axis))
    local_blocks = np.asarray(local_blocks)
    return jax.make_array_from_process_local_data(
        sharding, local_blocks, tuple(global_shape)
    )
