"""Checkpoint / resume — solver-state and model-vector persistence.

The reference has no in-repo checkpointing (SURVEY §5); its only germ is the
CRC32C content hash. The framework makes checkpointing first-class:
Krylov solver states (:class:`~jets_tpu.solvers.krylov.LSQRState` etc.) are
plain pytrees, so saving/restoring is pytree serialization plus an integrity
hash. A restored state passes straight back into the solver's ``state=``
argument to resume.

Two backends:

* **npz** (:func:`save_checkpoint` / :func:`load_checkpoint`) — a single
  file with host-numpy leaves, json treedef, and the CRC32C content hash
  validated on load; zero extra dependencies, ideal for solver states;
* **orbax** (:func:`save_checkpoint_orbax` / :func:`load_checkpoint_orbax`)
  — directory-format checkpoints through ``orbax.checkpoint``, the
  production path for LARGE / SHARDED model vectors: leaves keep their
  ``jax.sharding`` on restore, saves are async-capable and multi-host
  coordinated (each host writes its own shards).
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import tree_hash

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_orbax",
    "load_checkpoint_orbax",
]


def save_checkpoint(path: str, tree: Any, *, meta: dict | None = None) -> int:
    """Serialize a pytree (solver state, model vector, ...) to ``path``.

    Returns the CRC32C content hash stored alongside the data.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    h = tree_hash(tree)
    payload = {
        f"leaf_{i}": np.asarray(jax.device_get(leaf)) for i, leaf in enumerate(leaves)
    }
    payload["__treedef__"] = np.frombuffer(
        repr(treedef).encode(), dtype=np.uint8
    )
    payload["__meta__"] = np.frombuffer(
        json.dumps({"crc32c": h, **(meta or {})}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return h


def load_checkpoint(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore a pytree saved by :func:`save_checkpoint`.

    ``like`` provides the pytree structure (e.g. a state from a dry run of
    the solver with ``maxiter=0``-style shapes, or the previous state
    object). Returns ``(tree, meta)``; raises if the stored content hash
    does not match the restored data (corruption / dtype drift).
    """
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
    _, treedef = jax.tree_util.tree_flatten(like)
    tree = jax.tree_util.tree_unflatten(treedef, leaves)
    h = tree_hash(tree)
    if h != meta["crc32c"]:
        raise ValueError(
            f"checkpoint {path}: content hash mismatch "
            f"(stored {meta['crc32c']}, restored {h})"
        )
    return tree, meta


def save_checkpoint_orbax(path: str, tree: Any) -> None:
    """Save a pytree (possibly with SHARDED leaves) as an orbax directory
    checkpoint. On multi-host meshes every host writes only its own shards;
    restore with :func:`load_checkpoint_orbax` to get the shardings back."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), tree, force=True)


def load_checkpoint_orbax(path: str, like: Any) -> Any:
    """Restore an orbax checkpoint written by :func:`save_checkpoint_orbax`.

    ``like`` supplies the target structure; leaves that are jax arrays are
    restored with the sharding of the corresponding ``like`` leaf (pass
    sharded zeros to reshard on load)."""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as ckptr:
        restore_args = jax.tree_util.tree_map(
            lambda x: ocp.ArrayRestoreArgs(sharding=x.sharding)
            if isinstance(x, jax.Array)
            else ocp.RestoreArgs(),
            like,
        )
        return ckptr.restore(
            os.path.abspath(path),
            args=ocp.args.PyTreeRestore(
                item=like,
                restore_args=restore_args,
            ),
        )
