"""Multi-host (multi-process) execution layer.

The reference is single-process, single-thread (SURVEY.md §2b); the
north-star scaling target ("≥80% efficiency at 2+ hosts") needs real
cross-process execution. This module is the thin, framework-owned layer
over ``jax.distributed``: every process runs the SAME program over one
global mesh; arrays are assembled from process-local shards and all
cross-host traffic is XLA collectives (psum / ppermute / all_gather) —
Gloo on CPU hosts, NCCL on GPU hosts. The sharded entry points in
``parallel.sharded`` / ``parallel.ba_dist`` / ``parallel.ba_multiview``
work unchanged: they are shard_map programs over a Mesh and never ask
whether mesh devices are local.

Verified cross-process by ``tools/multihost_bench.py`` (2 pinned CPU
processes, Gloo backend), recorded in MULTIHOST.json and gated by
``tests/test_multihost.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-process runtime. Arguments default to the
    ``STEREO_COORDINATOR`` / ``STEREO_NUM_PROCESSES`` / ``STEREO_PROCESS_ID``
    environment variables (set by the launcher, e.g.
    tools/multihost_bench.py); under a cluster manager JAX knows
    (e.g. SLURM) all three are auto-detected and may stay None."""
    kwargs = {}
    coord = coordinator_address or os.environ.get("STEREO_COORDINATOR")
    if coord:
        kwargs["coordinator_address"] = coord
    n = num_processes if num_processes is not None else os.environ.get(
        "STEREO_NUM_PROCESSES")
    if n is not None:
        kwargs["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get(
        "STEREO_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def global_mesh(data: int = 1, tile: int = 1) -> Mesh:
    """One ``("data", "tile")`` mesh over ALL processes' devices (same
    axis names as parallel.mesh.make_mesh, which builds the
    single-process variant)."""
    devices = sorted(jax.devices(), key=lambda d: d.id)
    if data * tile != len(devices):
        raise ValueError(
            f"mesh {data}x{tile} != {len(devices)} global devices")
    return Mesh(np.asarray(devices).reshape(data, tile), ("data", "tile"))


def from_local_shards(local: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Assemble a global array from this process's shard (the multi-host
    analog of ``jnp.asarray``: each host contributes the rows of the
    batch/tile axes it owns)."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local)


def replicate(value: np.ndarray, mesh: Mesh) -> jax.Array:
    """A fully-replicated global array (same bytes on every process)."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), np.asarray(value))


def gather(arr: jax.Array) -> np.ndarray:
    """Fetch a (possibly non-addressable) global array to every host."""
    from jax.experimental import multihost_utils

    if arr.sharding.is_fully_replicated:
        try:
            return np.asarray(arr)
        except RuntimeError:
            pass
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
