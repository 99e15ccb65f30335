"""Device-mesh construction for the distributed engine.

The mesh has two named axes:
  * "replica" — query-data-parallel: each replica group serves a disjoint slice of the
    query batch against a full (replicated) copy of the database.  This is how replicas
    buy QPS and fault tolerance.
  * "shard"   — database-parallel: each shard holds a contiguous slot range of every
    namespace; a search runs shard-local exact kNN and merges top-k across devices.

The reference has no distribution at all — ShardingManager/ReplicationManager exist only
as README mermaid stubs (SURVEY.md §0.1, §2.2); this package realizes them on
jax.sharding.Mesh + shard_map with XLA collectives as the communication backend (XLA
lowers them to NCCL on GPUs — SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

REPLICA_AXIS = "replica"
SHARD_AXIS = "shard"


def build_mesh(
    n_replicas: int = 1,
    n_shards: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A (replica, shard) mesh over the given devices (default: all local devices).

    ``n_shards=None`` uses every remaining device for the shard axis.
    """
    devs = list(devices) if devices is not None else list(jax.devices())
    if n_shards is None:
        if len(devs) % n_replicas:
            raise ValueError(f"{len(devs)} devices not divisible by {n_replicas} replicas")
        n_shards = len(devs) // n_replicas
    need = n_replicas * n_shards
    if need > len(devs):
        raise ValueError(f"mesh {n_replicas}x{n_shards} needs {need} devices, have {len(devs)}")
    grid = np.array(devs[:need]).reshape(n_replicas, n_shards)
    return Mesh(grid, (REPLICA_AXIS, SHARD_AXIS))


def single_device_mesh() -> Mesh:
    return build_mesh(1, 1)
