"""Distribution layer: mesh, sharding, replication, sharded stores.

Realizes the reference's README-only ShardingManager / ReplicationManager stubs
(SURVEY.md §0.1, §2.2) on jax.sharding.Mesh + shard_map with XLA collectives as the
communication backend.
"""

from __future__ import annotations

from typing import Optional

from ..config import DEFAULT_CONFIG, EngineConfig
from ..engine.query_processor import QueryProcessor
from ..store.storage import StorageEngine
from .mesh import REPLICA_AXIS, SHARD_AXIS, build_mesh, single_device_mesh
from .replication import ReplicationManager
from .sharding import ShardingManager, merge_shard_results
from .store import ShardedNamespaceStore

__all__ = [
    "REPLICA_AXIS",
    "SHARD_AXIS",
    "build_mesh",
    "single_device_mesh",
    "ShardingManager",
    "ReplicationManager",
    "ShardedNamespaceStore",
    "merge_shard_results",
    "make_distributed_processor",
]


def make_distributed_processor(
    n_replicas: int = 1,
    n_shards: Optional[int] = None,
    config: EngineConfig = DEFAULT_CONFIG,
    mesh=None,
    host_mirror: bool = True,
) -> QueryProcessor:
    """A QueryProcessor whose namespaces are sharded/replicated across the mesh.

    The returned processor has ``.sharding_manager`` and ``.replication_manager``
    attached; every namespace it creates is a ShardedNamespaceStore.
    """
    mesh = mesh if mesh is not None else build_mesh(n_replicas, n_shards)
    sm = ShardingManager(mesh, config)
    rm = ReplicationManager(mesh)
    storage = StorageEngine(
        config,
        host_mirror=host_mirror,
        namespace_factory=lambda name: ShardedNamespaceStore(name, sm, config, host_mirror),
    )
    qp = QueryProcessor(storage, config)
    qp.sharding_manager = sm
    qp.replication_manager = rm
    return qp
