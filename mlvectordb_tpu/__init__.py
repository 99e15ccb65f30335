"""mlvectordb_tpu — an accelerator-resident exact-kNN vector database engine.

Brand-new implementation of the capability surface of SudYar/MLVectorDB (see SURVEY.md):
namespaced vector storage with metadata, exact kNN / range / filtered-hybrid search over
cosine / euclidean / dot metrics, true batch upsert and delete, REST API, sharded
multi-device search, replication, and snapshots — built on JAX/XLA, with a Pallas-Triton
kernel for the certified sweep on NVIDIA GPUs.

Public API mirrors the reference package root (reference: src/mlvectordb/__init__.py:11-29,
which re-exports protocols + implementations).
"""

from .config import DEFAULT_CONFIG, EngineConfig, canonical_metric
from .interfaces import (
    QueryProcessorProtocol,
    SearchIndexProtocol,
    SearchResultProtocol,
    StorageEngineProtocol,
    VectorDTO,
    VectorProtocol,
)
from .store import DeviceState, NamespaceStore, SearchIndex, SearchResult, StorageEngine, Vector
from .engine import QueryProcessor

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "DEFAULT_CONFIG",
    "canonical_metric",
    "Vector",
    "VectorDTO",
    "VectorProtocol",
    "SearchResultProtocol",
    "SearchIndexProtocol",
    "StorageEngineProtocol",
    "QueryProcessorProtocol",
    "DeviceState",
    "NamespaceStore",
    "StorageEngine",
    "SearchIndex",
    "SearchResult",
    "QueryProcessor",
]
