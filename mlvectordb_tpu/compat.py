"""Drop-in compatibility layer for code written against the reference package.

The reference's public API (reference: src/mlvectordb/__init__.py:11-29) exposes
``Vector``, ``VectorDTO``, ``StorageEngineInMemory``, ``Index``, ``QueryProcessor`` (the
latter constructed as ``QueryProcessor(storage, index)`` — server.py:54) plus the README's
``SimpleVector``.  This module re-exports the device-resident equivalents under those names,
including a QueryProcessor shim that accepts the reference's two-argument constructor, so

    from mlvectordb_tpu.compat import Index, QueryProcessor, StorageEngineInMemory
    qproc = QueryProcessor(StorageEngineInMemory(), Index())

works unchanged.  Note: the "index" and "storage" are the same device structure;
the shim wires whichever configuration the Index carries into the engine and ignores the
redundant coupling the reference needed (its QueryProcessor kept two stores consistent by
hand — SURVEY.md §3.4 shows how that went).
"""

from __future__ import annotations

from typing import Optional

from .config import DEFAULT_CONFIG, EngineConfig
from .engine.query_processor import QueryProcessor as _QueryProcessor
from .interfaces.vector import VectorDTO
from .store.index import SearchIndex as Index, SearchResult
from .store.storage import StorageEngine as StorageEngineInMemory
from .store.vector import Vector

# README's Quick Start uses SimpleVector with the same shape as Vector
SimpleVector = Vector


class QueryProcessor(_QueryProcessor):
    """Accepts the reference's (storage, index) pair or the native (storage, config)."""

    def __init__(self, storage=None, index=None, config: Optional[EngineConfig] = None):
        if config is None:
            # inherit the Index's config (metric default / rebuild threshold) if given
            config = getattr(index, "config", None) or getattr(
                storage, "config", DEFAULT_CONFIG
            )
            if index is not None and getattr(index, "_space", None):
                import dataclasses

                config = dataclasses.replace(config, default_metric=index._space)
        super().__init__(storage=storage, config=config)


__all__ = [
    "Vector",
    "SimpleVector",
    "VectorDTO",
    "StorageEngineInMemory",
    "Index",
    "SearchResult",
    "QueryProcessor",
]
