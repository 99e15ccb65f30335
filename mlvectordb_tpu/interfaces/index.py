"""Search-index contract.

Capability parity: reference src/mlvectordb/interfaces/index.py:5-13 (SearchResultProtocol,
IndexProtocol.add/remove/search/rebuild).  On the device the "index" is not a graph: exact kNN over
the namespace matrix is faster than HNSW graph walks, so the index collapses into the store
and ``search`` is a fused distance+top-k kernel.  The protocol survives so alternative
backends (e.g. an IVF-style partitioned index) can slot in later.
"""

from __future__ import annotations

import uuid
from typing import Iterable, List, Optional, Protocol, Sequence, runtime_checkable

from .vector import VectorProtocol


@runtime_checkable
class SearchResultProtocol(Protocol):
    @property
    def vector_id(self) -> uuid.UUID: ...

    @property
    def score(self) -> float: ...


@runtime_checkable
class SearchIndexProtocol(Protocol):
    def add(self, vectors: Sequence[VectorProtocol], namespace: str = "default") -> None: ...

    def remove(self, vector_ids: Iterable[uuid.UUID], namespace: str = "default") -> None: ...

    def search(
        self,
        query,
        k: int,
        namespace: str = "default",
        metric: Optional[str] = None,
    ) -> List[SearchResultProtocol]: ...

    def rebuild(self, namespace: Optional[str] = None) -> None:
        """Compact tombstones.  Per-namespace only — must never clear other namespaces
        (the reference's rebuild wipes every namespace's bookkeeping,
        reference: src/mlvectordb/implementations/index.py:136-143; SURVEY.md §3.4)."""
        ...
