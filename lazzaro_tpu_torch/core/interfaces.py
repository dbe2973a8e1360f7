"""Pluggable provider and storage protocols.

Counterpart of ``lazzaro_tpu/core/interfaces.py``. Any object with these
methods can serve as ``MemorySystem``'s LLM, embedder or store; the defaults
are the offline providers of ``lazzaro_tpu_torch.core.providers`` and
``lazzaro_tpu_torch.core.store.ArrowStore``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class LLMProvider(Protocol):
    """Chat-completion provider."""

    def completion(self, messages: List[Dict[str, str]],
                   response_format: Optional[Dict] = None) -> str:
        """Return the assistant message text for a chat transcript."""
        ...


@runtime_checkable
class EmbeddingProvider(Protocol):
    """Text → vector provider. ``dim`` is first-class (the reference hardcoded
    1536 into its store schema; see SURVEY §2.2 quirks)."""

    dim: int

    def embed(self, text: str) -> List[float]:
        ...

    def batch_embed(self, texts: List[str]) -> List[List[float]]:
        ...


@runtime_checkable
class Store(Protocol):
    """Durable persistence contract (11 methods). The search path does not
    go through the store, it reads the device arena; the store is the
    system of record for restarts and for readers polling
    ``get_latest_version``. A store that also has ``get_nodes_columns``,
    ``get_edges_columns``, ``save_sys_meta`` and ``load_sys_meta`` gets
    incremental saves and the columnar reload; ``MemorySystem`` opens its
    journals under the store's ``db_dir`` attribute when it has one."""

    def add_nodes(self, nodes: List[Dict[str, Any]], user_id: str = "default") -> None: ...

    def get_nodes(self, user_id: str = "default") -> List[Dict[str, Any]]: ...

    def search_nodes(self, embedding: List[float], user_id: str = "default",
                     limit: int = 10) -> List[str]: ...

    def delete_nodes(self, node_ids: List[str], user_id: str = "default") -> None: ...

    def get_latest_version(self) -> int: ...

    def add_edges(self, edges: List[Dict[str, Any]], user_id: str = "default") -> None: ...

    def get_edges(self, user_id: str = "default") -> List[Dict[str, Any]]: ...

    def delete_edges(self, edge_ids: List[str], user_id: str = "default") -> None: ...

    def save_profile(self, profile: Dict[str, Any], user_id: str = "default") -> None: ...

    def load_profile(self, user_id: str = "default") -> Optional[Dict[str, Any]]: ...

    def close(self) -> None: ...
