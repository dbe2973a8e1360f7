"""Pluggable provider protocols.

Counterpart of the provider half of ``lazzaro_tpu/core/interfaces.py``
(the store protocol comes with the persistent store, ROADMAP Queue 1 item
7). Any object with these methods can serve as ``MemorySystem``'s LLM or
embedder; the defaults are the offline providers of
``lazzaro_tpu_torch.core.providers``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, runtime_checkable


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
