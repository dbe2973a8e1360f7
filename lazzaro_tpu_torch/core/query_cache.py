"""Thread-safe LRU cache for embeddings and retrieval results.

Parity target: reference ``core/query_cache.py`` (59 LoC). Differences by
design: result entries are LRU-evicted too (the reference's ``set_results``
never evicts — SURVEY §2.2 quirk list says fix it), and keys use
blake2b instead of MD5 (same role, faster, no deprecation warnings).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional


def _key(text: str) -> str:
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


def _result_key(query: str, tenant: Optional[str]) -> str:
    """Result keys fold the tenant in (NUL never appears in tenant ids,
    so the pair can't collide with a crafted query): two tenants asking
    the SAME question must never see each other's node ids. Embedding
    keys stay text-only — an embedding is tenant-free."""
    return _key(query if tenant is None else f"{tenant}\x00{query}")


class QueryCache:
    def __init__(self, max_size: int = 1000):
        self.max_size = max_size
        self._embeddings: OrderedDict[str, List[float]] = OrderedDict()
        self._results: OrderedDict[str, List[str]] = OrderedDict()
        # result key → owning tenant, so mutations in one tenant's graph
        # (prune, eviction) don't flush every other tenant's entries
        self._result_tenant: dict = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    # -- embeddings ---------------------------------------------------------
    def get_embedding(self, text: str) -> Optional[List[float]]:
        k = _key(text)
        with self._lock:
            if k in self._embeddings:
                self._embeddings.move_to_end(k)
                self.hits += 1
                return self._embeddings[k]
            self.misses += 1
            return None

    def set_embedding(self, text: str, embedding: List[float]) -> None:
        k = _key(text)
        with self._lock:
            self._embeddings[k] = embedding
            self._embeddings.move_to_end(k)
            while len(self._embeddings) > self.max_size:
                self._embeddings.popitem(last=False)

    # -- retrieval results --------------------------------------------------
    def get_results(self, query: str,
                    tenant: Optional[str] = None) -> Optional[List[str]]:
        k = _result_key(query, tenant)
        with self._lock:
            if k in self._results:
                self._results.move_to_end(k)
                self.hits += 1
                return self._results[k]
            self.misses += 1
            return None

    def set_results(self, query: str, results: List[str],
                    tenant: Optional[str] = None) -> None:
        k = _result_key(query, tenant)
        with self._lock:
            self._results[k] = results
            self._results.move_to_end(k)
            if tenant is not None:
                self._result_tenant[k] = tenant
            else:
                self._result_tenant.pop(k, None)
            while len(self._results) > self.max_size:
                old, _ = self._results.popitem(last=False)
                self._result_tenant.pop(old, None)

    def invalidate_results(self, tenant: Optional[str] = None) -> None:
        """Drop cached retrievals (called after graph mutations so stale id
        lists don't outlive the nodes they point to). With ``tenant`` the
        flush is scoped to that tenant's entries —
        untagged entries are dropped either way, since their owner is
        unknown."""
        with self._lock:
            if tenant is None:
                self._results.clear()
                self._result_tenant.clear()
                return
            for k in list(self._results):
                if self._result_tenant.get(k, tenant) == tenant:
                    del self._results[k]
                    self._result_tenant.pop(k, None)

    def get_hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
