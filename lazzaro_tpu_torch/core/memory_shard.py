"""Per-topic subgraph (host structural view).

Counterpart of ``lazzaro_tpu/core/memory_shard.py``. The shard is a
*structural* record: node/edge membership, ids, strings. Decay and prune run
batched on the device arena through ``MemorySystem``; the methods below
remain for API parity and for standalone host-only use.

``edges`` keeps a per-node index of its keys, so ``get_neighbors`` costs the
node's degree rather than a scan of every edge of the shard (a chat turn asks
for the neighbours of each retrieved node).
"""

from __future__ import annotations

import time
from typing import Dict, List, Set, Tuple

from lazzaro_tpu_torch.models.graph import Edge, Node


class _EdgeDict(dict):
    """``(src, tgt) -> Edge`` with ``by_node``: node id -> its edge keys."""

    def __init__(self):
        super().__init__()
        self.by_node: Dict[str, Set[Tuple[str, str]]] = {}

    def __setitem__(self, key, edge) -> None:
        super().__setitem__(key, edge)
        for nid in key:
            self.by_node.setdefault(nid, set()).add(key)

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        for nid in key:
            keys = self.by_node.get(nid)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self.by_node[nid]


class MemoryShard:
    def __init__(self, shard_key: str):
        self.shard_key = shard_key
        self.nodes: Dict[str, Node] = {}
        self.edges: Dict[Tuple[str, str], Edge] = _EdgeDict()
        self.last_accessed: float = time.time()
        self.access_count: int = 0

    def add_node(self, node: Node) -> None:
        node.shard_key = self.shard_key
        self.nodes[node.id] = node
        self.last_accessed = time.time()

    def add_edge(self, edge: Edge, reinforce: float = 0.1) -> None:
        """New edge, or reinforce an existing one: weight += 0.1 (capped 1.0),
        co_occurrence += 1 (reference memory_shard.py:42-52)."""
        key = (edge.source, edge.target)
        existing = self.edges.get(key)
        if existing is not None:
            existing.weight = min(1.0, existing.weight + reinforce)
            existing.co_occurrence += 1
            existing.last_updated = time.time()
        else:
            self.edges[key] = edge

    def get_neighbors(self, node_id: str, min_weight: float = 0.0) -> List[str]:
        """Bidirectional neighbor ids with weight >= min_weight."""
        out: List[str] = []
        for key in self.edges.by_node.get(node_id, ()):
            src, tgt = key
            if self.edges[key].weight < min_weight:
                continue
            if src == node_id:
                out.append(tgt)
            elif tgt == node_id:
                out.append(src)
        return out

    def size(self) -> Tuple[int, int]:
        return len(self.nodes), len(self.edges)
