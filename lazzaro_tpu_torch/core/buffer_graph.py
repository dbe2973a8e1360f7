"""Unified cross-shard graph view.

Counterpart of ``lazzaro_tpu/core/buffer_graph.py``: a composite view holding
references to the same shard/super-node dicts as MemorySystem.
``get_connected_components`` walks an explicit stack, not a recursion, in
the JAX package's order (nodes shard by shard, neighbors in edge order), so
the components and the order of their members match it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

from lazzaro_tpu_torch.core.memory_shard import MemoryShard
from lazzaro_tpu_torch.models.graph import Edge, Node


class BufferGraph:
    def __init__(self, shards: Dict[str, MemoryShard], super_nodes: Dict[str, Node]):
        self.shards = shards
        self.super_nodes = super_nodes

    # -- merged views (rebuilt per access, like the reference :28-42) -------
    @property
    def nodes(self) -> Dict[str, Node]:
        merged: Dict[str, Node] = {}
        for shard in self.shards.values():
            merged.update(shard.nodes)
        merged.update(self.super_nodes)
        return merged

    @property
    def edges(self) -> Dict[Tuple[str, str], Edge]:
        merged: Dict[Tuple[str, str], Edge] = {}
        for shard in self.shards.values():
            merged.update(shard.edges)
        return merged

    # -- lookup -------------------------------------------------------------
    def get_node(self, node_id: str) -> Optional[Node]:
        if node_id in self.super_nodes:
            return self.super_nodes[node_id]
        for shard in self.shards.values():
            node = shard.nodes.get(node_id)
            if node is not None:
                return node
        return None

    def get_neighbors(self, node_id: str, min_weight: float = 0.0) -> List[str]:
        out: List[str] = []
        for shard in self.shards.values():
            out.extend(shard.get_neighbors(node_id, min_weight))
        return out

    def update_access(self, node_id: str, salience_boost: float = 0.05) -> None:
        node = self.get_node(node_id)
        if node is None:
            return
        node.access_count += 1
        node.salience = min(1.0, node.salience + salience_boost)
        node.last_accessed = time.time()

    def get_connected_components(self, min_weight: float = 0.0) -> List[Set[str]]:
        """Components of the bidirectional adjacency across all shards."""
        adjacency: Dict[str, List[str]] = {}
        for shard in self.shards.values():
            for (src, tgt), edge in shard.edges.items():
                if edge.weight < min_weight:
                    continue
                adjacency.setdefault(src, []).append(tgt)
                adjacency.setdefault(tgt, []).append(src)

        all_ids = [nid for shard in self.shards.values() for nid in shard.nodes]
        visited: Set[str] = set()
        components: List[Set[str]] = []
        for nid in all_ids:
            if nid in visited:
                continue
            component: Set[str] = set()
            stack = [nid]
            while stack:
                cur = stack.pop()
                if cur in visited:
                    continue
                visited.add(cur)
                component.add(cur)
                stack.extend(n for n in adjacency.get(cur, []) if n not in visited)
            components.append(component)
        return components

    def size(self) -> Tuple[int, int]:
        nodes = sum(len(s.nodes) for s in self.shards.values())
        edges = sum(len(s.edges) for s in self.shards.values())
        return nodes, edges

    def get_all_nodes_summary(self, truncate: int = 100) -> List[Dict]:
        """Timestamp-descending summaries, content truncated
        (``lazzaro_tpu/core/buffer_graph.py:get_all_nodes_summary``)."""
        rows = []
        for shard in self.shards.values():
            for node in shard.nodes.values():
                content = node.content
                if len(content) > truncate:
                    content = content[:truncate] + "..."
                rows.append({
                    "id": node.id,
                    "content": content,
                    "type": node.type,
                    "shard": node.shard_key,
                    "salience": node.salience,
                    "access_count": node.access_count,
                    "timestamp": node.timestamp,
                })
        rows.sort(key=lambda r: r["timestamp"], reverse=True)
        return rows
