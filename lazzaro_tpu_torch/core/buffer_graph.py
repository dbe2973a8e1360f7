"""Unified cross-shard graph view.

Counterpart of ``lazzaro_tpu/core/buffer_graph.py``: a composite view holding
references to the same shard/super-node dicts as MemorySystem.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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

    def size(self) -> Tuple[int, int]:
        nodes = sum(len(s.nodes) for s in self.shards.values())
        edges = sum(len(s.edges) for s in self.shards.values())
        return nodes, edges
