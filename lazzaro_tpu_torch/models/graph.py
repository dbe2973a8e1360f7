"""Host-side data model: atomic memory units and weighted associations.

Parity target: reference ``src/lazzaro/models/graph.py`` (Node :6-60, Edge :63-104).
The port keeps these as the *host view* of a memory; the numeric fields
(embedding, salience, timestamps, access counts) are mirrored into the
device-resident SoA arena (``lazzaro_tpu_torch.core.state.ArenaState``) where
all math runs. Strings (content, ids, shard keys) never leave the host.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

MEMORY_TYPES = ("semantic", "episodic", "procedural")


def _now() -> float:
    return time.time()


@dataclass(slots=True)
class Node:
    """One atomic memory.

    ``slots=True``: a 1M-node graph keeps 1M host mirrors; dropping the
    per-instance ``__dict__`` saves ~100 B/node (and the same again for
    edges) with no behavior change — nothing assigns ad-hoc attributes.

    ``embedding`` is a plain list/np.ndarray on the host; the authoritative,
    L2-normalized copy used for retrieval lives in the device arena at row
    ``arena_row`` (managed by MemorySystem, not serialized).
    """

    id: str
    content: str
    embedding: Optional[Sequence[float]] = None
    type: str = "semantic"  # semantic | episodic | procedural
    timestamp: float = field(default_factory=_now)
    access_count: int = 0
    last_accessed: float = field(default_factory=_now)
    salience: float = 0.5  # in [0, 1]
    is_super_node: bool = False
    child_ids: List[str] = field(default_factory=list)
    parent_id: Optional[str] = None
    shard_key: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d.get("embedding") is not None:
            d["embedding"] = [float(x) for x in d["embedding"]]
        return d

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Node":
        # unknown keys are dropped, so snapshots of other versions load
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclass(slots=True)
class Edge:
    """Directed, weighted association between two memories."""

    source: str
    target: str
    weight: float = 0.5  # in [0, 1]
    edge_type: str = "relates_to"
    co_occurrence: int = 1
    last_updated: float = field(default_factory=_now)
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> tuple:
        return (self.source, self.target)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Edge":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})
