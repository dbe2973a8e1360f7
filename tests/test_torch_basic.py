"""The port's version of ``tests/test_basic.py``: Node/Edge defaults and
round trips, ``MemorySystem`` constructor flags, the O(1) edge placement
cache and the packed one-copy readback's bit casts (``state.pack_leaves``
against the JAX package's ``fetch_packed``)."""

import time

import jax.numpy as jnp
import numpy as np
import torch

from lazzaro_tpu.utils.batching import fetch_packed
from lazzaro_tpu_torch import MemorySystem
from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.models.graph import Edge, Node


def test_node_defaults():
    node = Node(id="n1", content="hello")
    assert node.type == "semantic"
    assert node.salience == 0.5
    assert node.access_count == 0
    assert not node.is_super_node
    assert node.child_ids == []
    assert node.parent_id is None
    assert abs(node.timestamp - time.time()) < 5


def test_edge_defaults():
    edge = Edge(source="a", target="b")
    assert edge.weight == 0.5
    assert edge.edge_type == "relates_to"
    assert edge.co_occurrence == 1


def test_node_round_trip_filters_unknown_keys():
    d = Node(id="n1", content="x", salience=0.7).to_dict()
    d["unknown_future_field"] = 123
    node = Node.from_dict(d)
    assert node.id == "n1"
    assert node.salience == 0.7


def test_edge_round_trip():
    e = Edge(source="a", target="b", weight=0.9, edge_type="causes")
    e2 = Edge.from_dict({**e.to_dict(), "bogus": 1})
    assert e2.key == ("a", "b")
    assert e2.weight == 0.9
    assert e2.edge_type == "causes"


def test_memory_system_init_flags(tmp_db):
    ms = MemorySystem(enable_sharding=False, enable_hierarchy=False,
                      enable_caching=False, enable_async=False,
                      max_buffer_size=7, db_dir=tmp_db, load_from_disk=False,
                      verbose=False, device="cpu")
    assert ms.enable_sharding is False
    assert ms.enable_hierarchy is False
    assert ms.query_cache is None
    assert ms.background_executor is None
    assert ms.max_buffer_size == 7
    assert ms.vector_store is ms.store
    ms.close()


def test_default_construction_enables_cache_and_async(tmp_db):
    ms = MemorySystem(db_dir=tmp_db, load_from_disk=False, verbose=False,
                      device="cpu")
    try:
        assert ms.query_cache is not None
        assert ms.background_executor is not None
    finally:
        ms.close()


def test_edge_placement_cache_o1_and_self_healing(tmp_db):
    ms = MemorySystem(enable_async=False, db_dir=tmp_db, verbose=False,
                      load_from_disk=False, device="cpu")
    for i, sk in enumerate(["work", "personal", "health"]):
        n = Node(id=f"n{i}", content=f"content {i}", shard_key=sk)
        ms._get_or_create_shard(sk).add_node(n)
    ms._add_edges_batch([Edge(source="n0", target="n1", weight=0.9)])
    assert ms._edge_shard[("n0", "n1")] == "work"
    assert ms._find_edge(("n0", "n1")).weight == 0.9
    ms._add_edges_batch([Edge(source="n0", target="n1", weight=0.9)])
    assert len(ms.shards["work"].edges) == 1
    assert ms.shards["work"].edges[("n0", "n1")].co_occurrence == 2
    del ms.shards["work"].edges[("n0", "n1")]
    assert ms._find_edge(("n0", "n1")) is None
    assert ("n0", "n1") not in ms._edge_shard
    ms.close()


def test_pack_leaves_bitcast_round_trip_matches_fetch_packed():
    """Ints bit-cast through f32 round-trip exactly (negatives, sentinels,
    extremes); floats come back untouched, as JAX's ``fetch_packed``."""
    f = np.array([[1.5, -2.25], [3.0, float("-1e30")]], np.float32)
    i = np.array([[-1, 2147483647], [-2147483648, 0]], np.int32)
    f2 = np.array([[0.0, 1e-38], [np.pi, -0.0]], np.float32)
    host = S.pack_leaves([torch.from_numpy(x) for x in (f, i, f2)]).numpy()
    got = S.unpack_leaves(host, [True, False, True])
    want = fetch_packed(jnp.asarray(f), jnp.asarray(i), jnp.asarray(f2))
    for g, w, x in zip(got, want, (f, i, f2)):
        np.testing.assert_array_equal(g.view(np.int32), x.view(np.int32))
        np.testing.assert_array_equal(g.view(np.int32),
                                      np.asarray(w).view(np.int32))
        assert g.dtype == x.dtype
