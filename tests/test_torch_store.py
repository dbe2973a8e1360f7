"""The port's ``ArrowStore`` against the JAX package's: every case of
``tests/test_store.py`` and ``tests/test_store_segments.py`` runs the same
operations through both stores, each in its own directory, and must give
the same reads; each directory must then read the same through the other
package's store (one on-disk format)."""

import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from lazzaro_tpu.core.store import ArrowStore as JaxStore
from lazzaro_tpu_torch.core import store as store_mod
from lazzaro_tpu_torch.core.store import ArrowStore


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    """Rows default their times to now: one clock for both stores."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


def make_node(i, dim=4):
    emb = [0.0] * dim
    emb[i % dim] = 1.0
    return {"id": f"node_{i}", "content": f"content {i}", "embedding": emb,
            "type": "semantic", "salience": 0.5, "shard_key": "default",
            "child_ids": [], "metadata": {"k": i}}


def _node(i, dim=4, **kw):
    row = {"id": f"node_{i}", "content": f"fact {i}",
           "embedding": [float(i)] * dim, "salience": 0.5}
    row.update(kw)
    return row


def _manifest(store, table="nodes", user="default"):
    with open(store._manifest_path(table, user)) as f:
        return json.load(f)


# ------------------------------------------------ tests/test_store.py cases
def node_round_trip(store):
    store.add_nodes([make_node(1), make_node(2)], user_id="u1")
    rows = store.get_nodes(user_id="u1")
    assert {r["id"] for r in rows} == {"node_1", "node_2"}
    r1 = next(r for r in rows if r["id"] == "node_1")
    assert r1["content"] == "content 1"
    assert r1["metadata"] == {"k": 1}
    assert r1["child_ids"] == []
    return rows


def add_nodes_upserts(store):
    store.add_nodes([make_node(1)], user_id="u1")
    updated = make_node(1)
    updated["content"] = "updated"
    store.add_nodes([updated], user_id="u1")
    rows = store.get_nodes(user_id="u1")
    assert len(rows) == 1 and rows[0]["content"] == "updated"
    return rows


def user_isolation(store):
    store.add_nodes([make_node(1)], user_id="u1")
    store.add_nodes([make_node(2)], user_id="u2")
    assert {r["id"] for r in store.get_nodes(user_id="u1")} == {"node_1"}
    assert {r["id"] for r in store.get_nodes(user_id="u2")} == {"node_2"}
    assert store.get_all_users() == ["u1", "u2"]
    return store.get_all_users()


def search_nodes_brute_force(store):
    store.add_nodes([make_node(0), make_node(1)], user_id="u1")
    ids = store.search_nodes([1.0, 0.0, 0.0, 0.0], user_id="u1", limit=1)
    assert ids == ["node_0"]
    return ids


def delete_empty_list_deletes_all(store):
    store.add_nodes([make_node(1), make_node(2)], user_id="u1")
    store.add_nodes([make_node(3)], user_id="u2")
    store.delete_nodes([], user_id="u1")
    assert store.get_nodes(user_id="u1") == []
    assert len(store.get_nodes(user_id="u2")) == 1
    return store.get_nodes(user_id="u2")


def edges_round_trip_typed_ids(store):
    store.add_edges([
        {"source": "a", "target": "b", "weight": 0.7, "edge_type": "relates_to"},
        {"source": "a", "target": "b", "weight": 0.4, "edge_type": "causes"},
    ], user_id="u1")
    rows = store.get_edges(user_id="u1")
    assert len(rows) == 2          # typed parallel edges do not collide
    return rows


def profile_round_trip(store):
    store.save_profile({"data": {"preferences": "tea"}}, user_id="u1")
    assert store.load_profile(user_id="u1") == {"data": {"preferences": "tea"}}
    assert store.load_profile(user_id="nobody") is None
    return store.load_profile(user_id="u1")


def version_bumps_on_every_write(store):
    v0 = store.get_latest_version()
    store.add_nodes([make_node(1)], user_id="u1")
    v1 = store.get_latest_version()
    store.save_profile({"x": 1}, user_id="u1")
    v2 = store.get_latest_version()
    assert v0 < v1 < v2
    return [v0, v1, v2]


# --------------------------------------- tests/test_store_segments.py cases
def upsert_appends_segment_not_rewrite(store):
    store.add_nodes([_node(i) for i in range(100)])
    man1 = _manifest(store)
    store.add_nodes([_node(100)])
    man2 = _manifest(store)
    assert len(man2["segments"]) == len(man1["segments"]) + 1
    seg = os.path.join(store.db_dir, man2["segments"][-1])
    assert pq.read_metadata(seg).num_rows == 1          # the delta holds one row
    assert len(store.get_nodes()) == 101
    return [man1, man2]


def last_wins_and_tombstones(store):
    store.add_nodes([_node(1, salience=0.3), _node(2)])
    store.add_nodes([_node(1, salience=0.9)])
    store.delete_nodes(["node_2"])
    rows = store.get_nodes()
    assert [r["id"] for r in rows] == ["node_1"]
    assert rows[0]["salience"] == pytest.approx(0.9)
    return rows


def segment_folding_bounds_read_amplification(store):
    for i in range(20):
        store.add_nodes([_node(i)])
    man = _manifest(store)
    assert len(man["segments"]) < 16
    assert len(store.get_nodes()) == 20
    segs = [f for f in os.listdir(store.db_dir) if ".seg-" in f]
    assert len(segs) == len(man["segments"])
    return man


def row_heavy_deltas_trigger_base_compaction(store):
    store.add_nodes([_node(i) for i in range(3000)])
    store.add_nodes([_node(i) for i in range(3000, 6000)])
    man = _manifest(store)
    assert man["base"] is not None and man["segments"] == []
    assert len(store.get_nodes()) == 6000
    return man


def tombstones_survive_segment_folding(store):
    store.add_nodes([_node(i) for i in range(5)])
    store.compact()
    store.delete_nodes(["node_2"])
    for i in range(20):
        store.add_nodes([_node(100 + i)])
    man = _manifest(store)
    assert man["base"] is not None
    ids = {r["id"] for r in store.get_nodes()}
    assert "node_2" not in ids and {"node_0", "node_104"} <= ids
    return [man, sorted(ids)]


def explicit_compact_and_versions(store):
    store.add_nodes([_node(1)])
    store.add_nodes([_node(2)])
    v_before = store.get_latest_version()
    store.compact()
    assert store.get_latest_version() > v_before
    assert {r["id"] for r in store.get_nodes()} == {"node_1", "node_2"}
    return store.get_latest_version()


def legacy_single_file_layout_still_reads(store):
    legacy = pa.Table.from_pylist([{
        "id": "node_9", "user_id": "default", "content": "old row",
        "embedding": [1.0, 0.0], "type": "semantic", "timestamp": 5.0,
        "access_count": 2, "last_accessed": 6.0, "salience": 0.7,
        "is_super_node": False, "child_ids": "[]", "parent_id": "",
        "shard_key": "work", "metadata": "{}",
    }])
    buf = pa.BufferOutputStream()
    pq.write_table(legacy, buf)
    with open(os.path.join(store.db_dir, "nodes__default.parquet"), "wb") as f:
        f.write(buf.getvalue().to_pybytes())
    rows = store.get_nodes()
    assert rows[0]["id"] == "node_9" and rows[0]["decay_pass"] == 0
    store.add_nodes([_node(10, dim=2)])
    assert {r["id"] for r in store.get_nodes()} == {"node_9", "node_10"}
    return store.get_nodes()


def columnar_node_reader(store):
    store.add_nodes([_node(i, dim=3) for i in range(5)])
    store.add_nodes([{"id": "super_1", "content": "topic", "embedding": [],
                      "is_super_node": True, "child_ids": ["node_0"]}])
    cols = store.get_nodes_columns()
    assert cols["embedding"].shape == (6, 3)
    assert cols["embedding"].dtype == np.float32
    assert cols["has_embedding"].sum() == 5
    sup = cols["id"].index("super_1")
    assert bool(cols["is_super_node"][sup])
    assert json.loads(cols["child_ids"][sup]) == ["node_0"]
    return cols


def columnar_edge_reader(store):
    store.add_edges([{"source": "a", "target": "b", "weight": 0.6},
                     {"source": "b", "target": "c", "weight": 0.4}])
    cols = store.get_edges_columns()
    assert cols["source_id"] == ["a", "b"]
    np.testing.assert_allclose(cols["weight"], [0.6, 0.4])
    return cols


def delete_all_parity_drops_everything(store):
    store.add_nodes([_node(1)])
    store.delete_nodes([])
    assert store.get_nodes() == [] and store.get_nodes_columns() is None
    return store.get_latest_version()


def sys_meta_roundtrip(store):
    assert store.load_sys_meta() == {}
    store.save_sys_meta({"decay_pass": 7, "node_counter": 42})
    assert store.load_sys_meta() == {"decay_pass": 7, "node_counter": 42}
    assert store.load_sys_meta("alice") == {}
    return store.load_sys_meta()


def search_nodes_over_segments(store):
    store.add_nodes([_node(1, embedding=[1.0, 0.0, 0.0, 0.0])])
    store.add_nodes([_node(2, embedding=[0.0, 1.0, 0.0, 0.0])])
    assert store.search_nodes([1.0, 0.05, 0.0, 0.0], limit=1) == ["node_1"]
    return store.search_nodes([1.0, 0.05, 0.0, 0.0], limit=2)


def cross_process_reader_sees_segments(store):
    other = type(store)(store.db_dir)
    store.add_nodes([_node(1)])
    v1 = other.get_latest_version()
    store.add_nodes([_node(2)])
    assert other.get_latest_version() > v1
    assert {r["id"] for r in other.get_nodes()} == {"node_1", "node_2"}
    return other.get_nodes()


def empty_embedding_upsert_preserves_stored_vector(store):
    store.add_nodes([_node(1, embedding=[0.1, 0.2, 0.3, 0.4])])
    store.add_nodes([{"id": "node_1", "content": "updated", "embedding": [],
                      "salience": 0.9}])
    rows = store.get_nodes()
    assert rows[0]["content"] == "updated"
    assert rows[0]["embedding"] == pytest.approx([0.1, 0.2, 0.3, 0.4])
    return rows


def mixed_dimension_rows_search_and_survive(store):
    store.add_nodes([{"id": "old", "content": "legacy", "embedding": [1.0] * 8},
                     {"id": "new1", "content": "n1", "embedding": [0.5] * 4},
                     {"id": "new2", "content": "n2", "embedding": [-0.5] * 4}])
    assert store.search_nodes([1.0] * 8, limit=1) == ["old"]
    store.add_nodes([{"id": "old", "content": "legacy2", "embedding": []}])
    row = [r for r in store.get_nodes() if r["id"] == "old"][0]
    assert len(row["embedding"]) == 8
    return store.get_nodes_columns()


def get_all_users_with_tricky_names(store):
    store.add_nodes([_node(1)], user_id="metrics.seg-a")
    store.add_nodes([_node(2)], user_id="default")
    assert store.get_all_users() == ["default", "metrics.seg-a"]
    return store.get_all_users()


def columnar_bulk_insert_matches_dict_path(store):
    emb = np.arange(12, dtype=np.float32).reshape(3, 4)
    store.add_nodes_columns(
        ids=["a", "b", "c"], contents=["one", "two", "three"],
        embeddings=emb, types=["semantic", "episodic", "semantic"],
        saliences=[0.5, 0.6, 0.7], timestamps=[1.0, 2.0, 3.0],
        shard_keys=["work", "", "health"], decay_pass=4)
    store.add_nodes([{"id": "d", "content": "four", "embedding": [9.0] * 4,
                      "type": "semantic", "salience": 0.8, "timestamp": 4.0,
                      "shard_key": "work", "decay_pass": 4}])
    rows = {r["id"]: r for r in store.get_nodes()}
    assert len(rows) == 4 and rows["b"]["type"] == "episodic"
    assert rows["b"]["embedding"] == [4.0, 5.0, 6.0, 7.0]
    assert rows["c"]["salience"] == 0.7 and rows["c"]["shard_key"] == "health"
    assert rows["a"]["decay_pass"] == 4 and rows["a"]["access_count"] == 0
    store.add_nodes_columns(ids=["d"], contents=["four v2"],
                            embeddings=np.full((1, 4), 2.0, np.float32),
                            types=["semantic"], saliences=[0.9],
                            timestamps=[5.0], shard_keys=["work"])
    rows = {r["id"]: r for r in store.get_nodes()}
    assert rows["d"]["content"] == "four v2" and rows["d"]["salience"] == 0.9
    return rows


def fold_resolves_null_vectors(store):
    """A segments-only fold over metadata upserts (NULL vectors): one
    inherits a vector from an earlier segment, one from the base, and one
    whose id a tombstone deleted gets an explicit empty vector, so the
    base's deleted vector never resurfaces."""
    store.add_nodes([_node(i, embedding=[float(i), 1.0, 0.0, 0.0])
                     for i in range(3)])
    store.compact()                               # rows 0-2 in the base
    store.add_nodes([_node(10, embedding=[0.0, 0.0, 1.0, 0.0])])
    store.delete_nodes(["node_2"])
    for i in (0, 2, 10):                          # metadata-only upserts
        store.add_nodes([{"id": f"node_{i}", "content": f"upsert {i}",
                          "embedding": None, "salience": 0.9}])
    for i in range(20):                           # past the segment cap
        store.add_nodes([_node(100 + i)])
    man = _manifest(store)
    assert man["base"] is not None and len(man["segments"]) < 16
    rows = {r["id"]: r for r in store.get_nodes()}
    assert rows["node_0"]["embedding"] == [0.0, 1.0, 0.0, 0.0]
    assert rows["node_10"]["embedding"] == [0.0, 0.0, 1.0, 0.0]
    assert rows["node_2"]["embedding"] == [] and rows["node_2"]["content"] == "upsert 2"
    return [man, rows]


def tombstones_delete_every_row(store):
    """Tombstones for every row, read, folded and compacted: an empty view,
    no row resurfacing."""
    store.add_edges([{"source": f"a{i}", "target": f"b{i}", "weight": 0.5}
                     for i in range(6)])
    store.delete_edges([f"a{i}|b{i}|relates_to" for i in range(6)])
    assert store.get_edges() == [] and store.get_edges_columns() is None
    store.add_nodes([_node(i) for i in range(3)])
    store.delete_nodes([f"node_{i}" for i in range(3)])
    for i in range(20):                       # a fold of tombstones only
        store.delete_nodes([f"node_{i}"])
    store.compact()
    assert store.get_nodes() == [] and store.get_nodes_columns() is None
    return [_manifest(store), _manifest(store, "edges")]


CASES = [node_round_trip, add_nodes_upserts, user_isolation,
         search_nodes_brute_force, delete_empty_list_deletes_all,
         edges_round_trip_typed_ids, profile_round_trip,
         version_bumps_on_every_write, upsert_appends_segment_not_rewrite,
         last_wins_and_tombstones, segment_folding_bounds_read_amplification,
         row_heavy_deltas_trigger_base_compaction,
         tombstones_survive_segment_folding, explicit_compact_and_versions,
         legacy_single_file_layout_still_reads, columnar_node_reader,
         columnar_edge_reader, delete_all_parity_drops_everything,
         sys_meta_roundtrip, search_nodes_over_segments,
         cross_process_reader_sees_segments,
         empty_embedding_upsert_preserves_stored_vector,
         mixed_dimension_rows_search_and_survive,
         get_all_users_with_tricky_names,
         columnar_bulk_insert_matches_dict_path, fold_resolves_null_vectors,
         tombstones_delete_every_row]


def _plain(x):
    """``x`` with numpy arrays as lists, for equality across the stores."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [x.dtype.str, x.tolist()]
    return x


def _everything(store):
    """Every user's rows, edges, profile and sys-meta, and the version."""
    out = {"version": store.get_latest_version()}
    for user in store.get_all_users():
        out[user] = [store.get_nodes(user), store.get_edges(user),
                     store.get_nodes_columns(user),
                     store.get_edges_columns(user), store.load_profile(user),
                     store.load_sys_meta(user)]
    return _plain(out)


def _files(db):
    return sorted(f for f in os.listdir(db) if not f.startswith(".tmp-"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_store_case_matches_jax(case, tmp_path):
    port = ArrowStore(str(tmp_path / "port"))
    ref = JaxStore(str(tmp_path / "jax"))
    assert _plain(case(port)) == _plain(case(ref))
    assert _files(port.db_dir) == _files(ref.db_dir)
    # one format: each directory reads the same through either package
    mine, theirs = _everything(port), _everything(ref)
    assert mine == theirs
    assert _everything(JaxStore(port.db_dir)) == mine
    assert _everything(ArrowStore(ref.db_dir)) == theirs
    port.close()
    ref.close()


def test_parquet_bytes_equal_jax(tmp_path):
    """The same writes leave byte-identical parquet files in both
    directories (one pyarrow, one schema, one frozen clock)."""
    port = ArrowStore(str(tmp_path / "port"))
    ref = JaxStore(str(tmp_path / "jax"))
    for s in (port, ref):
        columnar_bulk_insert_matches_dict_path(s)
        s.add_edges([{"source": "a", "target": "b", "weight": 0.25}], "u")
        s.delete_edges(["a|b|relates_to"], "u")
    names = [f for f in _files(port.db_dir) if f.endswith(".parquet")]
    assert names
    for name in names:
        with open(os.path.join(port.db_dir, name), "rb") as f:
            mine = f.read()
        with open(os.path.join(ref.db_dir, name), "rb") as f:
            assert f.read() == mine, name


def test_store_without_pyarrow_raises_naming_the_item(monkeypatch, tmp_path):
    """No silent in-memory mode: without pyarrow the constructor raises
    ImportError naming the ROADMAP item."""
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.split(".")[0] == "pyarrow":
            raise ImportError("No module named 'pyarrow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(store_mod, "pa", None)
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="Queue 1 item 7"):
        ArrowStore(str(tmp_path / "db"))
    assert not (tmp_path / "db").exists()
