"""``MemorySystem`` snapshots of the port: the binary ``save_snapshot`` /
``load_snapshot`` (the index checkpoint of every tenant plus the current
user's host graph) and the JSON ``save_state`` / ``load_state``.

The cases of ``tests/test_snapshot.py`` on the port (its
``test_restore_preserves_ivf_serving_config`` runs with the IVF tests, in
``tests/test_torch_ivf.py``), and
``tests/test_persistence.py::test_save_load_state_json`` run
on both packages with the same fakes, and each package loading the other's
JSON; a snapshot restored into a system serves what the saved one served
(ids and score bits).
"""

import json
import os

import numpy as np
import pytest

from lazzaro_tpu import MemorySystem as JaxSystem
from lazzaro_tpu_torch import MemorySystem
from tests.fakes import MockEmbedder, MockLLM, extraction_response


def _ms(db_dir, **kw):
    kw.setdefault("load_from_disk", False)
    return MemorySystem(enable_async=kw.pop("enable_async", False),
                        db_dir=db_dir, verbose=False, device="cpu", **kw)


def _seeded_system(db_dir):
    ms = _ms(db_dir)
    ms.start_conversation()
    ms.chat("I work as a data engineer on a big ETL project.")
    ms.chat("I love hiking in the mountains on weekends.")
    ms.end_conversation()
    return ms


def test_snapshot_round_trip(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    before = [n.content for n in ms.search_memories("what is the user's job?")]
    assert before
    snap = str(tmp_path / "snap")
    assert "saved" in ms.save_snapshot(snap)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    assert "loaded" in ms2.load_snapshot(snap)
    after = [n.content for n in ms2.search_memories("what is the user's job?")]
    assert after == before
    assert ms2.conversation_count == ms.conversation_count
    assert ms2.node_counter == ms.node_counter
    assert all(n.embedding is None for n in ms2.buffer.nodes.values())
    ms2.close()


def test_snapshot_serves_the_saved_results(tmp_path):
    """The restored system's index serves the saved one's ids and score
    bits (classic and fused), and its arena columns are bit-equal."""
    ms = _seeded_system(str(tmp_path / "db"))
    q = ms.embedder.embed("hiking on weekends")
    want = ms.index.search(q, ms.user_id, k=5)
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    sal = ms.index.state.salience.numpy().copy()
    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    got = ms2.index.search(q, ms2.user_id, k=5)
    assert got[0] == want[0]
    np.testing.assert_array_equal(np.float32(got[1]), np.float32(want[1]))
    np.testing.assert_array_equal(ms2.index.state.salience.numpy().view(np.int32),
                                  sal.view(np.int32))
    fused = [n.id for n in ms2.search_memories("hiking on weekends")]
    assert fused == [n.id for n in ms.search_memories("hiking on weekends")]
    ms.close()
    ms2.close()


def test_snapshot_then_persistence_keeps_embeddings(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()

    db2 = str(tmp_path / "db2")
    ms2 = _ms(db2)
    ms2.load_snapshot(snap)
    ms2._save_to_persistence()
    rows = ms2.store.get_nodes(user_id=ms2.user_id)
    assert rows and all(len(r["embedding"]) == ms2.embed_dim for r in rows)
    ms2.close()

    ms3 = _ms(db2, load_from_disk=True)
    hits = [n.content for n in ms3.search_memories("hiking mountains")]
    assert any("hiking" in h for h in hits)
    ms3.close()


def test_snapshot_system_remains_usable(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    n_before = len(ms.buffer.nodes)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    ms2.start_conversation()
    ms2.chat("I work as a data engineer on a big ETL project.")
    ms2.end_conversation()
    fact = "I work as a data engineer on a big ETL project"
    engineer_nodes = [n for n in ms2.buffer.nodes.values() if n.content == fact]
    assert len(engineer_nodes) == 1
    assert engineer_nodes[0].access_count >= 1
    assert len(ms2.buffer.nodes) >= n_before
    ms2.run_consolidation()
    ms2.lifecycle_tick(force=True)
    ms2.close()


def test_snapshot_preserves_other_tenants_in_index(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    ms.switch_user("alice")
    ms.start_conversation()
    ms.chat("I am a violinist in an orchestra.")
    ms.end_conversation()
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    assert ms2.user_id == "alice"
    hits = [n.content for n in ms2.search_memories("violin")]
    assert any("violinist" in h for h in hits)
    assert ms2.index.tenant_nodes.get("default")
    ms2.close()


def test_restore_then_save_state_keeps_embeddings(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    state_file = str(tmp_path / "state.json")
    ms2.save_state(state_file)
    ms2.close()

    ms3 = _ms(str(tmp_path / "db3"))
    ms3.load_state(state_file)
    hits = [n.content for n in ms3.search_memories("hiking mountains")]
    assert any("hiking" in h for h in hits)
    ms3.close()


def test_async_snapshot_drains_consolidation(tmp_path):
    ms = _ms(str(tmp_path / "db"), enable_async=True)
    ms.start_conversation()
    ms.chat("My cat is named Whiskers and loves tuna.")
    ms.end_conversation()
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    hits = [n.content for n in ms2.search_memories("cat named Whiskers")]
    assert any("Whiskers" in h for h in hits)
    ms2.close()


def test_restore_discards_inflight_conversation(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.start_conversation()
    ms.chat("This turn must NOT survive the restore.")
    assert ms.conversation_active and ms.short_term_memory
    ms.load_snapshot(snap)
    assert not ms.conversation_active
    assert not ms.short_term_memory and not ms.conversation_history
    ms.start_conversation()
    ms.end_conversation()
    assert not any("must NOT survive" in n.content
                   for n in ms.buffer.nodes.values())
    ms.close()


def test_restore_reopens_journal_for_snapshot_user(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    ms.switch_user("alice")
    ms.start_conversation()
    ms.chat("I play the violin.")
    ms.end_conversation()
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()

    ms2 = _ms(str(tmp_path / "db2"))
    ms2.load_snapshot(snap)
    assert ms2.user_id == "alice"
    assert ms2._journal is not None and "alice" in ms2._journal.path
    assert "alice" in ms2._ingest_journal.path
    ms2.start_conversation()
    ms2.chat("Practicing scales today.")
    assert (tmp_path / "db2" / "journal__alice.wal").exists()
    ms2.close()


def test_corrupt_snapshot_leaves_system_intact(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    before = [n.content for n in ms.search_memories("data engineer work")]
    bad = tmp_path / "bad_snap"
    bad.mkdir()
    (bad / "host.json").write_text('{"user_id": "default", "shards": {}}')
    msg = ms.load_snapshot(str(bad))
    assert msg.startswith("⚠")
    after = [n.content for n in ms.search_memories("data engineer work")]
    assert after == before
    ms.close()


def test_load_snapshot_missing_dir(tmp_path):
    ms = _ms(str(tmp_path / "db"))
    assert "No snapshot" in ms.load_snapshot(str(tmp_path / "nope"))
    ms.close()


def test_snapshot_pair_mismatch_warns(tmp_path):
    ms = _seeded_system(str(tmp_path / "db"))
    snap = str(tmp_path / "snap")
    ms.save_snapshot(snap)
    ms.close()
    hj = os.path.join(snap, "host.json")
    with open(hj) as f:
        host = json.load(f)
    assert host["snapshot_id"]
    host["snapshot_id"] = "deadbeef" * 4
    with open(hj, "w") as f:
        json.dump(host, f)

    ms2 = _ms(str(tmp_path / "db2"))
    msg = ms2.load_snapshot(snap)
    assert "loaded" in msg and "different snapshot ids" in msg
    ms2.close()


# ----------------------------------- tests/test_persistence.py, both packages
FACT = {"content": "User plays the violin", "type": "semantic",
        "salience": 0.8, "topic": "personal"}


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_save_load_state_json(pkg, tmp_path):
    def make(db):
        llm = MockLLM(sniffers={
            "Extract distinct, atomic facts": extraction_response([FACT])})
        kw = dict(enable_async=False, auto_consolidate=False,
                  load_from_disk=False, db_dir=db, llm_provider=llm,
                  embedding_provider=MockEmbedder(), verbose=False)
        return MemorySystem(device="cpu", **kw) if pkg == "port" else JaxSystem(**kw)

    ms = make(str(tmp_path / "db"))
    ms.start_conversation()
    ms.add_to_short_term("I play violin", "episodic", 0.7)
    ms.end_conversation()
    path = str(tmp_path / "snapshot.json")
    assert "saved" in ms.save_state(path)
    ms2 = make(str(tmp_path / "db2"))
    assert "loaded" in ms2.load_state(path)
    assert ms2.buffer.size()[0] == 1
    assert ms2.node_counter == 1
    assert [n.id for n in ms2.search_memories("User plays the violin")] == ["node_1"]
    ms.close()
    ms2.close()


def test_state_json_files_equal_across_packages(tmp_path):
    """``save_state`` of the port and of the JAX package on the same
    dialogue write the same JSON (the timestamps aside), and each package
    loads the other's file."""
    def make(pkg, db):
        llm = MockLLM(sniffers={
            "Extract distinct, atomic facts": extraction_response([FACT])})
        kw = dict(enable_async=False, auto_consolidate=False,
                  load_from_disk=False, db_dir=db, llm_provider=llm,
                  embedding_provider=MockEmbedder(), verbose=False)
        return MemorySystem(device="cpu", **kw) if pkg == "port" else JaxSystem(**kw)

    files = {}
    for pkg in ("port", "jax"):
        ms = make(pkg, str(tmp_path / f"db_{pkg}"))
        ms.start_conversation()
        ms.add_to_short_term("I play violin", "episodic", 0.7)
        ms.end_conversation()
        files[pkg] = str(tmp_path / f"{pkg}.json")
        ms.save_state(files[pkg])
        ms.close()

    def strip(d):
        if isinstance(d, dict):
            return {k: strip(v) for k, v in d.items()
                    if k not in ("timestamp", "last_accessed", "last_updated")}
        if isinstance(d, list):
            return [strip(x) for x in d]
        return round(d, 5) if isinstance(d, float) else d

    loaded = {k: json.load(open(v)) for k, v in files.items()}
    assert strip(loaded["port"]) == strip(loaded["jax"])
    for reader, writer in (("port", "jax"), ("jax", "port")):
        ms = make(reader, str(tmp_path / f"db_{reader}_{writer}"))
        assert "loaded" in ms.load_state(files[writer])
        assert [n.id for n in ms.search_memories("User plays the violin")] == ["node_1"]
        ms.close()
