"""The persistent store and the turn journal of the port's ``MemorySystem``
against the JAX package's: the cases of ``tests/test_persistence.py`` (but
``save_state``, in ``tests/test_torch_snapshot.py``), ``tests/test_crash_recovery.py``
and ``tests/test_multi_tenant.py``'s thousand-user switch, each run on both
packages with the same fakes and required to give the same results;
``db_dir``s written by either package loaded by the other; a restart's
decay replay bit-equal to a system that never restarted; injected stores."""

import json
import time
import zlib

import numpy as np
import pytest
import torch

from lazzaro_tpu import MemorySystem as JaxSystem
from lazzaro_tpu.config import MemoryConfig as JaxConfig
from lazzaro_tpu.core.store import ArrowStore as JaxStore
from lazzaro_tpu_torch import MemoryConfig, MemorySystem
from lazzaro_tpu_torch.core.store import ArrowStore
from tests.fakes import MockEmbedder, MockLLM, extraction_response
from tests.test_fused_ingest import ClusteredEmb, QueueLLM

PKGS = {"port": (MemorySystem, MemoryConfig, {"device": "cpu"}),
        "jax": (JaxSystem, JaxConfig, {})}
BOTH = ("port", "jax")


def make(pkg, config_kw=None, **kw):
    """A ``MemorySystem`` of package ``pkg``, with ``config_kw`` as its
    ``MemoryConfig``; the port's on the CPU."""
    system, config, extra = PKGS[pkg]
    if config_kw is not None:
        kw["config"] = config(**config_kw)
    return system(**extra, **kw)


def both(scenario, tmp_path, **kw):
    """``scenario(pkg, db_dir)`` on each package in its own directory; the
    two records must be equal."""
    records = {pkg: scenario(pkg, str(tmp_path / pkg), **kw) for pkg in BOTH}
    assert records["port"] == records["jax"]
    return records["port"]


# ---------------------------------------------- tests/test_persistence.py
FACT = {"content": "User plays the violin", "type": "semantic",
        "salience": 0.8, "topic": "personal"}


def make_ms(pkg, tmp_db, load=False, **kw):
    llm = MockLLM(sniffers={
        "Extract distinct, atomic facts": extraction_response([FACT])})
    defaults = dict(enable_async=False, auto_consolidate=False,
                    load_from_disk=load, db_dir=tmp_db, llm_provider=llm,
                    embedding_provider=MockEmbedder(), verbose=False)
    defaults.update(kw)
    return make(pkg, **defaults)


def ingest_one(ms):
    ms.start_conversation()
    ms.add_to_short_term("I play violin", "episodic", 0.7)
    ms.end_conversation()


def test_save_restart_reload(tmp_path):
    def scenario(pkg, db):
        a = make_ms(pkg, db)
        ingest_one(a)
        assert a.buffer.size()[0] == 1
        a.close()
        b = make_ms(pkg, db, load=True)
        assert b.buffer.size()[0] == 1
        node = b.buffer.get_node("node_1")
        assert node.content == FACT["content"] and node.shard_key == "personal"
        assert b.node_counter == 1
        ids = [n.id for n in b.search_memories("User plays the violin")]
        assert ids == ["node_1"]
        b.close()
        return ids, node.salience, node.access_count
    both(scenario, tmp_path)


def test_cross_instance_version_sync(tmp_path):
    def scenario(pkg, db):
        a = make_ms(pkg, db)
        b = make_ms(pkg, db, load=True)
        assert b.buffer.size()[0] == 0
        assert b.check_for_updates() is False
        ingest_one(a)
        assert b.check_for_updates() is True
        assert b.buffer.size()[0] == 1
        assert b.buffer.get_node("node_1").content == FACT["content"]
        a.close()
        b.close()
        return b.store.get_latest_version()
    both(scenario, tmp_path)


def test_switch_user_isolates_graphs(tmp_path):
    def scenario(pkg, db):
        ms = make_ms(pkg, db)
        ingest_one(ms)
        assert ms.buffer.size()[0] == 1
        ms.switch_user("bob")
        assert ms.user_id == "bob" and ms.buffer.size()[0] == 0
        assert ms.search_memories("violin") == []
        ms.switch_user("default")
        assert ms.buffer.size()[0] == 1
        ids = [n.id for n in ms.search_memories("User plays the violin")]
        assert ids == ["node_1"]
        users = ms.get_all_users()
        ms.close()
        return ids, users
    both(scenario, tmp_path)


def test_eviction_deletes_from_store(tmp_path):
    facts = [{"content": f"User fact number {i} about topic {i}",
              "type": "semantic", "salience": 0.5, "topic": "personal"}
             for i in range(6)]

    def scenario(pkg, db):
        llm = MockLLM(sniffers={
            "Extract distinct, atomic facts": extraction_response(facts)})
        ms = make(pkg, enable_async=False, auto_consolidate=False,
                  load_from_disk=False, db_dir=db, max_buffer_size=3,
                  llm_provider=llm, embedding_provider=MockEmbedder(dim=16),
                  verbose=False)
        ms.start_conversation()
        ms.add_to_short_term("many facts", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 3
        stored = sorted(r["id"] for r in ms.store.get_nodes(user_id="default"))
        assert len(stored) == 3
        ms.close()
        return stored
    both(scenario, tmp_path)


def test_thousand_users_switch_and_enumerate(tmp_path):
    """``switch_user`` / ``get_all_users`` at 1,000 users: every graph is
    isolated, enumeration sees everyone, and switching back restores a
    user's memories from the store."""
    def scenario(pkg, db):
        ms = make(pkg, {"journal": False}, enable_async=False, db_dir=db,
                  verbose=False, load_from_disk=False)
        first = ms.user_id
        for u in range(1000):
            ms.switch_user(f"user{u}")
            ms.start_conversation()
            ms.add_to_short_term(f"user {u} owns artifact number {u}",
                                 "semantic", 0.8)
            ms.end_conversation()
        users = ms.get_all_users()
        assert len([u for u in users if u.startswith("user")]) == 1000
        hits_of = {}
        for u in (0, 499, 999):
            ms.switch_user(f"user{u}")
            hits = ms.search_memories(f"artifact number {u}")
            assert hits, f"user{u} lost their graph"
            assert all(f"user {u} " in n.content for n in hits)
            hits_of[u] = [(n.id, n.content) for n in hits]
        ms.switch_user(first)
        ms.close()
        return users, hits_of
    both(scenario, tmp_path)


# ------------------------------------------- tests/test_crash_recovery.py
def _make(pkg, tmp_db, llm=None, **kw):
    return make(pkg, llm_provider=llm or MockLLM(),
                embedding_provider=MockEmbedder(dim=32), db_dir=tmp_db,
                enable_async=False, verbose=False, **kw)


def _extract(content, typ, salience, topic):
    return MockLLM(sniffers={"Extract distinct": extraction_response([
        {"content": content, "type": typ, "salience": salience,
         "topic": topic}])})


def test_crashed_turns_recovered(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db)
        ms.start_conversation()
        ms.add_to_short_term("User is a marine biologist", "semantic", 0.9)
        ms.add_to_short_term("User visited a coral reef today", "episodic", 0.7)
        # a crash: no end_conversation, no close
        ms2 = _make(pkg, db, llm=_extract("User is a marine biologist",
                                          "semantic", 0.9, "work"))
        assert ms2.conversation_active
        contents = [t["content"] for t in ms2.short_term_memory]
        assert contents == ["User is a marine biologist",
                            "User visited a coral reef today"]
        ms2.end_conversation()
        hits = [n.content for n in
                ms2.search_memories("User is a marine biologist")]
        assert any("marine" in c for c in hits)
        return contents, hits
    both(scenario, tmp_path)


def test_journal_cleared_after_consolidation(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db, llm=_extract("User likes tea", "semantic", 0.6,
                                         "personal"))
        ms.start_conversation()
        ms.add_to_short_term("User likes tea", "semantic", 0.6)
        ms.end_conversation()
        ms2 = _make(pkg, db)
        assert not ms2.conversation_active and ms2.short_term_memory == []
        return sorted(ms2.buffer.nodes)
    both(scenario, tmp_path)


def test_journal_is_per_user(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db, user_id="alice")
        ms.start_conversation()
        ms.add_to_short_term("Alice plays violin", "semantic", 0.8)
        bob = _make(pkg, db, user_id="bob")
        assert not bob.conversation_active
        alice2 = _make(pkg, db, user_id="alice")
        assert alice2.conversation_active
        assert alice2.short_term_memory[0]["content"] == "Alice plays violin"
        return [t["content"] for t in alice2.short_term_memory]
    both(scenario, tmp_path)


def test_journal_disabled_flag(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db)
        ms.config.journal = False
        ms._setup_journal()
        assert ms._journal is None
        ms.start_conversation()
        ms.add_to_short_term("ephemeral turn", "semantic", 0.5)
        ms2 = _make(pkg, db)
        assert all(t["content"] != "ephemeral turn"
                   for t in ms2.short_term_memory)
        return ms2.short_term_memory
    both(scenario, tmp_path)


def test_start_conversation_consolidates_recovered_turns(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db)
        ms.start_conversation()
        ms.add_to_short_term("User speaks Basque", "semantic", 0.9)
        # a crash
        ms2 = _make(pkg, db, llm=_extract("User speaks Basque", "semantic",
                                          0.9, "personal"))
        assert ms2._recovered_turns
        ms2.start_conversation()
        assert ms2.short_term_memory == []
        hits = [n.content for n in ms2.search_memories("User speaks Basque")]
        assert any("Basque" in c for c in hits)
        return hits
    both(scenario, tmp_path)


def test_abandoned_buffer_discarded_on_start(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db)
        ms.start_conversation()
        ms.add_to_short_term("abandoned turn", "semantic", 0.5)
        ms.start_conversation()
        assert ms.short_term_memory == []
        ms2 = _make(pkg, db)
        assert all(t["content"] != "abandoned turn"
                   for t in ms2.short_term_memory)
        return ms2.short_term_memory
    both(scenario, tmp_path)


def test_async_consolidation_does_not_wipe_new_turns(tmp_path):
    def scenario(pkg, db):
        llm = _extract("User ran a marathon", "episodic", 0.8, "health")
        ms = make(pkg, llm_provider=llm, embedding_provider=MockEmbedder(dim=32),
                  db_dir=db, enable_async=True, verbose=False)
        ms.start_conversation()
        ms.add_to_short_term("User ran a marathon", "episodic", 0.8)
        ms.end_conversation()              # queues the consolidation
        ms.start_conversation()
        ms.add_to_short_term("fresh turn after restart of convo", "semantic", 0.6)
        ms._drain_background()
        ms.close()
        ms2 = _make(pkg, db)
        contents = [t["content"] for t in ms2.short_term_memory]
        assert contents == ["fresh turn after restart of convo"]
        return contents
    both(scenario, tmp_path)


def test_load_from_disk_false_skips_replay(tmp_path):
    def scenario(pkg, db):
        ms = _make(pkg, db)
        ms.start_conversation()
        ms.add_to_short_term("persisted-in-wal", "semantic", 0.5)
        # a crash
        clean = _make(pkg, db, load_from_disk=False)
        assert not clean.conversation_active and clean.short_term_memory == []
        ms2 = _make(pkg, db)
        contents = [t["content"] for t in ms2.short_term_memory]
        assert contents == ["persisted-in-wal"]
        return contents
    both(scenario, tmp_path)


def test_injected_store_skips_journal():
    """A store without a ``db_dir`` (in memory) gets no journal."""
    class NullStore:
        def close(self):
            pass

    for pkg in BOTH:
        ms = make(pkg, llm_provider=MockLLM(),
                  embedding_provider=MockEmbedder(dim=32), store=NullStore(),
                  load_from_disk=False, enable_async=False, verbose=False)
        assert ms._journal is None and ms._ingest_journal is None


# ------------------------------------------------ the ingest journal
def _journaled(pkg, db, load=False):
    return make(pkg, {"journal": True, "auto_consolidate": False,
                      "decay_rate": 0.0},
                enable_async=False, db_dir=db, verbose=False,
                load_from_disk=load, llm_provider=QueueLLM(4),
                embedding_provider=ClusteredEmb(), auto_prune=False,
                max_buffer_size=10_000)


def _count_facts(ms, content):
    return sum(1 for shard in ms.shards.values()
               for n in shard.nodes.values() if n.content == content)


def test_journal_replay_is_idempotent(tmp_path):
    """``tests/test_fault_injection.py::test_journal_replay_is_idempotent``:
    a batch appended again but not committed (a crash after the dispatch,
    before the commit) replays through the fused ingest on restart, where
    the dedup probe merges every fact that already landed; plus one new
    fact, which is ingested once."""
    def scenario(pkg, db):
        ms = _journaled(pkg, db)
        ms.start_conversation()
        ms.add_to_short_term("turn one", "semantic", 0.6)
        ms.end_conversation()
        assert _count_facts(ms, "fact 0 body") == 1
        facts = [{"content": f"fact {i} body", "type": "semantic",
                  "salience": 0.6, "topic": "work"} for i in range(4)]
        facts.append({"content": "fact 77 body", "type": "semantic",
                      "salience": 0.6, "topic": "work"})
        ms._ingest_journal.append(facts)
        ms._save_to_persistence()
        ms2 = _journaled(pkg, db, load=True)
        assert ms2._ingest_journal.pending_count == 0
        assert ms2.telemetry.counter_total("reliability.journal_replayed") == 5
        counts = [_count_facts(ms2, f["content"]) for f in facts]
        assert counts == [1] * 5                   # merged, not doubled
        ms3 = _journaled(pkg, db, load=True)       # the replay was saved
        assert [_count_facts(ms3, f["content"]) for f in facts] == counts
        ms2.close()
        return counts, sorted(ms3.buffer.nodes), ms3.node_counter
    both(scenario, tmp_path)


def test_ingest_journal_commits_after_the_drain(tmp_path):
    """Append before the coalescer, commit after the drain: a clean
    conversation end leaves nothing pending and an empty log."""
    import os

    def scenario(pkg, db):
        ms = _journaled(pkg, db)
        for _ in range(2):
            ms.start_conversation()
            ms.add_to_short_term("a turn", "semantic", 0.6)
            ms.end_conversation()
            assert ms._ingest_journal.pending_count == 0
            assert os.path.getsize(ms._ingest_journal.path) == 0
        ms.close()
        return sorted(ms.buffer.nodes)
    both(scenario, tmp_path)


# ---------------------------------------------- across the two packages
DIALOGUE = [
    ["I work as a data engineer on a big ETL project.",
     "My manager asked me to migrate the pipelines to Spark."],
    ["I play the violin in a string quartet on weekends.",
     "We rehearse Haydn quartets every Saturday morning."],
    ["I work as a data engineer on a big ETL project.",
     "I also mentor two junior engineers at work."],
    ["I run five kilometres every morning for my health.",
     "I started swimming on Fridays as well."],
]
QUERIES = ["what is the user's job?", "music on weekends",
           "exercise and health", "Spark migration"]


def _dialogue_system(pkg, db, load=False, user="default"):
    return make(pkg, enable_async=False, db_dir=db, verbose=False,
                load_from_disk=load, user_id=user)


def _drive_dialogue(ms, convs):
    for turns in convs:
        ms.start_conversation()
        for t in turns:
            ms.chat(t)
        ms.end_conversation()


def _read_back(ms):
    """What a reload must reproduce: top-k ids, the profile, every edge's
    weight and co-occurrence, every node's numbers."""
    return {
        "topk": [[n.id for n in ms.search_memories(q, limit=5)]
                 for q in QUERIES],
        "profile": dict(ms.profile.data),
        "edges": {k: (e.weight, e.co_occurrence)
                  for k, e in ms.buffer.edges.items()},
        "nodes": {nid: (n.content, n.salience, n.access_count, n.shard_key)
                  for nid, n in ms.buffer.nodes.items()},
        "counter": ms.node_counter,
    }


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_db_dir_loads_in_the_other_package(writer, reader, tmp_path,
                                           monkeypatch):
    """A ``db_dir`` written by one package's ``MemorySystem`` (two tenants,
    consolidations, boosts, decay) loads in the other, which serves the same
    top-k ids, profile, edge weights and node numbers as the writer's own
    reload."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    db = str(tmp_path / "db")
    ms = _dialogue_system(writer, db)
    _drive_dialogue(ms, DIALOGUE)
    ms.switch_user("bob")
    _drive_dialogue(ms, DIALOGUE[1:3])
    ms.switch_user("default")
    ms.close()
    got, want = {}, {}
    for user in ("default", "bob"):
        mine = _dialogue_system(reader, db, load=True, user=user)
        theirs = _dialogue_system(writer, db, load=True, user=user)
        got[user], want[user] = _read_back(mine), _read_back(theirs)
        assert sorted(mine.get_all_users()) == ["bob", "default"]
    assert got["default"]["profile"] != dict.fromkeys(got["default"]["profile"], "")
    assert got["default"]["edges"]
    assert got == want


class TopicEmbedder:
    """``... topic <c> ...`` texts around a direction per topic (cosine ~0.7
    between facts of one topic, above the link gate), each text's own noise
    seeded by its CRC32: no two texts embed alike, so no score ties, whose
    order a reload's new arena rows could change."""

    dim = 64

    def embed(self, text):
        after = text.partition("topic ")[2]
        digits = after[:len(after) - len(after.lstrip("0123456789"))]
        c = int(digits) if digits else zlib.crc32(text.encode()) % 7
        base = np.random.default_rng(c).standard_normal(self.dim)
        noise = np.random.default_rng(zlib.crc32(text.encode())).standard_normal(self.dim)
        v = base + 0.6 * noise
        return (v / np.linalg.norm(v)).tolist()

    def batch_embed(self, texts):
        return [self.embed(t) for t in texts]


def _stamped_bits(ms):
    """Each live row's salience bits and each edge's weight bits, by id."""
    sal = ms.index.state.salience.view(torch.int32).numpy()
    w = ms.index.edge_state.weight.view(torch.int32).numpy()
    return ({qid: int(sal[row]) for qid, row in ms.index.id_to_row.items()},
            {key: int(w[slot]) for key, slot in ms.index.edge_slots.items()})


def test_restart_replays_missed_decay_to_the_same_bits(tmp_path, monkeypatch):
    """``tests/test_lifecycle.py::test_decay_replay_bit_parity_across_restart``
    driven by conversation ends: rows written at an early pass miss the
    later passes in the store; a system that restarts replays them and must
    hold the same salience and edge-weight bits as one that never
    restarted, before and after further conversations."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    cfg = {"decay_rate": 0.05, "auto_consolidate": False,
           "auto_prune": False, "max_buffer_size": 10_000}
    convs = [[f"I like topic {c} number {i} a lot." for i in range(4)]
             for c in range(6)]
    kw = dict(enable_async=False, verbose=False,
              embedding_provider=TopicEmbedder())
    lived = make("port", cfg, db_dir=str(tmp_path / "a"),
                 load_from_disk=False, **kw)
    restarted = make("port", cfg, db_dir=str(tmp_path / "b"),
                     load_from_disk=False, **kw)
    def talk(ms, part):
        for c, turns in part:
            ms.start_conversation()
            for t in turns:
                ms.add_to_short_term(t, "semantic", 0.7)
            ms.chat(f"What do I like about topic {c}?")   # boosts rows
            ms.end_conversation()

    for ms in (lived, restarted):
        talk(ms, list(enumerate(convs))[:4])
    restarted.close()
    restarted = make("port", cfg, db_dir=str(tmp_path / "b"),
                     load_from_disk=True, **kw)
    stamps = restarted.store.get_nodes_columns("default")["decay_pass"]
    assert restarted._decay_pass == lived._decay_pass == 4
    assert (stamps < 4).any()                 # rows that missed passes
    assert _stamped_bits(restarted) == _stamped_bits(lived)
    assert _stamped_bits(lived)[1]                # edges replayed too
    for ms in (lived, restarted):
        talk(ms, list(enumerate(convs))[4:])
    assert _stamped_bits(restarted) == _stamped_bits(lived)
    lived.close()
    restarted.close()


# ------------------------------------------------------- injected stores
class ColumnarMemoryStore:
    """An in-memory store with the ``Store`` protocol and the columnar
    methods, over the port's ``ArrowStore`` merge rules kept in dicts."""

    def __init__(self):
        self.nodes, self.edges, self.profiles, self.meta = {}, {}, {}, {}
        self.version = 0

    def _bump(self):
        self.version += 1

    def add_nodes(self, nodes, user_id="default"):
        table = self.nodes.setdefault(user_id, {})
        for n in nodes:
            row = dict(n)
            old = table.get(row["id"])
            if not row.get("embedding") and old is not None:
                row["embedding"] = old.get("embedding")
            table[row["id"]] = row
        self._bump()

    def add_nodes_columns(self, ids, contents, embeddings, types, saliences,
                          timestamps, shard_keys, decay_pass=0,
                          user_id="default"):
        self.add_nodes([{"id": i, "content": c, "embedding": list(map(float, e)),
                         "type": t, "salience": float(s), "timestamp": float(ts),
                         "shard_key": k, "decay_pass": decay_pass,
                         "last_accessed": time.time()}
                        for i, c, e, t, s, ts, k in zip(
                            ids, contents, np.asarray(embeddings, np.float32),
                            types, saliences, timestamps, shard_keys)], user_id)

    def get_nodes(self, user_id="default"):
        return [dict(r) for r in self.nodes.get(user_id, {}).values()]

    def get_nodes_columns(self, user_id="default"):
        rows = self.get_nodes(user_id)
        if not rows:
            return None
        dim = max(len(r.get("embedding") or []) for r in rows)
        emb = np.zeros((len(rows), dim), np.float32)
        has = np.zeros(len(rows), bool)
        for i, r in enumerate(rows):
            if r.get("embedding") and len(r["embedding"]) == dim:
                emb[i], has[i] = r["embedding"], True
        col = lambda k, d: [r.get(k, d) for r in rows]   # noqa: E731
        return {"id": col("id", ""), "content": col("content", ""),
                "type": col("type", "semantic"),
                "shard_key": [r.get("shard_key") or "" for r in rows],
                "parent_id": [r.get("parent_id") or "" for r in rows],
                "child_ids": [json.dumps(r.get("child_ids") or []) for r in rows],
                "timestamp": np.asarray(col("timestamp", 0.0), np.float64),
                "access_count": np.asarray(col("access_count", 0), np.int64),
                "last_accessed": np.asarray(col("last_accessed", 0.0), np.float64),
                "salience": np.asarray(col("salience", 0.5), np.float64),
                "is_super_node": np.asarray(col("is_super_node", False), bool),
                "decay_pass": np.asarray(col("decay_pass", 0), np.int64),
                "embedding": emb, "has_embedding": has, "ragged_embeddings": {}}

    def search_nodes(self, embedding, user_id="default", limit=10):
        return []

    def delete_nodes(self, node_ids, user_id="default"):
        table = self.nodes.setdefault(user_id, {})
        if not node_ids:
            table.clear()
        for i in node_ids:
            table.pop(i, None)
        self._bump()

    def get_latest_version(self):
        return self.version

    @staticmethod
    def _edge_id(e):
        return f"{e['source_id']}|{e['target_id']}|{e.get('edge_type', 'relates_to')}"

    def add_edges(self, edges, user_id="default"):
        table = self.edges.setdefault(user_id, {})
        for e in edges:
            table[self._edge_id(e)] = dict(e)
        self._bump()

    def get_edges(self, user_id="default"):
        return [dict(e) for e in self.edges.get(user_id, {}).values()]

    def get_edges_columns(self, user_id="default"):
        rows = self.get_edges(user_id)
        if not rows:
            return None
        col = lambda k, d: [r.get(k, d) for r in rows]   # noqa: E731
        return {"id": [self._edge_id(r) for r in rows],
                "source_id": col("source_id", ""), "target_id": col("target_id", ""),
                "edge_type": col("edge_type", "relates_to"),
                "weight": np.asarray(col("weight", 0.5), np.float64),
                "co_occurrence": np.asarray(col("co_occurrence", 1), np.int64),
                "last_updated": np.asarray(col("last_updated", 0.0), np.float64),
                "decay_pass": np.asarray(col("decay_pass", 0), np.int64)}

    def delete_edges(self, edge_ids, user_id="default"):
        table = self.edges.setdefault(user_id, {})
        if not edge_ids:
            table.clear()
        for i in edge_ids:
            table.pop(i, None)
        self._bump()

    def save_profile(self, profile, user_id="default"):
        self.profiles[user_id] = profile
        self._bump()

    def load_profile(self, user_id="default"):
        return self.profiles.get(user_id)

    def save_sys_meta(self, meta, user_id="default"):
        self.meta[user_id] = dict(meta)
        self._bump()

    def load_sys_meta(self, user_id="default"):
        return dict(self.meta.get(user_id, {}))

    def get_all_users(self):
        return sorted(self.nodes)

    def close(self):
        pass


class RowStore(ColumnarMemoryStore):
    """The bare 11-method protocol: no columnar readers, no sys-meta."""
    get_nodes_columns = get_edges_columns = None
    add_nodes_columns = save_sys_meta = load_sys_meta = None

    def __getattribute__(self, name):
        if name in ("get_nodes_columns", "get_edges_columns",
                    "add_nodes_columns", "save_sys_meta", "load_sys_meta"):
            raise AttributeError(name)
        return super().__getattribute__(name)


def _ranked(ms):
    """Each query's whole ranking as (score, ids at that score) groups: a
    reload puts rows in other arena rows, which may order exact ties
    differently."""
    out = []
    for q in QUERIES:
        ids, scores = ms.index.search(np.asarray(ms.embedder.embed(q), np.float32),
                                      ms.user_id, k=64, super_filter=-1)
        groups = {}
        for i, s in zip(ids, scores):
            groups.setdefault(round(float(s), 6), set()).add(i)
        out.append(sorted(groups.items(), reverse=True))
    return out


@pytest.mark.parametrize("store_cls", [ColumnarMemoryStore, RowStore])
def test_injected_store_saves_and_reloads(store_cls, monkeypatch):
    """``store=`` takes any object with the protocol: the columnar one gets
    incremental saves and the columnar reload, the bare one full rewrites
    and the row reload; either way a new system on the same store, and the
    tenant after a switch away and back, serve what the first one did."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    store = store_cls()
    ms = make("port", enable_async=False, verbose=False, store=store,
              load_from_disk=False)
    assert ms.vector_store is store and ms._journal is None
    assert ms._supports_incremental is (store_cls is ColumnarMemoryStore)
    _drive_dialogue(ms, DIALOGUE)
    want, ranked = _read_back(ms), _ranked(ms)
    ms.switch_user("bob")
    assert ms.buffer.size() == (0, 0)
    ms.switch_user("default")
    assert _ranked(ms) == ranked
    ms.close()
    again = make("port", enable_async=False, verbose=False, store=store,
                 load_from_disk=True)
    got = _read_back(again)
    assert _ranked(again) == ranked and got["profile"] == want["profile"]
    assert set(got["nodes"]) == set(want["nodes"])
    assert set(got["edges"]) == set(want["edges"])
    again.close()


def test_arrow_store_is_the_default(tmp_path):
    ms = make("port", enable_async=False, verbose=False,
              db_dir=str(tmp_path / "db"), load_from_disk=False)
    assert isinstance(ms.store, ArrowStore) and ms.vector_store is ms.store
    assert ms.get_stats()["vector_store"].endswith("ArrowStore")
    ms.close()
    assert isinstance(JaxStore(str(tmp_path / "db")).get_latest_version(), int)


def test_standalone_consolidation_saves(tmp_path):
    """``run_consolidation(persist=True)`` saves the merges and the profile
    at once, as the JAX package does: a reader polling the store sees them
    without a conversation end."""
    def scenario(pkg, db):
        ms = _dialogue_system(pkg, db)
        ms.auto_consolidate = False
        _drive_dialogue(ms, DIALOGUE[:2])
        v = ms.store.get_latest_version()
        out = ms.run_consolidation(persist=True)
        saved = ms.store.get_latest_version() > v
        reader = _dialogue_system(pkg, db, load=True)
        record = (out, saved, dict(reader.profile.data),
                  sorted(reader.buffer.nodes))
        ms.close()
        return record
    both(scenario, tmp_path)
