"""The classic-path slice as a whole: the JAX ``MemorySystem`` and the port's
``MemorySystem(device="cpu")`` run the same scripted dialogue and must agree.

Both use ``HashingEmbedder(64)``, ``HeuristicLLM`` and the classic
configuration (no fused serving or ingest, no journals, no lifecycle sweep,
no auto-consolidation), with ``time.time`` frozen so importance ranks and
super-node ids do not depend on the clock. The dialogue has three
conversations for one tenant, a repeated fact that must dedup-merge, enough
facts in one topic for a super node, an eviction, and a switch to a second
tenant and back.

Tolerances: node ids, contents, shard keys, super-node children, edge keys,
chat-turn retrieved ids and ``search_memories`` ids (in order) must be equal;
saliences and edge weights agree within 1e-6 (f32 sums in another order).
"""

import threading
import time

import numpy as np
import pytest

from lazzaro_tpu import MemorySystem as JaxSystem
from lazzaro_tpu.config import MemoryConfig as JaxConfig
from lazzaro_tpu.core.providers import HashingEmbedder as JaxEmbedder
from lazzaro_tpu.core.providers import HeuristicLLM as JaxLLM
from lazzaro_tpu_torch import MemoryConfig as TorchConfig
from lazzaro_tpu_torch import MemorySystem as TorchSystem
from lazzaro_tpu_torch.core.providers import HashingEmbedder as TorchEmbedder
from lazzaro_tpu_torch.core.providers import HeuristicLLM as TorchLLM

CLASSIC = dict(serve_fused=False, ingest_fused=False, ingest_dedup_fused=False,
               lifecycle_fused=False, journal=False, ingest_journal=False,
               auto_consolidate=False, embed_dim=64, initial_capacity=64,
               max_edges=64)
QUERIES = ["project meeting with the client", "exercise for health",
           "learning french", "which project had a deadline",
           "weekend plans with my family"]


def made_up_words(seed, n):
    """Distinct nonsense words (no topic keyword inside), so every fact
    hashes to its own vector and no ranking in the dialogue rests on a tie
    that only f32 rounding would break."""
    rng = np.random.default_rng(seed)
    syllables = ["ka", "zu", "rin", "tol", "vex", "mar", "qui", "dro", "pel",
                 "sna", "gu", "lor", "fen", "bri", "xo", "tam", "wuz", "ilk"]
    out = []
    while len(out) < n:
        w = "".join(rng.choice(syllables, size=rng.integers(2, 4)))
        if w not in out:
            out.append(w)
    return out


WORDS = made_up_words(0, 400)


def facts(keyword, count, start):
    """``count`` facts, the i-th with i + 2 made-up words around a topic
    ``keyword``: distinct lengths and vocabularies give the hashed vectors
    distinct norms and overlaps, so no two score alike."""
    out, pos = [], start
    for i in range(count):
        words = WORDS[pos:pos + i + 2]
        pos += i + 2
        out.append(f"{words[0]} {keyword} {' '.join(words[1:])}.")
    return out


WORK = facts("meeting", 24, 0)
HEALTH = facts("exercise", 10, 330)


def dialogue(ms, record):
    """The scripted dialogue; ``record`` collects what must match exactly."""
    def chat(text):
        record.append(("chat", text, ms.chat(text)))

    ms.start_conversation()
    for text in WORK:
        ms.add_to_short_term(text, "episodic", 0.6)
    ms.add_to_short_term("I study french at an evening course.", "semantic", 0.8)
    ms.add_to_short_term("I practice french grammar with a tutorial.", "semantic", 0.4)
    ms.add_to_short_term("My favourite colour is teal.", "semantic", 0.5)
    ms.end_conversation()

    ms.start_conversation()
    chat("What happened at the project meeting?")
    ms.add_to_short_term(WORK[2], "episodic", 0.9)    # repeats a conv-1 fact
    for text in HEALTH:
        ms.add_to_short_term(text, "episodic", 0.5)
    chat("How do I keep fit for my health?")
    ms.add_to_short_term(WORK[2], "episodic", 0.3)    # the extractor drops this one
    ms.end_conversation()                             # evicts past the limit
    record.append(("nodes", snapshot(ms)))

    ms.switch_user("bob")
    ms.start_conversation()
    ms.add_to_short_term("I visit my family every weekend at home.", "episodic", 0.7)
    ms.add_to_short_term("My friend plays chess with me at home.", "episodic", 0.6)
    chat("What do I do at home with family?")
    chat("Any plans for the weekend with my friend?")
    ms.end_conversation()
    record.append(("search_bob", [[n.id for n in ms.search_memories(q)]
                                  for q in QUERIES]))
    record.append(("nodes_bob", snapshot(ms)))

    ms.switch_user("default")
    record.append(("nodes", snapshot(ms)))
    record.append(("users", sorted(ms.get_all_users())))
    # Back on the first tenant, the JAX package has reloaded its rows from
    # the store into new arena rows, so exact ties may now rank in another
    # order: rankings are recorded in full and compared tie-aware.
    record.append(("ranked", [ms.index.search(
        np.asarray(ms.embedder.embed(q), np.float32), "default", k=64,
        super_filter=-1) for q in QUERIES]))
    record.append(("top5", [[n.id for n in ms.search_memories(q)]
                            for q in QUERIES]))
    batch = [[n.id for n in r] for r in ms.search_memories_batch(QUERIES)]
    record.append(("batch_is_top5", batch == record[-1][1]))
    stats = ms.get_stats()
    record.append(("stats", {k: stats[k] for k in (
        "buffer_nodes", "buffer_edges", "num_shards", "num_super_nodes",
        "conversation_count")}))


def snapshot(ms):
    nodes = {nid: (n.content, n.shard_key, n.salience, n.access_count,
                   n.is_super_node, tuple(n.child_ids))
             for nid, n in ms.buffer.nodes.items()}
    edges = {key: e.weight for key, e in ms.buffer.edges.items()}
    return nodes, edges


def run(system_cls, config_cls, embedder_cls, llm_cls, tmp_db, monkeypatch,
        config_kw=CLASSIC, **kw):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ms = system_cls(enable_async=False, load_from_disk=False, db_dir=tmp_db,
                    max_buffer_size=40, verbose=False,
                    embedding_provider=embedder_cls(64), llm_provider=llm_cls(),
                    config=config_cls(**config_kw), **kw)
    retrieved = []
    inner = ms._retrieve_for_chat

    def spy(query_emb, query_text):
        ids, mode = inner(query_emb, query_text)
        retrieved.append((query_text, list(ids), mode))
        return ids, mode

    ms._retrieve_for_chat = spy
    record = []
    try:
        dialogue(ms, record)
    finally:
        ms.close()
    return record, retrieved


def assert_snapshots_match(jsnap, tsnap):
    jn, je = jsnap
    tn, te = tsnap
    assert sorted(tn) == sorted(jn)
    for nid, (content, shard, sal, acc, sup, kids) in jn.items():
        t = tn[nid]
        assert (t[0], t[1], t[3], t[4], t[5]) == (content, shard, acc, sup, kids), nid
        assert abs(t[2] - sal) <= 1e-6, nid
    assert sorted(te) == sorted(je)
    for key, w in je.items():
        assert abs(te[key] - w) <= 1e-6, key


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One run of the dialogue per package, shared by the tests below."""
    root = tmp_path_factory.mktemp("dialogue")
    with pytest.MonkeyPatch.context() as mp:
        jrec, jret = run(JaxSystem, JaxConfig, JaxEmbedder, JaxLLM,
                         str(root / "jax_db"), mp)
        trec, tret = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                         str(root / "torch_db"), mp, device="cpu")
    return jrec, jret, trec, tret


def assert_same_ranking(jids, jscores, tids, tscores):
    """Equal score sequences (within 1e-6) and, within each run of scores
    that tie, the same set of ids."""
    assert len(tids) == len(jids)
    np.testing.assert_allclose(tscores, jscores, rtol=0, atol=1e-6)
    start = 0
    for i in range(1, len(jids) + 1):
        if i == len(jids) or jscores[i - 1] - jscores[i] > 1e-6:
            assert set(tids[start:i]) == set(jids[start:i])
            start = i


def test_dialogue_matches_jax(both):
    jrec, jret, trec, tret = both
    assert tret == jret                      # chat-turn retrieved ids + modes
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    for j, t in zip(jrec, trec):
        if j[0] in ("nodes", "nodes_bob"):
            assert_snapshots_match(j[1], t[1])
        elif j[0] == "ranked":
            for (jids, js), (tids, ts) in zip(j[1], t[1]):
                assert_same_ranking(jids, js, tids, ts)
        elif j[0] == "top5":
            for ids, (ranked, _) in zip(t[1], t_ranked(trec)):
                assert ids == [i.partition(":")[2] for i in ranked[:5]]
        else:
            assert t == j, j[0]


def t_ranked(rec):
    return [r[1] for r in rec if r[0] == "ranked"][0]


def test_dialogue_exercises_the_slice(both):
    """The script really merges a duplicate, builds a super node, evicts,
    links, retrieves through the gate and isolates tenants."""
    _, _, trec, tret = both
    snaps = [r[1] for r in trec if r[0] == "nodes"]
    nodes, edges = snaps[-1]
    supers = [nid for nid, v in nodes.items() if v[4]]
    assert len(supers) == 1 and len(nodes[supers[0]][5]) > 20
    cobalt = [v for v in nodes.values() if v[0] == WORK[2].rstrip(".")]
    assert len(cobalt) == 1 and cobalt[0][3] == 1      # merged once, not copied
    assert cobalt[0][2] > 0.6                          # took the repeat's salience
    assert len(snaps[0][0]) - 1 <= 40                    # evicted to the limit
    assert edges
    assert any(len(ids) > 0 for _, ids, _ in tret)
    assert [r[1] for r in trec if r[0] == "batch_is_top5"] == [True]
    bob = [r[1] for r in trec if r[0] == "nodes_bob"][0][0]
    assert bob and not set(bob) & set(nodes)
    for ids in [r[1] for r in trec if r[0] == "search_bob"][0]:
        assert set(ids) <= set(bob)


# --------------------------------------------------------- fused serving
# The same dialogue with the default serving, fused and ragged: every chat
# turn and search goes through the query scheduler and one fused dispatch in
# both packages (the JAX side keeps the classic ingest the port runs).
FUSED = dict(CLASSIC, serve_fused=True)


@pytest.fixture(scope="module")
def both_fused(tmp_path_factory):
    root = tmp_path_factory.mktemp("dialogue_fused")
    with pytest.MonkeyPatch.context() as mp:
        jrec, jret = run(JaxSystem, JaxConfig, JaxEmbedder, JaxLLM,
                         str(root / "jax_db"), mp, config_kw=FUSED)
        trec, tret = run(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                         str(root / "torch_db"), mp, device="cpu",
                         config_kw=FUSED)
    return jrec, jret, trec, tret


def test_fused_dialogue_matches_jax(both_fused):
    """Chat-turn ids and boost modes, node saliences and access counts,
    ``search_memories`` ids in order: equal to the JAX system's."""
    jrec, jret, trec, tret = both_fused
    assert tret == jret
    assert {mode for _, _, mode in tret} >= {"device"}
    for j, t in zip(jrec, trec):
        if j[0] in ("nodes", "nodes_bob"):
            assert_snapshots_match(j[1], t[1])
        elif j[0] == "ranked":
            for (jids, js), (tids, ts) in zip(j[1], t[1]):
                assert_same_ranking(jids, js, tids, ts)
        elif j[0] == "top5":
            for ids, (ranked, _) in zip(t[1], t_ranked(trec)):
                assert ids == [i.partition(":")[2] for i in ranked[:5]]
        else:
            assert t == j, j[0]


class _FusedFixture:
    """The JAX fused-retrieval fixture (``tests/test_fused_retrieval.py``)
    on the port: clustered facts, 20 per conversation."""

    @staticmethod
    def system(tmp, serve_fused=True, super_threshold=100):
        from tests.test_fused_ingest import ClusteredEmb, QueueLLM
        ms = TorchSystem(
            enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
            llm_provider=QueueLLM(20), embedding_provider=ClusteredEmb(),
            auto_prune=False, max_buffer_size=10_000,
            super_node_threshold=super_threshold, device="cpu",
            config=TorchConfig(decay_rate=0.0))
        ms.config.serve_fused = serve_fused
        for c in range(2):
            ms.start_conversation()
            ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
            ms.end_conversation()
        return ms


def _numeric(ms):
    cols = ms.index.pull_numeric()
    n = len(ms.index.id_to_row)
    return {k: cols[k][: n + 2] for k in ("salience", "access_count")}


def test_fused_matches_classic_chat_turns(tmp_path):
    """Ids, order and boost effects (arena and host copies) of fused and
    classic serving agree on gate-miss turns, a cached turn included; the
    fused turns make one fused launch each and no classic one."""
    from lazzaro_tpu_torch.ops import fused_topk as ft
    from lazzaro_tpu_torch.ops import masked_topk as mt

    a = _FusedFixture.system(str(tmp_path / "a"), serve_fused=True)
    b = _FusedFixture.system(str(tmp_path / "b"), serve_fused=False)
    try:
        a.start_conversation()
        b.start_conversation()
        calls = []
        plain = {"fused": ft.fused_topk_reference,
                 "masked": mt.masked_topk_reference}

        def counting(name):
            return lambda *x, **kw: (calls.append(name), plain[name](*x, **kw))[1]

        a_calls = []
        ft.fused_topk_reference = counting("fused")
        mt.masked_topk_reference = counting("masked")
        try:
            for q in ("fact 3 body", "fact 17 body", "fact 31 body",
                      "fact 3 body"):          # the last one is a cache hit
                calls.clear()
                ra = a.chat(q)
                a_calls.append(list(calls))
                assert ra == b.chat(q)
        finally:
            ft.fused_topk_reference = plain["fused"]
            mt.masked_topk_reference = plain["masked"]
        assert a_calls == [["fused"]] * 3 + [[]]
        a.end_conversation()
        b.end_conversation()
        ca, cb = _numeric(a), _numeric(b)
        np.testing.assert_allclose(ca["salience"], cb["salience"], atol=1e-6)
        np.testing.assert_array_equal(ca["access_count"], cb["access_count"])
        ha = {n: (round(a.buffer.nodes[n].salience, 5),
                  a.buffer.nodes[n].access_count) for n in a.buffer.nodes}
        hb = {n: (round(b.buffer.nodes[n].salience, 5),
                  b.buffer.nodes[n].access_count) for n in b.buffer.nodes}
        assert ha == hb
    finally:
        a.close()
        b.close()


def test_fused_matches_classic_super_gate_hit(tmp_path):
    """A query on a super-node centroid fires the gate: the device reports
    ``fast`` and boosts nothing, the host serves the children in child-list
    order with classic boosts; results and arena numerics match classic."""
    a = _FusedFixture.system(str(tmp_path / "a"), True, super_threshold=5)
    b = _FusedFixture.system(str(tmp_path / "b"), False, super_threshold=5)
    try:
        assert a.super_nodes
        sid = sorted(a.super_nodes)[0]
        centroid = np.asarray(a.super_nodes[sid].embedding, np.float32)
        ids_a, mode_a = a._retrieve_for_chat(centroid.tolist(), "probe-q")
        ids_b, mode_b = b._retrieve_for_chat(centroid.tolist(), "probe-q")
        assert ids_a == ids_b
        assert mode_a == mode_b == "classic"
        assert ids_a[0] == a.super_nodes[sid].child_ids[0]
        a.start_conversation()
        b.start_conversation()
        a.chat("fact 5 body")
        b.chat("fact 5 body")
        ca, cb = _numeric(a), _numeric(b)
        np.testing.assert_allclose(ca["salience"], cb["salience"], atol=1e-6)
        np.testing.assert_array_equal(ca["access_count"], cb["access_count"])
    finally:
        a.close()
        b.close()


def test_fused_matches_classic_empty_graph(tmp_path):
    from tests.test_fused_ingest import ClusteredEmb

    kw = dict(enable_async=False, verbose=False, load_from_disk=False,
              embedding_provider=ClusteredEmb(), device="cpu")
    a = TorchSystem(db_dir=str(tmp_path / "a"), **kw)
    b = TorchSystem(db_dir=str(tmp_path / "b"),
                    config=TorchConfig(serve_fused=False), **kw)
    try:
        emb = ClusteredEmb().embed("fact 1 body")
        assert a._retrieve_for_chat(emb, "fact 1 body")[0] == []
        assert b._retrieve_for_chat(emb, "fact 1 body")[0] == []
        assert a.search_memories("anything") == []
    finally:
        a.close()
        b.close()


def test_scheduler_coalesces_concurrent_searches(tmp_path):
    ms = _FusedFixture.system(str(tmp_path))
    try:
        expected = {q: [n.id for n in ms.search_memories(q)]
                    for q in (f"fact {i} body" for i in range(8))}
        results = {}

        def worker(q):
            results[q] = [n.id for n in ms.search_memories(q)]

        threads = [threading.Thread(target=worker, args=(q,))
                   for q in expected]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == expected
        assert ms.query_scheduler.stats()["requests_served"] >= 16
        assert ms.get_stats()["serving"]["requests_served"] >= 16
    finally:
        ms.close()
    assert ms.query_scheduler.closed


def test_multi_tenant_batch_isolation(tmp_path):
    """One batch serving two tenants keeps each to its own rows."""
    from tests.test_fused_ingest import ClusteredEmb
    from lazzaro_tpu_torch.serve import RetrievalRequest

    ms = _FusedFixture.system(str(tmp_path))
    try:
        emb = ClusteredEmb()
        q = np.asarray(emb.embed("fact 3 body"), np.float32)
        ms.index.add(["t2:alien_1"], q[None, :], [0.9], [0.0], ["semantic"],
                     ["default"], "t2")
        res = ms.index.search_fused_requests(
            [RetrievalRequest(query=q, tenant=ms.user_id, k=5),
             RetrievalRequest(query=q, tenant="t2", k=5)],
            cap_take=5, max_nbr=8, super_gate=0.4, acc_boost=0.05,
            nbr_boost=0.02)
        assert res[0].ids and all(i.startswith(f"{ms.user_id}:")
                                  for i in res[0].ids)
        assert res[1].ids == ["t2:alien_1"]
    finally:
        ms.close()
