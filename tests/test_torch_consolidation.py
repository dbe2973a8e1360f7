"""``run_consolidation`` of the port against the JAX package, and the slice
as a whole with ``auto_consolidate=True`` (the JAX default) in both.

- The five cases of ``tests/test_profile_update.py``, each run on both
  packages: the result, the profile, the merged count, the node count and
  the keeper's content are equal.
- ``HeuristicLLM``'s answer to the profile prompt is the same string in both.
- A scripted dialogue of nine conversations over two tenants with
  near-duplicate facts (a dedup gate of 0.99 lets them in as nodes, so the
  merge at 0.95 has work), consolidating at conversations 3, 6 and 9: once
  with the classic flags of ``tests/test_torch_memory_system.py`` and once
  with the fused defaults (``serve_fused``, ``ingest_fused``,
  ``ingest_dedup_fused``); journals and ``lifecycle_fused`` stay off on the
  JAX side. Node ids, contents (the merged ones included), shard keys,
  edge keys after the rewiring, profile domains, each consolidation's
  result, chat answers and retrieved ids, and ``search_memories`` ids are
  equal; saliences and edge weights agree within 1e-6 (f32 sums in another
  order).
"""

import json
import time

import numpy as np
import pytest

from lazzaro_tpu import MemorySystem as JaxSystem
from lazzaro_tpu.models.graph import Edge as JaxEdge
from lazzaro_tpu.models.graph import Node as JaxNode
from lazzaro_tpu_torch import MemorySystem as TorchSystem
from lazzaro_tpu_torch.models.graph import Edge as TorchEdge
from lazzaro_tpu_torch.models.graph import Node as TorchNode
from lazzaro_tpu_torch.ops import graphops as gops
from tests.fakes import MockEmbedder, MockLLM
from tests.test_torch_memory_system import (CLASSIC, JaxConfig, JaxEmbedder,
                                            JaxLLM, TorchConfig, TorchEmbedder,
                                            TorchLLM, assert_snapshots_match,
                                            made_up_words, snapshot)

INSIGHTS = {
    "preferences": "User prefers Python for data work.",
    "personality_traits": "User is methodical.",
    "knowledge_domains": "Strong grasp of memory systems.",
    "interaction_style": "Concise and technical.",
}

PACKAGES = {"jax": (JaxSystem, JaxNode, JaxEdge, {}),
            "torch": (TorchSystem, TorchNode, TorchEdge, {"device": "cpu"})}


# ------------------------------------------- tests/test_profile_update.py
def profile_system(name, tmp):
    cls, _, _, kw = PACKAGES[name]
    llm = MockLLM(sniffers={"Analyze these related memories": json.dumps(INSIGHTS)})
    return cls(enable_async=False, auto_consolidate=False, load_from_disk=False,
               db_dir=tmp, llm_provider=llm, embedding_provider=MockEmbedder(),
               verbose=False, **kw)


def seed_component(ms, Node, Edge, n=3, weight=0.8):
    shard = ms._get_or_create_shard("work")
    for i in range(n):
        emb = np.zeros(8, np.float32)
        emb[i % 8] = 1.0
        node = Node(id=f"node_{i}", content=f"Memory about project phase {i}",
                    embedding=emb.tolist(), shard_key="work")
        shard.add_node(node)
        ms._index_add_node(node)
    for i in range(n - 1):
        ms._add_edge(Edge(source=f"node_{i}", target=f"node_{i+1}", weight=weight))


def case_component_profile_extraction(ms, Node, Edge):
    seed_component(ms, Node, Edge, n=3, weight=0.8)
    result = ms.run_consolidation(merge_similar=False)
    assert "Updated" in result
    for domain, insight in INSIGHTS.items():
        assert ms.profile.data[domain] == insight
    return result


def case_small_components_fall_back_to_whole_graph(ms, Node, Edge):
    seed_component(ms, Node, Edge, n=2, weight=0.8)
    extra = Node(id="node_x", content="Isolated fact",
                 embedding=[0, 0, 0, 0, 0, 0, 0, 1.0])
    ms._get_or_create_shard("personal").add_node(extra)
    ms._index_add_node(extra)
    result = ms.run_consolidation(merge_similar=False)
    assert "Updated" in result
    return result


def case_weak_components_skip_profile(ms, Node, Edge):
    seed_component(ms, Node, Edge, n=3, weight=0.2)
    result = ms.run_consolidation(merge_similar=False)
    assert ms.profile.data["preferences"] == INSIGHTS["preferences"]
    return result


def case_merge_similar_nodes_all_pairs(ms, Node, Edge):
    shard = ms._get_or_create_shard("work")
    dup = [1.0, 0, 0, 0, 0, 0, 0, 0]
    for i, nid in enumerate(["node_1", "node_2", "node_3"]):
        node = Node(id=nid, content=f"dup {i}", embedding=list(dup),
                    shard_key="work")
        shard.add_node(node)
        ms._index_add_node(node)
    distinct = Node(id="node_9", content="distinct",
                    embedding=[0, 1.0, 0, 0, 0, 0, 0, 0], shard_key="work")
    shard.add_node(distinct)
    ms._index_add_node(distinct)
    ms._add_edge(Edge(source="node_3", target="node_9", weight=0.7))
    merged = ms._merge_similar_nodes(0.95)
    assert merged == 2                  # node_2 and node_3 absorbed into node_1
    assert ms.buffer.size()[0] == 2
    keeper = ms.buffer.get_node("node_1")
    assert "dup 1" in keeper.content and "dup 2" in keeper.content
    assert set(ms.buffer.edges) == {("node_1", "node_9")}   # rewired
    return merged


def case_profile_context_rendering(ms, Node, Edge):
    ms.profile.update_domain("preferences", "Tea over coffee")
    ctx = ms.profile.get_context()
    assert "Preferences: Tea over coffee" in ctx
    assert ms.profile.update_domain("not_a_domain", "x") is False
    return ctx


@pytest.mark.parametrize("case", [
    case_component_profile_extraction,
    case_small_components_fall_back_to_whole_graph,
    case_weak_components_skip_profile,
    case_merge_similar_nodes_all_pairs,
    case_profile_context_rendering,
], ids=lambda f: f.__name__[5:])
def test_profile_update_case_matches_jax(case, tmp_path):
    out = {}
    for name in PACKAGES:
        ms = profile_system(name, str(tmp_path / name))
        try:
            _, Node, Edge, _ = PACKAGES[name]
            result = case(ms, Node, Edge)
            nodes = {nid: n.content for nid, n in ms.buffer.nodes.items()}
            out[name] = (result, dict(ms.profile.data), ms.buffer.size(), nodes,
                         sorted(ms.buffer.edges))
        finally:
            ms.close()
    assert out["torch"] == out["jax"]


def test_merge_rewiring_keeps_the_neighbour_index(tmp_path):
    """The merge moves the absorbed nodes' edges onto the keeper (a pop and
    a store in the shard's edges): every node's neighbours afterwards, the
    absorbed ones' included, are JAX's, so a chat turn that boosts a
    retrieved node's neighbours finds only live edges."""
    out = {}
    for name in PACKAGES:
        ms = profile_system(name, str(tmp_path / name))
        try:
            _, Node, Edge, _ = PACKAGES[name]
            case_merge_similar_nodes_all_pairs(ms, Node, Edge)
            ids = ["node_1", "node_2", "node_3", "node_9"]
            out[name] = {nid: sorted(ms.buffer.get_neighbors(nid)) for nid in ids}
        finally:
            ms.close()
    assert out["torch"] == out["jax"]
    assert out["torch"]["node_9"] == ["node_1"]


def test_heuristic_llm_profile_answer_matches_jax():
    contents = ["The user reviews pull requests every morning",
                "The user mentors junior engineers on testing",
                "The user prefers pytest fixtures over setup methods",
                "The user reviews design documents on fridays"]
    prompt = "Related memories:\n" + "\n".join(f"- {c}" for c in contents)
    msgs = [{"role": "system", "content": TorchSystem._PROFILE_PROMPT},
            {"role": "user", "content": prompt}]
    assert TorchSystem._PROFILE_PROMPT == JaxSystem._PROFILE_PROMPT
    fmt = {"type": "json_object"}
    got = TorchLLM().completion(msgs, fmt)
    assert got == JaxLLM().completion(msgs, fmt)
    assert json.loads(got)


# ------------------------------------------------------------- dialogue
WORDS = made_up_words(7, 1100)


def near_pairs(start, count, length=16):
    """``count`` pairs (a, b): a is ``length`` made-up words and "meeting",
    b is a with one more word. Under HashingEmbedder(64) each pair scores
    0.95 to 0.99: past the merge gate, short of the dialogue's dedup gate."""
    out, pos = [], start
    for _ in range(count):
        words = WORDS[pos:pos + length + 1]
        pos += length + 1
        a = " ".join(words[:length // 2] + ["meeting"] + words[length // 2:length])
        out.append((a, f"{a} {words[length]}"))
    return out


NEAR = near_pairs(0, 9)
GROUP = [" ".join(WORDS[400:416]), " ".join(WORDS[400:416] + WORDS[416:417]),
         " ".join(WORDS[400:416] + WORDS[417:418]),
         " ".join(WORDS[400:416] + WORDS[416:418]),
         " ".join(WORDS[400:416] + WORDS[418:419]),
         " ".join(WORDS[400:416] + WORDS[419:420])]


def facts(keyword, count, start):
    """``count`` facts of distinct lengths around a topic keyword, as in
    ``tests/test_torch_memory_system.py``."""
    out, pos = [], start
    for i in range(count):
        words = WORDS[pos:pos + i + 2]
        pos += i + 2
        out.append(f"{words[0]} {keyword} {' '.join(words[1:])}.")
    return out


WORK = facts("meeting", 10, 500)
HEALTH = facts("exercise", 6, 700)
QUERIES = ["project meeting with the client", "exercise for health",
           NEAR[0][0], GROUP[0], NEAR[5][1]]
# The dedup gate sits above the near pairs so that they arrive as nodes.
AUTO = dict(CLASSIC, auto_consolidate=True, dedup_similarity=0.99)
AUTO_FUSED = dict(AUTO, serve_fused=True, ingest_fused=True,
                  ingest_dedup_fused=True)


def long_dialogue(ms, record):
    """Nine conversations: three for "default" (a consolidation at the
    third), then six for "bob", whose consolidations at the sixth and ninth
    run with the first tenant's rows still in the arena. The tenant switch
    comes once, to a new tenant, so neither package reloads a tenant's rows
    (the JAX package reloads from its store on a switch back)."""
    def conv(turns, chats=()):
        ms.start_conversation()
        for text in chats:
            record.append(("chat", text, ms.chat(text)))
        for text, sal in turns:
            ms.add_to_short_term(text, "semantic", sal)
        ms.end_conversation()
        record.append(("nodes", ms.user_id, snapshot(ms)))
        record.append(("profile", ms.user_id, dict(ms.profile.data)))

    conv([(t, 0.6) for t in WORK[:5]] + [(NEAR[0][0], 0.5), (NEAR[1][0], 0.7)])
    conv([(NEAR[0][1], 0.8)] + [(t, 0.5) for t in HEALTH[:4]],
         chats=["What happened at the project meeting?"])
    conv([(NEAR[1][1], 0.4), (NEAR[2][0], 0.6), (NEAR[2][1], 0.6)] +
         [(t, 0.6) for t in WORK[5:]])                      # consolidates
    ms.switch_user("bob")
    conv([(NEAR[0][0], 0.5), (NEAR[3][0], 0.6)] + [(t, 0.5) for t in HEALTH[4:]])
    conv([(g, 0.5 + 0.05 * i) for i, g in enumerate(GROUP)],
         chats=["How do I keep fit for my health?"])
    conv([(NEAR[3][1], 0.9), (NEAR[4][0], 0.5), (NEAR[4][1], 0.5)])   # consolidates
    conv([(NEAR[5][0], 0.6), (NEAR[6][0], 0.6)],
         chats=["Any news from the client meeting?"])
    conv([(NEAR[5][1], 0.6), (NEAR[7][0], 0.4), (NEAR[7][1], 0.4)])
    conv([(NEAR[6][1], 0.7), (NEAR[8][0], 0.5), (NEAR[8][1], 0.5)])   # consolidates
    record.append(("search", [[n.id for n in ms.search_memories(q)]
                              for q in QUERIES]))
    record.append(("count", ms.conversation_count))


def run_long(system_cls, config_cls, embedder_cls, llm_cls, tmp_db,
             monkeypatch, config_kw, **kw):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ms = system_cls(enable_async=False, load_from_disk=False, db_dir=tmp_db,
                    max_buffer_size=40, verbose=False,
                    embedding_provider=embedder_cls(64), llm_provider=llm_cls(),
                    config=config_cls(**config_kw), **kw)
    retrieved, consolidations = [], []
    inner_retrieve, inner_consolidate = ms._retrieve_for_chat, ms.run_consolidation

    def spy_retrieve(query_emb, query_text):
        ids, mode = inner_retrieve(query_emb, query_text)
        retrieved.append((query_text, list(ids), mode))
        return ids, mode

    def spy_consolidate(*a, **k):
        out = inner_consolidate(*a, **k)
        consolidations.append((ms.user_id, ms.conversation_count, out))
        return out

    ms._retrieve_for_chat, ms.run_consolidation = spy_retrieve, spy_consolidate
    record = []
    try:
        long_dialogue(ms, record)
    finally:
        ms.close()
    return record, retrieved, consolidations


def both_long(tmp_path_factory, config_kw, name):
    root = tmp_path_factory.mktemp(name)
    with pytest.MonkeyPatch.context() as mp:
        jax_run = run_long(JaxSystem, JaxConfig, JaxEmbedder, JaxLLM,
                           str(root / "jax_db"), mp, config_kw)
        torch_run = run_long(TorchSystem, TorchConfig, TorchEmbedder, TorchLLM,
                             str(root / "torch_db"), mp, config_kw, device="cpu")
    return jax_run, torch_run


@pytest.fixture(scope="module")
def long_classic(tmp_path_factory):
    return both_long(tmp_path_factory, AUTO, "consolidation_classic")


@pytest.fixture(scope="module")
def long_fused(tmp_path_factory):
    return both_long(tmp_path_factory, AUTO_FUSED, "consolidation_fused")


def assert_runs_match(jax_run, torch_run):
    (jrec, jret, jcons), (trec, tret, tcons) = jax_run, torch_run
    assert tcons == jcons
    assert tret == jret
    assert [r[0] for r in trec] == [r[0] for r in jrec]
    for j, t in zip(jrec, trec):
        if j[0] == "nodes":
            assert t[1] == j[1]
            assert_snapshots_match(j[2], t[2])
        else:
            assert t == j, j[0]


@pytest.mark.parametrize("flags", ["classic", "fused"])
def test_consolidating_dialogue_matches_jax(flags, request):
    jax_run, torch_run = request.getfixturevalue(f"long_{flags}")
    assert_runs_match(jax_run, torch_run)


@pytest.mark.parametrize("flags", ["classic", "fused"])
def test_consolidating_dialogue_exercises_the_slice(flags, request):
    """Three consolidations (conversations 3, 6, 9), two tenants' turns
    among them, merges that join contents and take edges along, a
    profile, and no pair across tenants."""
    _, (trec, _, tcons) = request.getfixturevalue(f"long_{flags}")
    assert [(u, c) for u, c, _ in tcons] == [("default", 3), ("bob", 6),
                                             ("bob", 9)]
    assert all("Merged" in out for _, _, out in tcons)
    nodes = {r[1]: r[2][0] for r in trec if r[0] == "nodes"}
    merged = [v[0] for v in nodes["bob"].values() if " | " in v[0]]
    assert any(v.count(" | ") >= 2 for v in merged)        # a group joined
    assert any(NEAR[0][0] == v[0] for v in nodes["bob"].values())
    assert not any(NEAR[0][1] in v[0] for v in nodes["bob"].values())
    assert " | " in " ".join(v[0] for v in nodes["default"].values())
    profiles = {r[1]: r[2] for r in trec if r[0] == "profile"}
    assert any(profiles["bob"].values()) and any(profiles["default"].values())


def test_one_scan_and_one_readback_per_consolidation_on_the_cpu(monkeypatch, tmp_path):
    """Each consolidation makes one pairwise scan call and one readback;
    on the CPU the wrapper runs the plain version and counts no launch."""
    calls, readbacks = [], []
    inner = gops.pairwise_merge_candidates_reference
    monkeypatch.setattr(gops, "pairwise_merge_candidates_reference",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    ms = TorchSystem(enable_async=False, load_from_disk=False, verbose=False,
                     db_dir=str(tmp_path), device="cpu",
                     embedding_provider=TorchEmbedder(64))
    read = ms.index._readback
    monkeypatch.setattr(ms.index, "_readback",
                        lambda p: readbacks.append(tuple(p.shape)) or read(p))
    before = gops.launches
    try:
        for c in range(6):
            ms.start_conversation()
            ms.add_to_short_term(NEAR[c][0], "semantic", 0.5)
            ms.add_to_short_term(NEAR[c][1], "semantic", 0.5)
            readbacks.clear()
            ms.end_conversation()
            if c in (2, 5):
                assert readbacks[-1][1] == 8       # the pair lists, packed
    finally:
        ms.close()
    assert len(calls) == 2 and gops.launches == before


def test_mesh_with_auto_consolidate_raises(tmp_path):
    from lazzaro_tpu_torch import MemoryConfig
    from lazzaro_tpu_torch.parallel import make_mesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 21"):
        TorchSystem(enable_async=False, load_from_disk=False, verbose=False,
                    db_dir=str(tmp_path), mesh=make_mesh(devices=["cpu"] * 2),
                    config=MemoryConfig(ingest_fused=False,
                                        ingest_dedup_fused=False))
