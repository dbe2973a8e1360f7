"""The port's version of ``tests/test_providers.py`` (the remote providers,
ROADMAP Queue 1 item 10, aside): injected providers through chat, the
offline defaults, ``chat_stream`` (its events against the JAX system's on
the same providers), the on-device LLM's JSON fallback and the JSON
extractor."""

import json

import numpy as np

from lazzaro_tpu import MemorySystem as JaxSystem
from lazzaro_tpu_torch import MemorySystem
from lazzaro_tpu_torch.core.providers import (HashingEmbedder, HeuristicLLM,
                                              OnDeviceLLM,
                                              _extract_json_object)
from tests.fakes import MockEmbedder, MockLLM


def make_ms(tmp_db, cls=MemorySystem, **kw):
    defaults = dict(enable_async=False, load_from_disk=False, db_dir=tmp_db,
                    verbose=False)
    if cls is MemorySystem:
        defaults["device"] = "cpu"
    defaults.update(kw)
    return cls(**defaults)


def test_injected_providers_drive_chat(tmp_db):
    llm = MockLLM(response="Hello from mock!")
    ms = make_ms(tmp_db, llm_provider=llm, embedding_provider=MockEmbedder())
    ms.start_conversation()
    assert ms.chat("Hi there") == "Hello from mock!"
    assert len(llm.calls) == 1
    assert [m["role"] for m in llm.calls[0]][0] == "system"
    assert {"role": "user", "content": "Hi there"} in llm.calls[0]
    ms.close()


def test_default_providers_are_offline(tmp_db):
    ms = make_ms(tmp_db)
    assert isinstance(ms.llm, HeuristicLLM)
    assert isinstance(ms.embedder, HashingEmbedder)
    ms.close()


def test_hashing_embedder_similarity_properties():
    e = HashingEmbedder(dim=128)
    a = e.embed("the user loves python programming")
    b = e.embed("the user loves python programming")
    c = e.embed("completely unrelated gardening topic here")
    assert np.allclose(a, b)
    assert float(np.dot(a, b)) > 0.99
    assert float(np.dot(a, c)) < 0.5


def test_heuristic_llm_fact_extraction():
    payload = json.dumps([
        {"content": "I work on a big project. I love hiking with family.",
         "type": "episodic", "salience": 0.7}])
    out = HeuristicLLM().completion([
        {"role": "system",
         "content": "Extract distinct, atomic facts from this conversation."},
        {"role": "user", "content": payload}])
    data = json.loads(out)
    assert any("project" in m["content"] for m in data["memories"])
    topics = {m["topic"] for m in data["memories"]}
    assert "work" in topics and "personal" in topics


def _stream(tmp_db, cls, text):
    ms = make_ms(tmp_db, cls, llm_provider=MockLLM(response=text),
                 embedding_provider=MockEmbedder())
    ms.start_conversation()
    events = list(ms.chat_stream("tell me something"))
    history = list(ms.conversation_history)
    ms.close()
    return events, history


def test_chat_stream_yields_info_then_tokens(tmp_path):
    events, history = _stream(str(tmp_path / "t"), MemorySystem,
                              "streamed response")
    kinds = [e["type"] for e in events]
    assert "info" in kinds and "token" in kinds
    assert kinds.index("info") < kinds.index("token")
    text = "".join(e["content"] for e in events if e["type"] == "token")
    assert text == "streamed response"
    assert history[-1] == {"role": "assistant", "content": "streamed response"}
    j_events, j_history = _stream(str(tmp_path / "j"), JaxSystem,
                                  "streamed response")
    assert kinds == [e["type"] for e in j_events]
    assert [e["content"] for e in events if e["type"] == "token"] == \
        [e["content"] for e in j_events if e["type"] == "token"]
    assert history == j_history


def test_chat_stream_starts_a_conversation_and_streams_chunks(tmp_db):
    class Chunky(MockLLM):
        def completion_stream(self, messages, response_format=None):
            self.calls.append(messages)
            yield from ("one ", "two ", "three")

    ms = make_ms(tmp_db, llm_provider=Chunky(),
                 embedding_provider=MockEmbedder())
    events = list(ms.chat_stream("hello"))
    assert events[0] == {"type": "info", "content": "✓ Conversation started"}
    assert [e["content"] for e in events if e["type"] == "token"] == \
        ["one ", "two ", "three"]
    assert ms.metrics["llm_calls"] == 1
    assert ms.short_term_memory[-1]["content"] == "one two three"
    ms.close()


def test_ondevice_llm_json_mode_with_subword_tokenizer():
    class SubwordTok:
        eos_id = 2

    class StubLM:
        tokenizer = SubwordTok()

        def generate(self, prompt, max_new_tokens=128, temperature=0.0):
            return 'Sure thing!\n```json\n{"memories": [{"a": 1}]}\n```\ndone'

        def generate_json(self, *a, **k):
            raise ValueError("generate_json requires the byte tokenizer")

    llm = OnDeviceLLM(lm=StubLM())
    out = llm.completion([{"role": "user", "content": "extract"}],
                         response_format={"type": "json_object"})
    assert json.loads(out) == {"memories": [{"a": 1}]}
    assert json.loads(_extract_json_object('noise {"k": "a}b{c"} tail')) == \
        {"k": "a}b{c"}
    assert _extract_json_object("no json here") == "no json here"


def test_extract_json_skips_non_json_fence():
    out = _extract_json_object('```\npseudo code\n```\n{"memories": [1]}')
    assert json.loads(out) == {"memories": [1]}


def test_extract_json_prefers_parseable_block():
    out = _extract_json_object('```\nif x { return y }\n```\n{"memories": [1]}')
    assert json.loads(out) == {"memories": [1]}
    out = _extract_json_object('here: [{"a": 1}, {"b": 2}] done')
    assert json.loads(out) == [{"a": 1}, {"b": 2}]


def test_profile_extraction_survives_array_response(tmp_db):
    class ArrayLLM:
        def completion(self, messages, response_format=None):
            return '["preferences", "not a dict"]'

    ms = make_ms(tmp_db, llm_provider=ArrayLLM())
    assert "Failed" in ms._extract_profile_from_contents(["likes climbing"])
    ms.close()


def _dialogue(root, cls):
    from tests.test_torch_fused_ingest import ClusteredEmb, QueueLLM

    kw = {"device": "cpu"} if cls is MemorySystem else {}
    ms = cls(enable_async=False, load_from_disk=False, db_dir=root,
             verbose=False, llm_provider=QueueLLM(6),
             embedding_provider=ClusteredEmb(), auto_prune=False, **kw)
    for c in range(2):
        ms.start_conversation()
        ms.add_to_short_term(f"conv {c}", "episodic", 0.7)
        ms.end_conversation()
    return ms


def test_observations_insights_and_displays_match_jax(tmp_path):
    """``export_observations`` (JSON and markdown), ``get_insights``'s
    prompt, ``get_connected_memories`` and the ``display_*`` texts after the
    same dialogue on both packages."""
    t = _dialogue(str(tmp_path / "t"), MemorySystem)
    j = _dialogue(str(tmp_path / "j"), JaxSystem)
    try:
        tj, jj = (json.loads(m.export_observations("json")) for m in (t, j))
        key = lambda n: (n["content"], n["type"], n["shard_key"],   # noqa: E731
                         round(n["salience"], 5))
        assert [key(n) for n in tj] == [key(n) for n in jj]
        assert len(tj) >= 8
        md = t.export_observations()
        assert md.startswith(f"# Memory Observations for {t.user_id}")
        assert md.count("### ") == len(tj)
        for ms in (t, j):
            ms.llm = MockLLM(response="insight")
        assert t.get_insights() == "insight"
        j.get_insights()
        assert t.llm.calls[0][0]["content"] == j.llm.calls[0][0]["content"]
        assert json.loads(t.llm.calls[0][1]["content"].split("\n", 1)[1]) == tj

        def connected(ms, content):
            by_content = {n.content: n.id for n in ms.buffer.nodes.values()}
            return sorted(n.content for n in
                          ms.get_connected_memories(by_content[content]))

        linked = sorted({j.buffer.get_node(a).content
                         for sh in j.shards.values() for a, _ in sh.edges})
        assert linked
        for content in linked:
            assert connected(t, content) == connected(j, content)
            assert connected(t, content)
        assert t.display_profile() == j.display_profile()
        assert t.display_memories(5).splitlines()[1] == \
            j.display_memories(5).splitlines()[1]
        assert t.display_memories(5).count("\n") == \
            j.display_memories(5).count("\n")
        st, sj = t.display_stats(), j.display_stats()
        assert st.splitlines()[:8] == sj.splitlines()[:8]
    finally:
        t.close()
        j.close()
