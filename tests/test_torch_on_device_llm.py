"""``OnDeviceLLM`` in the port's memory pipeline: a real decoder (random
tiny weights carried across from the JAX package) answers the chat turn and
drives ``end_conversation``'s fact extraction through the constrained JSON
decode, on the CPU. Every completion the port's provider returned must be
the one the JAX provider returns for the same messages.
"""

import json

import jax
import numpy as np
import pytest

from lazzaro_tpu.core.providers import OnDeviceLLM as JaxOnDeviceLLM
from lazzaro_tpu.models.llm import LanguageModel as JaxLM
from lazzaro_tpu.models.llm import LMConfig as JaxConfig
from lazzaro_tpu_torch import MemorySystem
from lazzaro_tpu_torch.core.interfaces import LLMProvider
from lazzaro_tpu_torch.core.providers import OnDeviceLLM
from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig, params_from_jax


@pytest.fixture(scope="module")
def providers():
    jlm = JaxLM(JaxConfig.tiny(), seed=3)
    tree = jax.tree_util.tree_map(np.asarray, jlm.params)
    lm = LanguageModel(LMConfig.tiny(), device="cpu",
                       decoder=params_from_jax(tree, LMConfig.tiny()))
    return (JaxOnDeviceLLM(lm=jlm, max_new_tokens=48),
            OnDeviceLLM(lm=lm, max_new_tokens=48))


class Recording:
    """Wraps a provider and keeps every (messages, format, reply)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def completion(self, messages, response_format=None):
        out = self.inner.completion(messages, response_format)
        self.calls.append((messages, response_format, out))
        return out


def test_on_device_llm_drives_the_memory_pipeline(providers, tmp_path):
    jax_llm, llm = providers
    rec = Recording(llm)
    ms = MemorySystem(enable_async=False, load_from_disk=False,
                      db_dir=str(tmp_path), verbose=False, llm_provider=rec,
                      device="cpu")
    try:
        ms.start_conversation()
        reply = ms.chat("I work as a data engineer on a big ETL project.")
        out = ms.end_conversation()
        assert "Consolidation complete" in out
        assert isinstance(ms.search_memories("data engineer"), list)
    finally:
        ms.close()
    kinds = [fmt for _, fmt, _ in rec.calls]
    assert kinds == [None, {"type": "json_object"}]
    assert rec.calls[0][2] == reply
    json.loads(rec.calls[1][2])                 # the extraction parses
    for messages, fmt, got in rec.calls:
        assert got == jax_llm.completion(messages, fmt)


def test_streams_and_protocol(providers):
    jax_llm, llm = providers
    assert isinstance(llm, LLMProvider)
    msgs = [{"role": "user", "content": "hi"}]
    out = llm.completion(msgs)
    assert out == jax_llm.completion(msgs)
    assert "".join(llm.completion_stream(msgs)) == out
    doc = "".join(llm.completion_stream(msgs, {"type": "json_object"}))
    assert isinstance(json.loads(doc), dict)


def test_json_scaffold(providers):
    jax_llm, llm = providers
    scaffold = '{"memories": [{"content": "'
    mine = OnDeviceLLM(lm=llm.lm, max_new_tokens=32, json_scaffold=scaffold)
    theirs = JaxOnDeviceLLM(lm=jax_llm.lm, max_new_tokens=32,
                            json_scaffold=scaffold)
    msgs = [{"role": "user", "content": "extract"}]
    doc = mine.completion(msgs, {"type": "json_object"})
    assert doc.startswith(scaffold) and doc == theirs.completion(
        msgs, {"type": "json_object"})
    json.loads(doc)


def test_subword_tokenizer_falls_back_to_extraction():
    """A non-byte tokenizer cannot take the byte automaton: the provider
    decodes free text and extracts the JSON (and refuses a scaffold)."""

    class SubwordTok:
        eos_id = 1

        def encode(self, text, add_bos=True, add_eos=False):
            return [5, 6, 7]

        def decode(self, ids):
            return '{"a": 1} ' + " ".join(f"w{i}" for i in ids)

    lm = LanguageModel(LMConfig.tiny(), seed=2, device="cpu",
                       tokenizer=SubwordTok())
    with pytest.raises(ValueError, match="ByteTokenizer"):
        OnDeviceLLM(lm=lm, json_scaffold="{")
    out = OnDeviceLLM(lm=lm, max_new_tokens=4).completion(
        [{"role": "user", "content": "x"}], {"type": "json_object"})
    assert json.loads(out) == {"a": 1}
