"""Offline providers of the port, a subset of ``lazzaro_tpu/core/providers.py``.

``HashingEmbedder`` and ``HeuristicLLM`` run with no weights and no network
and are the constructor defaults; ``infer_topic`` routes facts to shards and
``_extract_json_object`` pulls the JSON out of an extraction reply.
``OnDeviceLLM`` runs the in-tree decoder LM (``models/llm.py``) on the card.
The remote providers and the encoder embedder are not ported yet (ROADMAP
Queue 1 items 10 and 20).
"""

from __future__ import annotations

import hashlib
import json
import re
from typing import Dict, Iterator, List, Optional

import numpy as np

from lazzaro_tpu_torch.models.tokenizer import ByteTokenizer


def _balanced_block(text: str, start: int) -> Optional[str]:
    """The balanced {...} or [...] block opening at ``start`` (delimiter-
    counted, string-aware), or None if it never closes."""
    open_c = text[start]
    close_c = "}" if open_c == "{" else "]"
    depth, in_str, esc = 0, False, False
    for i in range(start, len(text)):
        c = text[i]
        if in_str:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == open_c:
            depth += 1
        elif c == close_c:
            depth -= 1
            if depth == 0:
                return text[start:i + 1]
    return None


def _extract_json_object(text: str, max_candidates: int = 20) -> str:
    """Best-effort JSON extraction from free-form model output: prefer a
    ``` fence whose content actually parses, else the first balanced
    {...}/[...] block in the text that parses (so a pseudo-code fence with
    braces can't eat a trailing real object), else the first balanced block,
    else the raw text — keeping the caller's own JSON error handling as the
    single point of failure."""
    try:
        json.loads(text)          # already-valid JSON: no scanning needed
        return text
    except ValueError:
        pass
    fenced = re.search(r"```(?:json)?\s*(.*?)```", text, re.DOTALL)
    if fenced:
        inner = fenced.group(1)
        m = re.search(r"[{\[]", inner)
        if m:
            block = _balanced_block(inner, m.start())
            if block is not None:
                try:
                    json.loads(block)
                    return block
                except ValueError:
                    pass
    first_block = None
    for n, m in enumerate(re.finditer(r"[{\[]", text)):
        if n >= max_candidates:
            break
        block = _balanced_block(text, m.start())
        if block is None:
            continue
        if first_block is None:
            first_block = block
        try:
            json.loads(block)
            return block
        except ValueError:
            continue
    return first_block if first_block is not None else text.strip()

# ---------------------------------------------------------------------------
# Embedding providers
# ---------------------------------------------------------------------------


class HashingEmbedder:
    """Deterministic feature-hashing embedder — zero weights, zero network.

    Unigrams + bigrams hash into signed buckets, L2-normalized. Texts sharing
    vocabulary get high cosine similarity, which is exactly the property the
    memory pipeline's thresholds (dedup 0.95, link 0.5) operate on. Default
    provider for tests and for fully-offline operation."""

    def __init__(self, dim: int = 256):
        self.dim = dim

    def _vec(self, text: str) -> np.ndarray:
        v = np.zeros(self.dim, np.float32)
        toks = re.findall(r"[a-z0-9]+", text.lower())
        grams = toks + [f"{a}_{b}" for a, b in zip(toks, toks[1:])]
        for g in grams:
            h = hashlib.blake2b(g.encode(), digest_size=8).digest()
            idx = int.from_bytes(h[:4], "little") % self.dim
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed(self, text: str) -> List[float]:
        return self._vec(text).tolist()

    def batch_embed(self, texts: List[str]) -> List[List[float]]:
        return [self._vec(t).tolist() for t in texts]


# ---------------------------------------------------------------------------
# LLM providers
# ---------------------------------------------------------------------------

_SHARD_KEYWORDS = {
    "work": ["work", "project", "meeting", "deadline", "client", "colleague"],
    "personal": ["family", "friend", "hobby", "home", "personal"],
    "learning": ["learn", "study", "course", "book", "tutorial", "practice"],
    "health": ["health", "exercise", "diet", "sleep", "medical", "fitness"],
}


def infer_topic(content: str) -> str:
    low = content.lower()
    for topic, terms in _SHARD_KEYWORDS.items():
        if any(t in low for t in terms):
            return topic
    return "other"


class HeuristicLLM:
    """Rule-based completion provider: makes the whole pipeline runnable with
    no trained weights and no network.

    Recognizes the three structured prompt families the orchestrator emits
    (fact extraction, profile insight, whole-graph insights — reference
    memory_system.py:664-676, :1027-1030, :1521-1543) and answers them with
    deterministic JSON derived from the prompt payload; plain chat gets a
    retrieval-grounded template answer."""

    def completion(self, messages: List[Dict[str, str]],
                   response_format: Optional[Dict] = None) -> str:
        system = next((m["content"] for m in messages if m["role"] == "system"), "")
        user = next((m["content"] for m in reversed(messages) if m["role"] == "user"), "")
        if "Extract distinct, atomic facts" in system:
            return self._extract_facts(user)
        if "Analyze these related memories" in system:
            return self._profile_insight(user)
        if "comprehensive psychological" in system:
            return self._insights(user)
        return self._chat(messages)

    # -- prompt families ----------------------------------------------------
    def _extract_facts(self, payload: str) -> str:
        try:
            memories = json.loads(payload)
        except json.JSONDecodeError:
            memories = [{"content": payload, "type": "semantic", "salience": 0.5}]
        facts, seen = [], set()
        for mem in memories:
            if not isinstance(mem, dict):
                continue
            content = (mem.get("content") or "").strip()
            for sentence in re.split(r"(?<=[.!?])\s+", content):
                sentence = sentence.strip().rstrip(".")
                if len(sentence) < 5:
                    continue
                key = sentence.lower()
                if key in seen:
                    continue
                seen.add(key)
                facts.append({
                    "content": sentence,
                    "type": mem.get("type", "semantic"),
                    "salience": float(mem.get("salience", 0.5)),
                    "topic": infer_topic(sentence),
                })
        return json.dumps({"memories": facts})

    def _profile_insight(self, payload: str) -> str:
        contents = [l[2:].strip() for l in payload.splitlines() if l.startswith("- ")]
        words: Dict[str, int] = {}
        for c in contents:
            for w in re.findall(r"[a-z]{4,}", c.lower()):
                words[w] = words.get(w, 0) + 1
        themes = ", ".join(w for w, _ in sorted(words.items(), key=lambda x: -x[1])[:3])
        out = {}
        if themes:
            out["knowledge_domains"] = f"Recurring themes: {themes}."
        if contents:
            out["key_experiences"] = contents[0][:120]
        return json.dumps(out)

    def _insights(self, payload: str) -> str:
        return ("1. **Personality Traits**: Consistent and focused based on stored memories.\n"
                "2. **Core Interests & Knowledge**: See recurring memory topics.\n"
                "3. **Behavioral Patterns**: Regular interaction cadence.\n"
                "4. **Recent Focus**: Most recent high-salience memories.")

    def _chat(self, messages: List[Dict[str, str]]) -> str:
        user = next((m["content"] for m in reversed(messages) if m["role"] == "user"), "")
        context = [m["content"] for m in messages
                   if m["role"] == "system" and "Relevant Information" in m["content"]]
        if context:
            bullets = [l for l in context[0].splitlines() if l.startswith("- ")]
            if bullets:
                return ("Based on what I remember: " + "; ".join(b[2:] for b in bullets[:3])
                        + f". Regarding '{user[:80]}': noted.")
        return f"Understood: {user[:120]}"


class OnDeviceLLM:
    """The in-tree decoder LM (``lazzaro_tpu_torch.models.llm``) as the LLM
    provider: greedy or temperature sampling with a KV cache on the card.

    With ``response_format={"type": "json_object"}`` the decode runs under
    the byte-level JSON grammar automaton, so the consolidation pipeline's
    extraction prompts get valid JSON by construction, from any weights.
    With random weights free-text output is noise."""

    def __init__(self, lm=None, max_new_tokens: int = 128,
                 temperature: float = 0.0,
                 json_scaffold: Optional[str] = None):
        if lm is None:
            from lazzaro_tpu_torch.models.llm import LanguageModel, LMConfig
            lm = LanguageModel(LMConfig.small())
        self.lm = lm
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        # Optional schema scaffold for json_object responses: a literal JSON
        # prefix the constrained decode must start with (e.g.
        # '{"memories": [{"content": "'). Byte tokenizer only: a subword
        # vocabulary cannot teacher-force a byte-exact prefix.
        if json_scaffold is not None and not isinstance(self.lm.tokenizer,
                                                        ByteTokenizer):
            raise ValueError(
                "json_scaffold requires a ByteTokenizer-backed model; "
                "subword vocabularies cannot teacher-force a byte-exact "
                "JSON prefix")
        self.json_scaffold = json_scaffold

    def _render(self, messages: List[Dict[str, str]]) -> str:
        parts = [f"{m['role'].capitalize()}: {m['content']}" for m in messages]
        return "\n".join(parts) + "\nAssistant:"

    def completion(self, messages: List[Dict[str, str]],
                   response_format: Optional[Dict] = None) -> str:
        if response_format and response_format.get("type") == "json_object":
            if isinstance(self.lm.tokenizer, ByteTokenizer):
                return self.lm.generate_json(self._render(messages),
                                             max_new_tokens=self.max_new_tokens,
                                             temperature=self.temperature,
                                             scaffold=self.json_scaffold)
            # Subword tokenizer: the byte automaton cannot mask its logits,
            # so decode free text and extract the JSON. The instruction goes
            # in as a system turn BEFORE the final "Assistant:" cue.
            json_prompt = self._render(
                messages + [{"role": "system",
                             "content": "Respond with a single JSON object only."}])
            text = self.lm.generate(json_prompt,
                                    max_new_tokens=self.max_new_tokens,
                                    temperature=self.temperature)
            return _extract_json_object(text)
        return self.lm.generate(self._render(messages),
                                max_new_tokens=self.max_new_tokens,
                                temperature=self.temperature)

    def completion_stream(self, messages: List[Dict[str, str]],
                          response_format: Optional[Dict] = None) -> Iterator[str]:
        if response_format and response_format.get("type") == "json_object":
            # Constrained decoding cannot stream piecewise (the budget repair
            # may rewrite the tail); emit the finished document.
            yield self.completion(messages, response_format)
            return
        yield from self.lm.generate_stream(self._render(messages),
                                           max_new_tokens=self.max_new_tokens,
                                           temperature=self.temperature)
