"""MemorySystem: the orchestrator of the PyTorch/CUDA port.

Counterpart of ``lazzaro_tpu/core/memory_system.py``. Serving is fused by
default (``serve_fused=True``): a chat turn or a ``search_memories[_batch]``
call goes through the ``QueryScheduler`` to
``MemoryIndex.search_fused_requests``, one launch of the two-tier top-k
kernel (super-node gate + ANN) with the neighbor and access boosts applied
on the device, and one packed readback. With ``serve_fused=False`` a chat
turn runs the gate and the ANN search as two launches of the masked top-k
kernel and pays the boosts as separate scatters. Ingest is fused by default
too (``ingest_fused=True, ingest_dedup_fused=True``): a conversation end
extracts facts and hands each mega-batch of them to
``MemoryIndex.ingest_batch_dedup``, ONE device dispatch (the ingest scan
kernel's dedup probe and link lists, the resolve kernel, node scatter, merge
touch, chain and gated link edges) and ONE packed readback, then decays,
prunes and evicts. The classic ingest (both flags off) probes the facts with
one batched top-1 search, adds the new ones and links them with a second
scan; ``ingest_fused`` alone fuses everything but the probe. With ``mesh``
the arena is row-sharded over the mesh's devices (``core.index``): every
scan runs per shard and a merge kernel combines the shards' candidates; the
fused ingest under a mesh is not ported yet, so a mesh takes the classic
flags.

Every ``consolidate_every``-th conversation end runs ``run_consolidation``
(``auto_consolidate``, on by default as in JAX): the all-pairs merge of
near-duplicate nodes (one launch of the pairwise scan kernel and one
readback, ``MemoryIndex.merge_candidates``), profile extraction from the
strong components of the graph, and a weak-edge prune.

State is durable as in the JAX package. The default store is
``ArrowStore(db_dir)`` (``core.store``, segmented parquet): every
conversation end saves the rows and edges it dirtied (a full rewrite before
the first sync), a construction with ``load_from_disk`` and every
``switch_user`` reload the tenant from the store, its rows going to the
device in one upload, and the decay sweeps a stored row missed are replayed
bit-for-bit on the way. Under the store's ``db_dir`` two journals run on the
port's write-ahead log (``native``): the turn journal holds the turns not yet
durable in the store, and the ingest journal (``reliability.journal``) the
extracted facts between their extraction and their landing in the arena; a
restart recovers the turns and replays the facts through the fused ingest,
where the dedup probe makes the replay idempotent. ``save_snapshot`` /
``load_snapshot`` write and restore the index checkpoint of every tenant
(``core.checkpoint``) with the current user's host graph, ``save_state`` /
``load_state`` the user's graph as JSON.

``lifecycle_tick`` (called by hand, or every ``lifecycle_interval_s`` from
a background pump) runs the maintenance of every tenant, salience and edge
decay, the weak-edge prune and the archive verdicts, as ONE dispatch and
one packed readback (``MemoryIndex.lifecycle_sweep``;
``lifecycle_fused=False``: the classic per-tenant loop). The conversation
end keeps its own per-tenant decay, prune and eviction, as in JAX.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np

from lazzaro_tpu_torch.config import MemoryConfig
from lazzaro_tpu_torch.core.buffer_graph import BufferGraph
from lazzaro_tpu_torch.core.index import MemoryIndex
from lazzaro_tpu_torch.core.memory_shard import MemoryShard
from lazzaro_tpu_torch.core.profile import Profile
from lazzaro_tpu_torch.core.providers import (HashingEmbedder, HeuristicLLM,
                                              _extract_json_object, infer_topic)
from lazzaro_tpu_torch.core.query_cache import QueryCache
from lazzaro_tpu_torch.core.store import ArrowStore
from lazzaro_tpu_torch.models.graph import Edge, Node
from lazzaro_tpu_torch.reliability import faults
from lazzaro_tpu_torch.serve.scheduler import QueryScheduler, RetrievalRequest
from lazzaro_tpu_torch.utils.batching import IngestCoalescer
from lazzaro_tpu_torch.utils.telemetry import Telemetry

_logger = logging.getLogger("lazzaro_tpu_torch.memory_system")

_SHARDED_INGEST_ITEM = "Queue 1 item 21, sharded fused ingest"
_SHARDED_CONSOLIDATION_ITEM = "Queue 1 item 21, the all-pairs merge scan under a mesh"


class _LifecyclePump:
    """Background maintenance thread: calls ``system.lifecycle_tick()``
    every ``interval_s`` (``lazzaro_tpu/core/memory_system.py:
    _LifecyclePump``). The tick defers itself while serving load is queued,
    so the pump is a plain metronome."""

    def __init__(self, system: "MemorySystem", interval_s: float):
        self._system = system
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="lifecycle-pump", daemon=True)

    def start(self) -> "_LifecyclePump":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._system.lifecycle_tick()
            except Exception:                            # pragma: no cover
                _logger.exception("lifecycle tick failed")


def _ensure_log_handler() -> None:
    """One bare-message stderr handler on the package logger when neither it
    nor the root logger is configured, so ``verbose=True`` is visible."""
    pkg = logging.getLogger("lazzaro_tpu_torch")
    if pkg.handlers or logging.root.handlers:
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    pkg.addHandler(handler)
    if pkg.level == logging.NOTSET:
        pkg.setLevel(logging.INFO)


class MemorySystem:
    # Above this many arena rows the per-conversation full host sync is
    # skipped (the arena stays authoritative).
    _SYNC_FULL_MAX = 20_000

    def __init__(
        self,
        enable_sharding: Optional[bool] = None,
        enable_hierarchy: Optional[bool] = None,
        enable_caching: Optional[bool] = None,
        enable_async: Optional[bool] = None,
        max_shard_size: Optional[int] = None,
        super_node_threshold: Optional[int] = None,
        auto_consolidate: Optional[bool] = None,
        consolidate_every: Optional[int] = None,
        auto_prune: Optional[bool] = None,
        prune_threshold: Optional[float] = None,
        max_buffer_size: Optional[int] = None,
        load_from_disk: Optional[bool] = None,
        db_dir: Optional[str] = None,
        user_id: Optional[str] = None,
        llm_provider=None,
        embedding_provider=None,
        store=None,
        config: Optional[MemoryConfig] = None,
        verbose: bool = True,
        mesh=None,
        device=None,
    ):
        """``device`` defaults to ``"cuda"`` and raises ``RuntimeError``
        without a GPU; ``device="cpu"`` runs every kernel's plain version.
        ``mesh`` (``lazzaro_tpu_torch.parallel.make_mesh(...)``) row-shards
        the arena over the mesh's devices, which then replace ``device``."""
        self.config = config or MemoryConfig()
        cfg = self.config

        def pick(kwarg, field):
            if kwarg is not None:
                setattr(cfg, field, kwarg)
            return getattr(cfg, field)

        self.enable_sharding = pick(enable_sharding, "enable_sharding")
        self.enable_hierarchy = pick(enable_hierarchy, "enable_hierarchy")
        self.enable_caching = pick(enable_caching, "enable_caching")
        self.enable_async = pick(enable_async, "enable_async")
        self.max_shard_size = pick(max_shard_size, "max_shard_size")
        self.super_node_threshold = pick(super_node_threshold, "super_node_threshold")
        self.auto_consolidate = pick(auto_consolidate, "auto_consolidate")
        self.consolidate_every = pick(consolidate_every, "consolidate_every")
        self.auto_prune = pick(auto_prune, "auto_prune")
        self.prune_threshold = pick(prune_threshold, "prune_threshold")
        self.max_buffer_size = pick(max_buffer_size, "max_buffer_size")
        db_dir = pick(db_dir, "db_dir")
        self.user_id = pick(user_id, "user_id")
        load_from_disk = pick(load_from_disk, "load_from_disk")
        self.verbose = verbose

        cfg.check_ported()
        if mesh is not None and cfg.ingest_fused:
            raise NotImplementedError(
                "MemorySystem(mesh=...) with ingest_fused=True: not ported yet "
                f"(ROADMAP {_SHARDED_INGEST_ITEM}); pass ingest_fused=False, "
                "ingest_dedup_fused=False for the classic ingest")
        if mesh is not None and self.auto_consolidate:
            raise NotImplementedError(
                "MemorySystem(mesh=...) with auto_consolidate=True: not ported "
                f"yet (ROADMAP {_SHARDED_CONSOLIDATION_ITEM}); pass "
                "auto_consolidate=False")

        self.llm = llm_provider if llm_provider is not None else HeuristicLLM()
        self.embedder = (embedding_provider if embedding_provider is not None
                         else HashingEmbedder(dim=cfg.embed_dim))
        dim = getattr(self.embedder, "dim", None)
        if not isinstance(dim, int) or dim <= 0:
            dim = len(self.embedder.embed("dimension probe"))
        self.embed_dim = dim

        self.store = store if store is not None else ArrowStore(db_dir)
        self.vector_store = self.store      # the JAX package's alias

        self.shards: Dict[str, MemoryShard] = {}
        self.super_nodes: Dict[str, Node] = {}
        # O(1) placement caches: edge_key -> shard_key and node_id ->
        # shard_key, validated on read and rebuilt on a miss.
        self._edge_shard: Dict[Tuple[str, str], str] = {}
        self._node_shard_cache: Dict[str, str] = {}
        self.buffer = BufferGraph(self.shards, self.super_nodes)
        self.profile = Profile()
        self.telemetry = Telemetry(cfg.serve_telemetry_window,
                                   enabled=cfg.serve_telemetry)
        self.mesh = mesh
        self.index = MemoryIndex(dim, capacity=cfg.initial_capacity,
                                 edge_capacity=cfg.max_edges,
                                 dtype=cfg.dtype, device=device, mesh=mesh,
                                 telemetry=self.telemetry,
                                 serve_ragged=cfg.serve_ragged,
                                 serve_k_max=cfg.serve_k_max,
                                 serve_pad_granularity=cfg.serve_pad_granularity,
                                 **self._index_reliability_kwargs())
        self.device = self.index.device
        self.query_scheduler: Optional[QueryScheduler] = None
        self.query_cache = QueryCache(cfg.cache_size) if self.enable_caching else None

        self.short_term_memory: List[Dict] = []
        self.conversation_history: List[Dict] = []
        self.conversation_active = False
        self.conversation_count = 0
        self.node_counter = 0
        self.consolidation_queue: List[Dict] = []
        self._inflight_batches: List[Dict] = []   # popped, not yet ingested
        self._deferred_batches: List[Dict] = []   # held back by the flush policy
        self._ingest_coalescer = IngestCoalescer(cfg.ingest_coalesce_max,
                                                 cfg.ingest_flush_wait_s)
        # Deferred boosts of query-cache-hit chat turns:
        # node_id -> [access_count, neighbor_count, latest_now].
        self._pending_boosts: Dict[str, List] = {}

        # Incremental persistence: the node ids and edge keys changed since
        # the last save, which then upserts only those rows as delta
        # segments. Decay is never written per row: ``_decay_pass`` counts
        # sweeps, each row is stamped with the pass it was written at, and
        # a reload replays the passes it missed.
        self._supports_incremental = (
            hasattr(self.store, "save_sys_meta")
            and hasattr(self.store, "get_nodes_columns"))
        self._store_synced = False     # False: the next save rewrites all
        self._decay_pass = 0
        self._dirty_nodes: Set[str] = set()
        self._dirty_edges: Set[Tuple[str, str]] = set()
        self._deleted_edge_ids: Set[str] = set()

        # Single-writer ingest: one worker thread + one mutation lock.
        self._mutex = threading.RLock()
        self.background_executor = (ThreadPoolExecutor(max_workers=1)
                                    if self.enable_async else None)
        self.metrics = {"embedding_calls": 0, "llm_calls": 0, "edges_linked": 0}
        self._last_version = -1

        if load_from_disk:
            self._load_from_persistence()
        self._journal = None
        self._recovered_turns = False
        self._setup_journal(replay=bool(load_from_disk))
        # Extracted facts are appended before they enter the coalescer,
        # committed after their dispatch lands, replayed here on startup.
        self._ingest_journal = None
        self._setup_ingest_journal(replay=bool(load_from_disk))
        # Periodic all-tenant maintenance (decay, prune, archive verdicts in
        # one dispatch); a 0 interval leaves the ticks to the caller.
        self.lifecycle_pump = None
        if cfg.lifecycle_interval_s > 0 and self.enable_async:
            self.lifecycle_pump = _LifecyclePump(
                self, cfg.lifecycle_interval_s).start()

    def _index_reliability_kwargs(self) -> Dict[str, Any]:
        """The index settings of int8 serving and the dispatch guard, from
        the config (``lazzaro_tpu/core/memory_system.py:188-207``)."""
        cfg = self.config
        return dict(int8_serving=cfg.int8_serving,
                    coarse_slack=cfg.coarse_fetch_slack,
                    dispatch_retry_max=cfg.dispatch_retry_max,
                    dispatch_retry_backoff_s=cfg.dispatch_retry_backoff_s)

    # --------------------------------------------------------------- journal
    #
    # The turn journal always holds exactly the turns not yet durable in
    # the store: the queued and in-flight batches, the deferred ones, and
    # the current short-term buffer. It is rewritten (not truncated) at
    # every transition, so a background consolidation ending after a new
    # conversation started cannot wipe fresh turns.

    def _setup_journal(self, replay: bool = True) -> None:
        """Open this user's turn journal; with ``replay``, recover the turns
        a crashed process left: they return to short-term memory with the
        conversation open, so the next ``end_conversation`` (or a
        ``start_conversation``, which consolidates them first) persists
        them. Journaling needs a store with a ``db_dir``."""
        self._journal = None
        self._recovered_turns = False
        journal_dir = getattr(self.store, "db_dir", None)
        if not self.config.journal or not journal_dir:
            return
        from urllib.parse import quote

        from lazzaro_tpu_torch.native import WriteAheadLog

        path = f"{journal_dir}/journal__{quote(self.user_id, safe='')}.wal"
        self._journal = WriteAheadLog(path, fsync=self.config.journal_fsync)
        if not replay:
            return
        recovered = []
        for payload in self._journal.replay():
            try:
                turn = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue
            if isinstance(turn, dict) and turn.get("content"):
                recovered.append(turn)
        if recovered:
            self.short_term_memory = recovered
            self.conversation_active = True
            self._recovered_turns = True
            self._log(f"🛟 Recovered {len(recovered)} unconsolidated turn(s) "
                      "from the journal")

    def _journal_turn(self, turn: Dict) -> None:
        if self._journal is not None:
            try:
                self._journal.append(json.dumps(turn).encode("utf-8"))
            except OSError as e:
                self._log(f"⚠ Journal append failed: {e}")

    def _journal_sync(self) -> None:
        """Rewrite the turn journal to the turns not yet durable (callers
        hold ``self._mutex``). A failed rewrite is dropped, as in the JAX
        package: the journal is a recovery aid, the store the record."""
        if self._journal is None:
            return
        turns: List[Dict] = []
        for batch in (self._deferred_batches + self._inflight_batches
                      + self.consolidation_queue):
            turns.extend(batch.get("memories", []))
        if self.conversation_active:
            turns.extend(self.short_term_memory)
        try:
            self._journal.reset()
            for t in turns:
                self._journal.append(json.dumps(t).encode("utf-8"))
        except OSError:
            pass

    def _setup_ingest_journal(self, replay: bool = True) -> None:
        """Open this user's fact journal; with ``replay``, ingest the fact
        batches a crashed process left uncommitted. Facts that landed before
        the crash resolve as duplicates in the ingest's dedup probe, so none
        is lost and none is ingested twice."""
        self._ingest_journal = None
        journal_dir = getattr(self.store, "db_dir", None)
        if not self.config.ingest_journal or not journal_dir:
            return
        from urllib.parse import quote

        from lazzaro_tpu_torch.reliability.journal import IngestJournal

        path = f"{journal_dir}/ingest__{quote(self.user_id, safe='')}.wal"
        try:
            self._ingest_journal = IngestJournal(
                path, fsync=self.config.ingest_journal_fsync)
        except OSError as e:
            self._log(f"⚠ Ingest journal unavailable: {e}")
            return
        if not replay:
            return
        pending = self._ingest_journal.pending()
        if not pending:
            return
        n_facts = sum(len(f) for _, f in pending)
        self._log(f"🛟 Replaying {n_facts} journaled fact(s) from "
                  f"{len(pending)} uncommitted ingest batch(es)")
        for _seq, facts in pending:
            self._ingest_facts(facts)
        self.telemetry.bump("reliability.journal_replayed", n_facts)
        self._ingest_journal.commit(self._ingest_journal.last_seq)
        self._save_to_persistence()

    # ------------------------------------------------------------------ util
    def _log(self, msg: str) -> None:
        if self.verbose:
            _ensure_log_handler()
            _logger.info(msg)

    def _status(self, results: List[str], msg: str) -> str:
        self._log(msg)
        results.append(msg)
        return msg

    def _q(self, node_id: str) -> str:
        """Tenant-qualified index key (node ids like 'node_1' repeat per user)."""
        return f"{self.user_id}:{node_id}"

    def _generate_node_id(self) -> str:
        self.node_counter += 1
        return f"node_{self.node_counter}"

    def _infer_shard_key(self, content: str) -> str:
        """Keyword topic routing, fallback = current month."""
        if not self.enable_sharding:
            return "default"
        topic = infer_topic(content)
        if topic != "other":
            return topic
        return time.strftime("%Y-%m")

    def _get_or_create_shard(self, shard_key: str) -> MemoryShard:
        if shard_key not in self.shards:
            self.shards[shard_key] = MemoryShard(shard_key)
        return self.shards[shard_key]

    def _get_embedding(self, text: str) -> List[float]:
        self.metrics["embedding_calls"] += 1
        if self.query_cache:
            cached = self.query_cache.get_embedding(text)
            if cached:
                return cached
        embedding = self.embedder.embed(text)
        if self.query_cache:
            self.query_cache.set_embedding(text, embedding)
        return embedding

    def _batch_embed(self, texts: List[str]):
        if not texts:
            return []
        self.metrics["embedding_calls"] += 1
        return self.embedder.batch_embed(texts)

    def _call_llm(self, messages: List[Dict], response_format: Optional[Dict] = None) -> str:
        self.metrics["llm_calls"] += 1
        return self.llm.completion(messages, response_format)

    # -------------------------------------------------------- device <-> host
    def _index_add_node(self, node: Node) -> None:
        self.index.add(
            [self._q(node.id)],
            np.asarray(node.embedding, np.float32).reshape(1, -1),
            [node.salience], [node.timestamp], [node.type],
            [node.shard_key or "default"], self.user_id,
            [node.is_super_node])

    def _sync_from_arena(self, node_ids: Optional[Set[str]] = None,
                         edge_keys: Optional[Set[Tuple[str, str]]] = None) -> None:
        """Refresh the mutable numerics of this tenant's host nodes and
        edges from the arena: one bulk pull, or with ``node_ids`` /
        ``edge_keys`` just those rows and edges."""
        if node_ids is not None:
            pairs = [(nid, self.index.id_to_row.get(self._q(nid)))
                     for nid in node_ids]
            pairs = [(nid, row) for nid, row in pairs if row is not None]
            if pairs:
                cols = self.index.pull_numeric_rows([r for _, r in pairs])
                for i, (nid, _row) in enumerate(pairs):
                    node = self.buffer.get_node(nid)
                    if node is None:
                        continue
                    node.salience = float(cols["salience"][i])
                    node.last_accessed = float(cols["last_accessed"][i])
                    node.access_count = int(cols["access_count"][i])
            keys = {(self._q(s), self._q(t)) for s, t in (edge_keys or set())}
            if not keys:
                return
            for (qsrc, qtgt), (w, co) in self.index.edge_weights_for(sorted(keys)).items():
                edge = self._find_edge((qsrc.partition(":")[2],
                                        qtgt.partition(":")[2]))
                if edge is not None:
                    edge.weight = w
                    edge.co_occurrence = co
            return
        cols = self.index.pull_numeric()
        for qid, row in self.index.id_to_row.items():
            user, _, nid = qid.partition(":")
            if user != self.user_id:
                continue
            node = self.buffer.get_node(nid)
            if node is None:
                continue
            node.salience = float(cols["salience"][row])
            node.last_accessed = float(cols["last_accessed"][row])
            node.access_count = int(cols["access_count"][row])
        for (qsrc, qtgt), (w, co) in self.index.edge_weights().items():
            user, _, src = qsrc.partition(":")
            if user != self.user_id:
                continue
            edge = self._find_edge((src, qtgt.partition(":")[2]))
            if edge is not None:
                edge.weight = w
                edge.co_occurrence = co

    # ------------------------------------------------------- dirty tracking
    def _mark_dirty(self, *node_ids: str) -> None:
        self._dirty_nodes.update(node_ids)

    def _mark_edge_dirty(self, key: Tuple[str, str]) -> None:
        # An edge deleted and re-created within one save interval needs no
        # cancellation: the save writes tombstones before upserts.
        self._dirty_edges.add(key)

    @staticmethod
    def _store_edge_id(edge: Edge) -> str:
        """ArrowStore's edge id (``src|tgt|type``)."""
        return f"{edge.source}|{edge.target}|{edge.edge_type}"

    def _mark_edge_deleted(self, edge: Edge) -> None:
        self._deleted_edge_ids.add(self._store_edge_id(edge))
        self._dirty_edges.discard((edge.source, edge.target))

    def _shard_of_node(self, node_id: str) -> Optional[MemoryShard]:
        sk = self._node_shard_cache.get(node_id)
        if sk is not None:
            shard = self.shards.get(sk)
            if shard is not None and node_id in shard.nodes:
                return shard
            del self._node_shard_cache[node_id]
        for sk, shard in self.shards.items():
            if node_id in shard.nodes:
                self._node_shard_cache[node_id] = sk
                return shard
        return None

    def _find_edge(self, key: Tuple[str, str]) -> Optional[Edge]:
        sk = self._edge_shard.get(key)
        if sk is not None:
            shard = self.shards.get(sk)
            edge = shard.edges.get(key) if shard is not None else None
            if edge is not None:
                return edge
            del self._edge_shard[key]
        for sk, shard in self.shards.items():
            edge = shard.edges.get(key)
            if edge is not None:
                self._edge_shard[key] = sk
                return edge
        return None

    # --------------------------------------------------------- conversations
    def start_conversation(self) -> str:
        if self._recovered_turns and self.conversation_active and self.short_term_memory:
            # Turns recovered from the journal are consolidated, not dropped.
            self._log("🛟 Consolidating recovered turns before new conversation...")
            self.end_conversation()
        self._recovered_turns = False
        self.conversation_active = True
        self.short_term_memory = []
        self.conversation_history = []
        with self._mutex:
            self._journal_sync()       # drops an abandoned conversation's turns
        return "✓ Conversation started"

    def add_to_short_term(self, content: str, memory_type: str = "semantic",
                          salience: float = 0.5) -> None:
        if not self.conversation_active:
            raise RuntimeError("No active conversation")
        turn = {"content": content, "type": memory_type,
                "salience": salience, "timestamp": time.time()}
        with self._mutex:
            # One lock over the buffer and the journal append, so a
            # concurrent _journal_sync cannot write the turn twice.
            self.short_term_memory.append(turn)
            self._journal_turn(turn)

    def end_conversation(self) -> str:
        if not self.conversation_active:
            return "⚠ No active conversation to end."
        if not self.short_term_memory:
            self.conversation_active = False
            self._recovered_turns = False
            return "✓ Conversation ended. No memories to consolidate."

        results = []
        n_turns = len(self.short_term_memory)
        with self._mutex:
            self.consolidation_queue.append({
                "memories": self.short_term_memory.copy(),
                "timestamp": time.time(),
            })
            self.conversation_active = False
            self._recovered_turns = False
            self.short_term_memory = []
        if self.enable_async and self.background_executor:
            self._log(f"🔄 Queueing consolidation for {n_turns} exchanges...")
            self.background_executor.submit(self._async_consolidate)
            self._status(results, "✓ Conversation ended (consolidation queued)")
        else:
            self._log(f"🔄 Consolidating {n_turns} exchanges...")
            self._async_consolidate()
            nodes, edges = self.buffer.size()
            self._status(results, f"✓ Consolidation complete. Memory: {nodes} nodes, {edges} edges")

        with self._mutex:
            # Deferred cache-hit boosts land BEFORE the decay sweep.
            self._flush_pending_boosts_locked()
            self.index.decay(self.user_id, self.config.decay_rate,
                             self.config.salience_floor)
            self._decay_pass += 1
            if self.auto_prune:
                pruned = self._prune_weak_edges(self.prune_threshold)
                if pruned > 0:
                    self._status(results, f"✓ Auto-pruned {pruned} weak edges")
            if len(self.index) <= self._SYNC_FULL_MAX:
                self._sync_from_arena()
        self._status(results, "✓ Applied temporal decay")

        self._enforce_buffer_limit()
        self.conversation_count += 1

        if self.auto_consolidate and self.conversation_count % self.consolidate_every == 0:
            self._log(f"🔄 Auto-consolidation triggered (every {self.consolidate_every} conversations)...")
            results.append(self.run_consolidation(persist=False))

        self.short_term_memory = []
        self.conversation_history = []
        self._save_to_persistence()
        return "\n".join(results)

    def _prune_weak_edges(self, threshold: float) -> int:
        """Device prune + host structural cleanup; returns count removed."""
        removed = self.index.prune_edges(self.user_id, threshold)
        count = 0
        for qsrc, qtgt in removed:
            key = (qsrc.partition(":")[2], qtgt.partition(":")[2])
            edge = self._find_edge(key)
            if edge is not None:
                self._mark_edge_deleted(edge)
                del self.shards[self._edge_shard.pop(key)].edges[key]
                count += 1
        if self.query_cache:
            self.query_cache.invalidate_results(self.user_id)
        return count

    # ------------------------------------------------------------ lifecycle
    def lifecycle_tick(self, now: Optional[float] = None,
                       force: bool = False) -> Dict[str, object]:
        """ONE all-tenant maintenance sweep: salience decay, edge decay and
        weak-edge prune, and importance-ranked archive verdicts (bottom-k
        per tenant), in one dispatch and one packed readback
        (``MemoryIndex.lifecycle_sweep``; ``lazzaro_tpu/core/
        memory_system.py:lifecycle_tick``). While the serving scheduler
        reports more than ``lifecycle_busy_load`` queued requests the tick
        defers (``lifecycle.deferred_busy``) unless ``force``.
        ``config.lifecycle_fused = False`` runs the classic per-tenant loop
        instead, the parity oracle. Verdicts feed the tiering demote queue
        where the index has tiering (ROADMAP Queue 1 item 17); without it
        ``archived`` is 0."""
        sched = self.query_scheduler
        if (not force and sched is not None and not sched.closed
                and sched.load() > self.config.lifecycle_busy_load):
            self.telemetry.bump("lifecycle.deferred_busy")
            return {"deferred": True}
        cfg = self.config
        t0 = time.perf_counter()
        with self._mutex:
            passes = {t: 1 for t in self.index._tenants}
            if cfg.lifecycle_fused:
                out = self.index.lifecycle_sweep(
                    passes, rate=cfg.decay_rate,
                    salience_floor=cfg.salience_floor,
                    prune_threshold=cfg.prune_threshold,
                    weights=(cfg.importance_w_salience,
                             cfg.importance_w_access,
                             cfg.importance_w_recency),
                    archive_k=cfg.lifecycle_archive_k, now=now)
            else:
                out = self._lifecycle_classic(passes, now=now)
            self._decay_pass += 1
            out["pruned_hosts"] = self._lifecycle_cleanup(out)
            if len(self.index) <= self._SYNC_FULL_MAX:
                self._sync_from_arena()
        tiering = getattr(self.index, "tiering", None)
        out["archived"] = 0
        if tiering is not None and cfg.lifecycle_archive_k:
            rows = [row for pairs in out["verdicts"].values()
                    for (_nid, _imp, row) in pairs]
            out["archived"] = tiering.queue_demotions(rows)
        out["deferred"] = False
        self.telemetry.record("lifecycle.sweep_ms",
                              (time.perf_counter() - t0) * 1e3)
        self.telemetry.bump("lifecycle.ticks")
        self.telemetry.bump("lifecycle.archive_verdicts",
                            sum(len(v) for v in out["verdicts"].values()))
        return out

    def _lifecycle_classic(self, passes: Dict[str, int],
                           now: Optional[float] = None) -> Dict[str, object]:
        """The per-tenant loop the fused sweep replaces, kept as the parity
        oracle: the same decay, prune and verdict arithmetic, three device
        round trips per tenant per pass."""
        cfg = self.config
        removed: List[Tuple[str, str]] = []
        verdicts: Dict[str, List[Tuple[str, float, int]]] = {}
        dispatches = 0
        for tenant, owed in passes.items():
            for _ in range(max(0, int(owed))):
                self.index.decay(tenant, cfg.decay_rate, cfg.salience_floor)
                removed.extend(self.index.prune_edges(tenant,
                                                      cfg.prune_threshold))
                dispatches += 2
            if cfg.lifecycle_archive_k:
                cand = self.index.evict_candidates(
                    tenant, cfg.lifecycle_archive_k, now=now,
                    weights=(cfg.importance_w_salience,
                             cfg.importance_w_access,
                             cfg.importance_w_recency))
                verdicts[tenant] = [
                    (nid, imp, self.index.id_to_row.get(nid, -1))
                    for nid, imp in cand]
                dispatches += 1
        return {"verdicts": verdicts, "removed_edges": removed,
                "pruned_edges": len(removed), "dispatches": dispatches}

    def _lifecycle_cleanup(self, out: Dict[str, object]) -> int:
        """Host cleanup after a sweep: the current user's pruned edges leave
        the host mirror (other tenants have none loaded; their edge slots
        are already reclaimed), and the query cache is flushed for each
        tenant that pruned, only for it."""
        touched: Set[str] = set()
        count = 0
        for qsrc, qtgt in out.get("removed_edges", ()):
            tenant = qsrc.partition(":")[0]
            touched.add(tenant)
            key = (qsrc.partition(":")[2], qtgt.partition(":")[2])
            if key not in self._edge_shard:
                continue
            edge = self._find_edge(key)
            if edge is not None:
                self._mark_edge_deleted(edge)
                del self.shards[self._edge_shard.pop(key)].edges[key]
                count += 1
        if self.query_cache:
            for tenant in touched:
                self.query_cache.invalidate_results(tenant)
        return count

    def chat(self, user_message: str) -> str:
        if not self.conversation_active:
            self._log(self.start_conversation())

        start_time = time.time()
        self.add_to_short_term(user_message, "episodic", salience=0.7)
        self.conversation_history.append({"role": "user", "content": user_message})

        query_emb = self._get_embedding(user_message)
        retrieved_ids, boost_mode = self._retrieve_for_chat(query_emb, user_message)
        self._boost_neighbors(retrieved_ids, mode=boost_mode)

        retrieval_time = (time.time() - start_time) * 1000
        self.telemetry.record("chat.retrieval_ms", retrieval_time,
                              labels={"tenant": self.user_id})

        messages = self._assemble_messages(retrieved_ids, mode=boost_mode)
        response = self._call_llm(messages)
        self.add_to_short_term(response, "semantic", salience=0.5)
        self.conversation_history.append({"role": "assistant", "content": response})

        self._log(f"[{Telemetry.tier(retrieval_time)} Retrieval: "
                  f"{retrieval_time:.0f}ms, Retrieved: {len(retrieved_ids)} nodes]")
        return response

    def chat_stream(self, user_message: str) -> Iterator[Dict[str, str]]:
        """:meth:`chat` as a stream (``lazzaro_tpu/core/memory_system.py:
        chat_stream``): yields ``{"type": "info" | "token", "content":
        ...}``, the retrieval line first, then the provider's chunks
        (``completion_stream`` where it has one, else one token of the whole
        completion)."""
        if not self.conversation_active:
            self.start_conversation()
            yield {"type": "info", "content": "✓ Conversation started"}

        start_time = time.time()
        self.add_to_short_term(user_message, "episodic", salience=0.7)
        self.conversation_history.append({"role": "user", "content": user_message})

        query_emb = self._get_embedding(user_message)
        retrieved_ids, boost_mode = self._retrieve_for_chat(query_emb, user_message)
        self._boost_neighbors(retrieved_ids, mode=boost_mode)

        retrieval_time = (time.time() - start_time) * 1000
        self.telemetry.record("chat.retrieval_ms", retrieval_time,
                              labels={"tenant": self.user_id})
        yield {"type": "info",
               "content": f"[{Telemetry.tier(retrieval_time)} Retrieval: "
                          f"{retrieval_time:.0f}ms, Retrieved: "
                          f"{len(retrieved_ids)} nodes]"}

        messages = self._assemble_messages(retrieved_ids, mode=boost_mode)
        self.metrics["llm_calls"] += 1
        if hasattr(self.llm, "completion_stream"):
            chunks: List[str] = []
            for chunk in self.llm.completion_stream(messages):
                chunks.append(chunk)
                yield {"type": "token", "content": chunk}
            response = "".join(chunks)
        else:
            response = self.llm.completion(messages)
            yield {"type": "token", "content": response}

        self.add_to_short_term(response, "semantic", salience=0.5)
        self.conversation_history.append({"role": "assistant", "content": response})

    def _assemble_messages(self, retrieved_ids: List[str],
                           mode: str = "classic") -> List[Dict[str, str]]:
        """``mode`` "classic" pays the access boost here, "device" means the
        fused dispatch already applied it, "deferred" (query-cache hits)
        queues it for one batched flush."""
        context_parts = []
        profile_context = self.profile.get_context()
        if profile_context and profile_context != "No profile data yet.":
            context_parts.append(f"User Profile:\n{profile_context}\n")

        if retrieved_ids:
            memory_texts = []
            access_ids = []
            for nid in retrieved_ids:
                node = self.buffer.get_node(nid)
                if node:
                    memory_texts.append(f"- {node.content}")
                    access_ids.append(nid)
            if access_ids:
                with self._mutex:
                    if mode == "classic":
                        self.index.update_access(
                            [self._q(n) for n in access_ids],
                            boost=self.config.access_salience_boost)
                    elif mode == "deferred":
                        now = time.time()
                        for nid in access_ids:
                            self._queue_boost(nid, acc=1, now=now)
                    self._mark_dirty(*access_ids)
                for nid in access_ids:
                    self.buffer.update_access(nid, self.config.access_salience_boost)
            if memory_texts:
                context_parts.append(
                    "Relevant Information from Past Conversations (Use if relevant to the query):\n"
                    + "\n".join(memory_texts) + "\n")

        system_prompt = ("You are a helpful assistant with access to the user's profile "
                         "and past memories. Use the provided context ONLY if it is relevant "
                         "to the user's current query. Do not force the information if it "
                         "doesn't fit naturally.")
        messages = [{"role": "system", "content": system_prompt}]
        if context_parts:
            messages.append({"role": "system", "content": "\n".join(context_parts)})
        messages.extend(self.conversation_history[-self.config.history_window:])
        return messages

    # ----------------------------------------------------------- fused serving
    def _use_fused_serving(self) -> bool:
        """The dense exact fused path serves every configuration this
        package accepts, so ``serve_fused`` alone decides."""
        return self.config.serve_fused

    def _ensure_scheduler(self) -> QueryScheduler:
        """Start the cross-request query scheduler on first use: one worker
        thread per system, launching on the index's device."""
        sched = self.query_scheduler
        if sched is not None and not sched.closed:
            return sched
        with self._mutex:
            sched = self.query_scheduler
            if sched is None or sched.closed:
                cfg = self.config
                sched = QueryScheduler(
                    self._serve_requests,
                    max_batch=cfg.serve_batch_max,
                    max_wait_us=cfg.serve_flush_us,
                    telemetry=self.telemetry,
                    continuous=cfg.serve_continuous,
                    tenant_max_inflight=cfg.serve_tenant_max_inflight,
                    dispatch_timeout_s=cfg.serve_dispatch_timeout_s,
                    breaker_threshold=cfg.serve_breaker_threshold,
                    breaker_cooldown_s=cfg.serve_breaker_cooldown_s,
                    shed_depth=cfg.serve_shed_depth,
                    shed_bytes=cfg.serve_shed_bytes,
                    degrade_cap_take=cfg.serve_degrade_cap_take,
                    device=self.device)
                self.query_scheduler = sched
        return sched

    def _serve_requests(self, reqs: List[RetrievalRequest]):
        """Scheduler executor: one fused dispatch and one packed readback
        for the whole batch."""
        return self.index.search_fused_requests(
            reqs, cap_take=self.config.retrieval_cap,
            max_nbr=self.config.serve_max_nbr,
            super_gate=self.config.super_node_gate,
            acc_boost=self.config.access_salience_boost,
            nbr_boost=self.config.neighbor_salience_boost)

    def warmup_serving(self, geometries=(8, 64)):
        """Build the serving kernels and launch them once per query-batch
        geometry with this system's serving parameters, so the first live
        request pays no build."""
        return self.index.warmup_serving(
            geometries, cap_take=self.config.retrieval_cap,
            max_nbr=self.config.serve_max_nbr,
            super_gate=self.config.super_node_gate,
            acc_boost=self.config.access_salience_boost,
            nbr_boost=self.config.neighbor_salience_boost,
            k=self.config.serve_k_max)

    # ------------------------------------------------------------- retrieval
    def _retrieve_for_chat(self, query_emb: List[float],
                           query_text: str) -> Tuple[List[str], str]:
        """``(ids, boost_mode)``: a query-cache hit costs no search and
        defers its boosts ("deferred"); fused serving returns "device" when
        the kernel's dispatch applied both boosts, or "classic" when the
        super-node gate fired (the host serves the children and pays the
        classic boosts); otherwise the classic two-search retrieval."""
        if self.query_cache:
            cached = self.query_cache.get_results(query_text, tenant=self.user_id)
            if cached:
                return cached, "deferred"
        if not self._use_fused_serving():
            return self._optimized_retrieval(query_emb, query_text), "classic"
        req = RetrievalRequest(
            query=np.asarray(query_emb, np.float32),
            tenant=self.user_id, k=self.config.ann_limit,
            gate_enabled=bool(self.enable_hierarchy and self.super_nodes),
            boost=True)
        res = self._ensure_scheduler().submit(req).result()
        # The host half: the same children expansion and merge as the
        # classic path, fed from the kernel's (gate, ANN) result.
        retrieved = (self._children_of(res.gate_id)
                     if res.fast and res.gate_id is not None else [])
        if len(retrieved) >= self.config.retrieval_cap:
            final = self._cache_retrieval(query_text, retrieved)
        else:
            final = self._merge_retrieval(query_text, retrieved, res.ids)
        return final, ("device" if res.boosted else "classic")

    def _children_of(self, super_qid: str) -> List[str]:
        """Hierarchy fast path: the first ``hierarchy_children`` live
        children of the super node the gate picked."""
        best = self.super_nodes.get(super_qid.partition(":")[2])
        if best is None:
            return []
        return [cid for cid in best.child_ids[:self.config.hierarchy_children]
                if (child := self.buffer.get_node(cid))
                and not child.is_super_node]

    def _cache_retrieval(self, query_text: str, ids: List[str]) -> List[str]:
        final = ids[:self.config.retrieval_cap]
        if self.query_cache:
            self.query_cache.set_results(query_text, final, tenant=self.user_id)
        return final

    def _merge_retrieval(self, query_text: str, retrieved: List[str],
                         vec_qids: List[str]) -> List[str]:
        """Children first, then the ANN ids, dropping repeated ids and
        repeated contents, capped at ``retrieval_cap``."""
        seen_ids: Set[str] = set(retrieved)
        seen_content: Set[str] = set()
        final: List[str] = []
        for rid in retrieved:
            node = self.buffer.get_node(rid)
            if node:
                seen_content.add(node.content)
                final.append(rid)
        for rid in (v.partition(":")[2] for v in vec_qids):
            if rid in seen_ids:
                continue
            node = self.buffer.get_node(rid)
            if node and node.content not in seen_content:
                seen_content.add(node.content)
                final.append(rid)
                seen_ids.add(rid)
        return self._cache_retrieval(query_text, final)

    def _optimized_retrieval(self, query_emb: List[float], query_text: str) -> List[str]:
        if self.query_cache:
            cached = self.query_cache.get_results(query_text, tenant=self.user_id)
            if cached:
                return cached

        q = np.asarray(query_emb, np.float32)
        retrieved: List[str] = []

        # 1. Hierarchy fast path: one masked top-1 over super-node rows.
        if self.enable_hierarchy and self.super_nodes:
            sids, sscores = self.index.search(q, self.user_id, k=1,
                                              super_filter=1, exact=True)
            if sids and sscores[0] > self.config.super_node_gate:
                retrieved = self._children_of(sids[0])
                if len(retrieved) >= self.config.retrieval_cap:
                    return self._cache_retrieval(query_text, retrieved)

        # 2. Arena ANN over the non-super rows.
        limit = self.config.ann_limit if not retrieved else self.config.retrieval_cap
        vec_ids, _ = self.index.search(q, self.user_id, k=limit, super_filter=-1)
        return self._merge_retrieval(query_text, retrieved, vec_ids)

    def _boost_neighbors(self, retrieved_ids: List[str],
                         mode: str = "classic") -> None:
        """Associative neighbor boost, paid now ("classic"), queued
        ("deferred"), or already applied by the fused dispatch's CSR gather
        ("device"); host copies update in every mode."""
        neighbors: Set[str] = set()
        for nid in retrieved_ids:
            neighbors.update(self.buffer.get_neighbors(nid))
        to_boost = [n for n in neighbors if n not in set(retrieved_ids)]
        if not to_boost:
            return
        now = time.time()
        with self._mutex:
            if mode == "classic":
                self.index.boost([self._q(n) for n in to_boost],
                                 self.config.neighbor_salience_boost, now)
            elif mode == "deferred":
                for n in to_boost:
                    self._queue_boost(n, nbr=1, now=now)
            self._mark_dirty(*to_boost)
        for nid in to_boost:
            node = self.buffer.get_node(nid)
            if node:
                node.last_accessed = now
                node.salience = min(1.0, node.salience + self.config.neighbor_salience_boost)

    def _queue_boost(self, node_id: str, acc: int = 0, nbr: int = 0,
                     now: Optional[float] = None) -> None:
        """Accumulate a deferred boost (callers hold ``self._mutex``)."""
        ent = self._pending_boosts.get(node_id)
        if ent is None:
            ent = self._pending_boosts[node_id] = [0, 0, 0.0]
        ent[0] += acc
        ent[1] += nbr
        ent[2] = max(ent[2], now if now is not None else time.time())
        if len(self._pending_boosts) >= self.config.serve_boost_flush_max:
            self._flush_pending_boosts_locked()

    def _flush_pending_boosts(self) -> None:
        with self._mutex:
            self._flush_pending_boosts_locked()

    def _flush_pending_boosts_locked(self) -> None:
        """Apply every queued boost in one scatter, before anything reads
        arena salience (decay, eviction, consolidation, host sync)."""
        if not self._pending_boosts:
            return
        entries = {self._q(nid): (acc, nbr, ts)
                   for nid, (acc, nbr, ts) in self._pending_boosts.items()}
        self._pending_boosts.clear()
        self.index.apply_boosts(entries, self.config.access_salience_boost,
                                self.config.neighbor_salience_boost)

    # ---------------------------------------------------------- consolidation
    _EXTRACTION_PROMPT = """Extract distinct, atomic facts from this conversation.
Categorization Guidelines:
1. semantic: Stable facts, preferences, or knowledge (e.g., "User likes Python", "User lives in London").
2. episodic: Specific events, occurrences, or recent activities (e.g., "User started a new job today", "User fixed a bug in the API").
3. procedural: Processes, workflows, or instructions (e.g., "User follows the git-flow model", "User prefers TDD for testing").

Format Rules:
- Formulate facts in the THIRD PERSON.
- Abstract from conversational filler.
- If no new facts, return empty list.

Return JSON: {"memories": [{"content": "...", "type": "semantic|episodic|procedural", "salience": 0.0-1.0, "topic": "work|personal|learning|health|other"}]}
"""

    def _async_consolidate(self) -> None:
        """The consolidation worker must survive: any failure puts the
        in-flight turns back on the queue and counts
        ``reliability.ingest_failures``."""
        try:
            self._consolidate_once()
        except Exception as e:      # noqa: BLE001 — worker must survive
            _logger.exception("consolidation failed")
            self._log(f"⚠ Consolidation worker error: {e!r} "
                      f"(turns requeued for retry)")
            self.telemetry.bump("reliability.ingest_failures")
            self._requeue_inflight()

    def _consolidate_once(self) -> None:
        with self._mutex:
            if not self.consolidation_queue:
                return
            all_memories: List[Dict] = []
            for batch in self.consolidation_queue:
                all_memories.extend(batch["memories"])
            self._inflight_batches.extend(self.consolidation_queue)
            self.consolidation_queue.clear()

        start_time = time.time()
        self._log(f"🔄 Processing {len(all_memories)} memories in background...")
        response = self._call_llm(
            [{"role": "system", "content": self._EXTRACTION_PROMPT},
             {"role": "user", "content": json.dumps(all_memories)}],
            response_format={"type": "json_object"})
        try:
            data = json.loads(_extract_json_object(response))
            if isinstance(data, dict):
                memories = data.get("memories", [])
            elif isinstance(data, list):
                memories = data
            else:
                self._log(f"⚠ Unexpected data type: {type(data)}")
                self._requeue_inflight()
                return
        except json.JSONDecodeError as e:
            self._log(f"⚠ Parse error: {e}")
            self._requeue_inflight()
            return

        memories = [m for m in memories if isinstance(m, dict)]
        self._log(f"✓ Extracted {len(memories)} memory candidates")
        # The facts are durable the moment extraction returns, before the
        # coalescer buffers them. A failed append is logged and the ingest
        # goes on, as in the JAX package: the turn journal still holds the
        # source turns until the facts land.
        if self._ingest_journal is not None and memories:
            try:
                self._ingest_journal.append(memories)
            except OSError as e:
                self._log(f"⚠ Ingest journal append failed: {e}")
        # Fault point: a raise here is the worker dying between the
        # extraction and the ingest.
        faults.fire("ingest.worker", facts=len(memories))
        self._ingest_coalescer.add_conversation(memories)
        if not self._ingest_coalescer.should_flush():
            # The source turns stay journaled until the facts land.
            with self._mutex:
                self._deferred_batches.extend(self._inflight_batches)
                self._inflight_batches.clear()
                self._journal_sync()
            self._log(f"⏳ Ingest deferred: {len(self._ingest_coalescer)} "
                      "facts buffered by the flush policy")
            return
        coalesce_wait_ms = self._ingest_coalescer.oldest_age_s() * 1e3
        # Every fact the drain pops is covered by the journal's sequences up
        # to here; read before the drain, so a concurrent append is never
        # committed by this pass.
        commit_to = (self._ingest_journal.last_seq
                     if self._ingest_journal is not None else 0)
        mega_batches = self._ingest_coalescer.drain()
        new_nodes: List[Tuple[str, str]] = []
        done = 0
        try:
            for facts, _n_convs in mega_batches:
                self.telemetry.record("ingest.coalesce_wait_ms", coalesce_wait_ms)
                new_nodes.extend(self._ingest_facts(facts))
                done += 1
        except Exception as e:      # noqa: BLE001 — ingest must not strand
            # The un-ingested mega-batches go back to the front of the
            # coalescer, their turns stay journaled, and the ingest journal
            # keeps every fact uncommitted.
            _logger.exception("ingest failed")
            self._ingest_coalescer.requeue(mega_batches[done:])
            self.telemetry.bump("reliability.ingest_failures")
            with self._mutex:
                self._deferred_batches.extend(self._inflight_batches)
                self._inflight_batches.clear()
                self._journal_sync()
            self._log(f"⚠ Ingest failed after {done}/{len(mega_batches)} "
                      f"mega-batches ({e!r}); facts requeued, journal "
                      f"retains them")
            return
        self._finish_consolidation(new_nodes, start_time)
        if self._ingest_journal is not None:
            # Every drained fact is in the arena and the store now.
            self._ingest_journal.commit(commit_to)

    def _ingest_facts(self, memories: List[Dict]) -> List[Tuple[str, str]]:
        """Stage, dedup and ingest one mega-batch of extracted facts; returns
        the (node_id, shard_key) pairs created."""
        contents = [m.get("content", "") for m in memories if m.get("content")]
        embeddings = self._batch_embed(contents)
        try:
            emb_rows = np.asarray(embeddings, np.float32)
            if emb_rows.ndim != 2:
                raise ValueError
        except (ValueError, TypeError):        # ragged/failed rows: per-item
            emb_rows = None

        with self._mutex:
            # Stage valid facts, then resolve near-duplicates with one arena
            # top-1 search for the whole batch (pre-batch graph) and one gram
            # matrix on the device for duplicates within the batch.
            staged: List[Tuple[Dict, str, np.ndarray]] = []
            ei = 0
            empty = np.empty((0,), np.float32)
            for mem in memories:
                content = mem.get("content", "")
                if not content:
                    continue
                if ei < len(embeddings):
                    new_emb = (emb_rows[ei] if emb_rows is not None
                               else np.asarray(embeddings[ei], np.float32))
                else:
                    new_emb = empty
                ei += 1
                if len(content) < 5:
                    continue
                staged.append((mem, content, new_emb))

            if (self.config.ingest_fused and self.config.ingest_dedup_fused
                    and staged
                    and all(e.size == self.embed_dim for _, _, e in staged)):
                # The dedup probe rides inside the one fused dispatch.
                return self._ingest_facts_dedup_fused(staged)

            probe: List[Tuple[Optional[str], float]] = [(None, 0.0)] * len(staged)
            probeable = [i for i, (_, _, e) in enumerate(staged)
                         if e.size == self.embed_dim]
            if probeable:
                qs = np.stack([staged[i][2] for i in probeable])
                res = self.index.search_batch(qs, self.user_id, k=1,
                                              super_filter=-1, exact=True)
                for i, (ids, scores) in zip(probeable, res):
                    if ids:
                        probe[i] = (ids[0].partition(":")[2], scores[0])
            intra_best_col = intra_best_sim = None
            if len(probeable) >= 2:
                intra_best_col, intra_best_sim = self.index.best_earlier_match(
                    np.stack([staged[i][2] for i in probeable]))
            pos_in_probeable = {i: j for j, i in enumerate(probeable)}

            new_nodes: List[Tuple[str, str]] = []
            irregular: List[Dict[str, Any]] = []
            created: List[Node] = []
            created_embs: List[np.ndarray] = []
            merge_ids: List[str] = []
            merge_sals: List[float] = []
            fact_target: List[Optional[str]] = []
            for fi, (mem, content, new_emb) in enumerate(staged):
                shard_key = mem.get("topic") or self._infer_shard_key(content)
                if shard_key == "other":
                    shard_key = self._infer_shard_key(content)
                shard = self._get_or_create_shard(shard_key)

                target_id, best = probe[fi]
                if intra_best_sim is not None and fi in pos_in_probeable:
                    row = pos_in_probeable[fi]
                    sim = float(intra_best_sim[row])
                    if sim > best:
                        t = fact_target[probeable[int(intra_best_col[row])]]
                        if t is not None:
                            target_id, best = t, sim
                existing_node = (self.buffer.get_node(target_id)
                                 if target_id is not None
                                 and best > self.config.dedup_similarity
                                 else None)

                if existing_node is not None:
                    cand_sal = float(mem.get("salience", 0.5))
                    existing_node.salience = max(existing_node.salience, cand_sal)
                    existing_node.last_accessed = time.time()
                    existing_node.access_count += 1
                    merge_ids.append(existing_node.id)
                    merge_sals.append(cand_sal)
                    self._mark_dirty(existing_node.id)
                    fact_target.append(existing_node.id)
                    self._log(f"   (Merged semantic duplicate into {existing_node.id})")
                    continue

                node_id = self._generate_node_id()
                node = Node(
                    id=node_id,
                    content=content,
                    embedding=None,          # the arena owns the vector
                    type=mem.get("type", "semantic"),
                    salience=float(mem.get("salience", 0.5)),
                    shard_key=shard_key,
                )
                shard.add_node(node)
                created.append(node)
                created_embs.append(new_emb)
                fact_target.append(node_id)
                new_nodes.append((node_id, shard_key))
                if new_emb.size != self.embed_dim:
                    # A row without a vector of the arena's width is stored
                    # without one (NULL) and never reaches the arena.
                    irregular.append({
                        "id": node_id, "content": content, "type": node.type,
                        "salience": node.salience,
                        "shard_key": node.shard_key,
                        "timestamp": node.timestamp,
                        "decay_pass": self._decay_pass})

            arena_new = [(n, e) for n, e in zip(created, created_embs)
                         if e.size == self.embed_dim]
            chain_edges = self._chain_edges(new_nodes)
            if self.config.ingest_fused and arena_new:
                # Node scatter, merge touch, both link scans and the gated
                # edge insert in one dispatch; the host registers the edges.
                arena_ids = {n.id for n, _ in arena_new}
                _rows, _cands, created_links = self.index.ingest_batch(
                    ids=[self._q(n.id) for n, _ in arena_new],
                    embeddings=np.stack([e for _, e in arena_new]),
                    saliences=[n.salience for n, _ in arena_new],
                    timestamps=[n.timestamp for n, _ in arena_new],
                    types=[n.type for n, _ in arena_new],
                    shard_keys=[n.shard_key or "default" for n, _ in arena_new],
                    tenant=self.user_id,
                    is_super=[n.is_super_node for n, _ in arena_new],
                    merge_ids=[self._q(i) for i in merge_ids],
                    merge_saliences=merge_sals,
                    chain_pairs=[(self._q(e.source), self._q(e.target))
                                 for e in chain_edges if e.source in arena_ids
                                 and e.target in arena_ids],
                    chain_weight=self.config.chain_link_weight,
                    link_k=self.config.cross_link_top_k,
                    link_gate=self.config.link_gate,
                    link_scale=self.config.link_weight_scale,
                    shard_modes=(1, 0),
                    link_accept_hint=self.config.link_accept_hint)
                self._persist_new_nodes(arena_new, irregular)
                self._register_created(chain_edges, created_links)
                return new_nodes
            if arena_new:
                self.index.add(
                    [self._q(n.id) for n, _ in arena_new],
                    np.stack([e for _, e in arena_new]),
                    [n.salience for n, _ in arena_new],
                    [n.timestamp for n, _ in arena_new],
                    [n.type for n, _ in arena_new],
                    [n.shard_key or "default" for n, _ in arena_new],
                    self.user_id,
                    [n.is_super_node for n, _ in arena_new])
            if merge_ids:
                self.index.merge_touch([self._q(i) for i in merge_ids], merge_sals)
            self._persist_new_nodes(arena_new, irregular)

            # Both link scans (same-shard + any-shard) in one pass.
            link_cands = self.index.link_candidates_multi(
                [self._q(n) for n, _ in new_nodes], self.user_id,
                k=self.config.cross_link_top_k,
                shard_modes=(1, 0)) if new_nodes else {1: {}, 0: {}}
            self._link_within_shards(new_nodes, link_cands[1], chain=chain_edges)
            self._link_to_existing_memories(new_nodes, link_cands[0])
        return new_nodes

    def _persist_new_nodes(self, regular: List[Tuple[Node, np.ndarray]],
                           irregular: List[Dict[str, Any]] = ()) -> None:
        """Write an ingest's new nodes to the store: ``regular`` (node, its
        vector at the arena's width) in one columnar segment where the store
        has the columnar writer, else as row dicts; ``irregular`` rows as
        dicts without a vector."""
        rows = list(irregular)
        if regular:
            if hasattr(self.store, "add_nodes_columns"):
                self.store.add_nodes_columns(
                    ids=[n.id for n, _ in regular],
                    contents=[n.content for n, _ in regular],
                    embeddings=np.stack([e for _, e in regular]),
                    types=[n.type for n, _ in regular],
                    saliences=[n.salience for n, _ in regular],
                    timestamps=[n.timestamp for n, _ in regular],
                    shard_keys=[n.shard_key or "" for n, _ in regular],
                    decay_pass=self._decay_pass, user_id=self.user_id)
            else:
                rows.extend({
                    "id": n.id, "content": n.content,
                    "embedding": np.asarray(e, np.float32).tolist(),
                    "type": n.type, "salience": n.salience,
                    "shard_key": n.shard_key, "timestamp": n.timestamp,
                    "decay_pass": self._decay_pass} for n, e in regular)
        if rows:
            self.store.add_nodes(rows, user_id=self.user_id)

    def _register_created(self, chain_edges: List[Edge], created: Dict) -> None:
        """Host bookkeeping of the edges a fused dispatch already inserted
        on the device (shard placement, ``Edge`` objects): the chain edges,
        then the same-shard and any-shard links."""
        sim_edges = [Edge(source=s.partition(":")[2],
                          target=t.partition(":")[2], weight=w)
                     for sm in (1, 0) for s, t, w in created.get(sm, [])]
        self._register_edges_host(chain_edges + sim_edges)
        n_cross = len(created.get(0, []))
        if n_cross:
            self._log(f"✓ Created {n_cross} cross-conversation links")

    def _ingest_facts_dedup_fused(
            self, staged: List[Tuple[Dict, str, np.ndarray]]
    ) -> List[Tuple[str, str]]:
        """Device-dedup mega-batch ingest (caller holds ``self._mutex``;
        ``lazzaro_tpu/core/memory_system.py:_ingest_facts_dedup_fused_one``,
        no planner split): the dedup probe, node scatter, merge touch, chain
        edges, link scan and gated edge insert run as ONE dispatch
        (``MemoryIndex.ingest_batch_dedup``) with ONE packed readback; the
        host then names the surviving facts (the id counter advances as on
        the classic path), mirrors the merges and registers the edges."""
        cfg = self.config
        now = time.time()
        shard_keys: List[str] = []
        for mem, content, _ in staged:
            sk = mem.get("topic") or self._infer_shard_key(content)
            if sk == "other":
                sk = self._infer_shard_key(content)
            shard_keys.append(sk)
        saliences = [float(m.get("salience", 0.5)) for m, _, _ in staged]
        types = [m.get("type", "semantic") for m, _, _ in staged]
        pending = self.index.ingest_batch_dedup(
            np.stack([e for _, _, e in staged]).astype(np.float32), saliences,
            [now] * len(staged), types, shard_keys, tenant=self.user_id,
            dedup_gate=cfg.dedup_similarity, chain_weight=cfg.chain_link_weight,
            link_k=cfg.cross_link_top_k, link_gate=cfg.link_gate,
            link_scale=cfg.link_weight_scale, shard_modes=(1, 0), now=now,
            link_accept_hint=cfg.link_accept_hint)
        if pending is None:
            return []
        dup = pending["dup"]
        ids = [None if dup[i] else self._q(self._generate_node_id())
               for i in range(len(staged))]
        _cands, created, merges, chains = self.index.commit_ingest_dedup(
            pending, ids)
        new_nodes: List[Tuple[str, str]] = []
        survivors: List[Tuple[Node, np.ndarray]] = []
        for i, (_, content, e) in enumerate(staged):
            if dup[i]:
                continue
            node = Node(id=ids[i].partition(":")[2], content=content,
                        embedding=None,          # the arena owns the vector
                        type=types[i], salience=saliences[i], timestamp=now,
                        shard_key=shard_keys[i])
            self._get_or_create_shard(shard_keys[i]).add_node(node)
            survivors.append((node, e))
            new_nodes.append((node.id, shard_keys[i]))
        # The device's merge touch, mirrored on the host copy.
        for i, target_qid in merges:
            tgt = (self.buffer.get_node(target_qid.partition(":")[2])
                   if target_qid else None)
            if tgt is None:
                continue
            tgt.salience = max(tgt.salience, saliences[i])
            tgt.last_accessed = now
            tgt.access_count += 1
            self._mark_dirty(tgt.id)
            self._log(f"   (Merged semantic duplicate into {tgt.id})")
        self._persist_new_nodes(survivors)
        chain_edges = [Edge(source=a.partition(":")[2],
                            target=b.partition(":")[2],
                            weight=cfg.chain_link_weight) for a, b in chains]
        self._register_created(chain_edges, created)
        return new_nodes

    def _finish_consolidation(self, new_nodes: List[Tuple[str, str]],
                              start_time: float) -> None:
        self._enforce_buffer_limit()
        if self.enable_hierarchy:
            with self._mutex:
                for shard_key in {sk for _, sk in new_nodes}:
                    shard = self.shards.get(shard_key)
                    if shard and len(shard.nodes) > self.super_node_threshold:
                        self._create_super_nodes_for_shard(shard_key)
        if self.query_cache:
            self.query_cache.invalidate_results(self.user_id)
        elapsed = time.time() - start_time
        self.telemetry.record("consolidation.run_ms", elapsed * 1e3)
        self._log(f"✓ Background consolidation complete ({elapsed:.2f}s)")
        self._save_to_persistence()
        with self._mutex:
            # The consolidated batches are durable: the turn journal shrinks
            # to what is still pending. A drain ingests every deferred fact,
            # so the deferred batches retire with it.
            self._inflight_batches.clear()
            self._deferred_batches.clear()
            self._journal_sync()

    def _requeue_inflight(self) -> None:
        """A consolidation attempt failed: its batches go back on the queue
        so the next consolidation retries them."""
        with self._mutex:
            self.consolidation_queue = self._inflight_batches + self.consolidation_queue
            self._inflight_batches = []

    def _register_edges_host(self, edges: List[Edge]) -> None:
        """Host half of edge insertion: shard placement and Edge objects."""
        for edge in edges:
            key = (edge.source, edge.target)
            sk = self._edge_shard.get(key)
            shard = self.shards.get(sk) if sk is not None else None
            if shard is None or key not in shard.edges:
                shard = self._shard_of_node(edge.source)
                if shard is None:
                    shard = self._get_or_create_shard("default")
            shard.add_edge(edge, reinforce=self.config.edge_reinforce)
            self._edge_shard[key] = shard.shard_key
            self._mark_edge_dirty(key)
        self.metrics["edges_linked"] += len(edges)

    def _add_edge(self, edge: Edge) -> None:
        """Insert into both the host shard record and the edge arena."""
        self._add_edges_batch([edge])

    def _add_edges_batch(self, edges: List[Edge]) -> None:
        """Host bookkeeping per edge + one device scatter for the batch."""
        if not edges:
            return
        self._register_edges_host(edges)
        self.index.add_edges(
            [(self._q(e.source), self._q(e.target), e.weight) for e in edges],
            self.user_id, reinforce=self.config.edge_reinforce)

    def _chain_edges(self, new_nodes: List[Tuple[str, str]]) -> List[Edge]:
        """Consecutive same-shard new nodes chain with the chain weight."""
        by_shard: Dict[str, List[str]] = {}
        for node_id, shard_key in new_nodes:
            by_shard.setdefault(shard_key, []).append(node_id)
        batch: List[Edge] = []
        for node_ids in by_shard.values():
            for a, b in zip(node_ids, node_ids[1:]):
                batch.append(Edge(source=a, target=b,
                                  weight=self.config.chain_link_weight))
        return batch

    def _link_within_shards(self, new_nodes: List[Tuple[str, str]],
                            cands: Dict, chain: List[Edge]) -> None:
        """Chain edges + top-k same-shard links over the link gate
        (weight = sim * link_weight_scale)."""
        batch: List[Edge] = list(chain)
        for qid, pairs in cands.items():
            nid = qid.partition(":")[2]
            for qcand, sim in pairs:
                if sim > self.config.link_gate:
                    batch.append(Edge(source=nid,
                                      target=qcand.partition(":")[2],
                                      weight=sim * self.config.link_weight_scale))
        self._add_edges_batch(batch)

    def _link_to_existing_memories(self, new_nodes: List[Tuple[str, str]],
                                   cands: Dict) -> None:
        """Top-k cross-links across all shards over the link gate, skipping
        pairs already linked in either direction."""
        if not new_nodes:
            return
        batch: List[Edge] = []
        staged: Set[Tuple[str, str]] = set()
        for qid, pairs in cands.items():
            nid = qid.partition(":")[2]
            for qcand, sim in pairs:
                if sim <= self.config.link_gate:
                    continue
                cand = qcand.partition(":")[2]
                exists = ((nid, cand) in staged or (cand, nid) in staged
                          or any((nid, cand) in s.edges or (cand, nid) in s.edges
                                 for s in self.shards.values()))
                if not exists:
                    batch.append(Edge(source=nid, target=cand,
                                      weight=sim * self.config.link_weight_scale))
                    staged.add((nid, cand))
        self._add_edges_batch(batch)
        if batch:
            self._log(f"✓ Created {len(batch)} cross-conversation links")

    def _create_super_nodes_for_shard(self, shard_key: str) -> None:
        shard = self.shards[shard_key]
        if len(shard.nodes) < self.super_node_threshold:
            return
        if any(n.shard_key == shard_key for n in self.super_nodes.values()):
            return
        nodes = list(shard.nodes.values())
        super_id = f"super_{shard_key}_{int(time.time())}"
        samples = [n.content for n in nodes[:3]]
        aggregated = f"Topic: {shard_key}. Contains memories about: " + "; ".join(samples)
        # Centroid on the device: normalized mean of the children.
        avg = self.index.mean_embedding([self._q(n.id) for n in nodes])
        super_node = Node(
            id=super_id,
            content=aggregated,
            embedding=avg.tolist(),
            type="semantic",
            is_super_node=True,
            child_ids=[n.id for n in nodes],
            shard_key=shard_key,
        )
        for node in nodes:
            node.parent_id = super_id
        self.super_nodes[super_id] = super_node
        self._index_add_node(super_node)
        self._mark_dirty(super_id, *(n.id for n in nodes))
        self._log(f"  ✓ Created super-node {super_id} with {len(nodes)} children")

    def _enforce_buffer_limit(self) -> None:
        with self._mutex:
            nodes, _ = self.buffer.size()
            if nodes <= self.max_buffer_size:
                return
            self._flush_pending_boosts_locked()
            excess = nodes - self.max_buffer_size
            removed_ids = []
            for qid, _imp in self.index.evict_candidates(self.user_id, excess)[:excess]:
                nid = qid.partition(":")[2]
                node = self.buffer.get_node(nid)
                if node is None or node.is_super_node:
                    continue
                shard = self.shards.get(node.shard_key)
                if shard and nid in shard.nodes:
                    del shard.nodes[nid]
                    self._node_shard_cache.pop(nid, None)
                    # cross-links live in the SOURCE node's shard: scan all
                    for s in self.shards.values():
                        for key in [k for k in s.edges if k[0] == nid or k[1] == nid]:
                            self._mark_edge_deleted(s.edges[key])
                            del s.edges[key]
                            self._edge_shard.pop(key, None)
                    removed_ids.append(nid)
                    self._dirty_nodes.discard(nid)
            if removed_ids:
                self.index.delete([self._q(n) for n in removed_ids])
                self.store.delete_nodes(removed_ids, user_id=self.user_id)
                if self.query_cache:
                    self.query_cache.invalidate_results(self.user_id)
                self._log(f"⚠ Buffer limit reached! Archived {len(removed_ids)} old nodes "
                          f"(limit: {self.max_buffer_size})")

    # ---------------------------------------------------------------- tenants
    def _drain_background(self) -> None:
        """Barrier on the single-worker executor, so a queued consolidation
        lands under the tenant that queued it."""
        if self.background_executor:
            self.background_executor.submit(lambda: None).result()

    def switch_user(self, new_user_id: str) -> None:
        """Save the current tenant, reload ``new_user_id`` from the store
        (its rows back on the device in one upload) and open its journals,
        replaying what a crash left in them."""
        if self.conversation_active:
            self.end_conversation()       # saves after the consolidation
            self._drain_background()
        else:
            self._drain_background()
            self._save_to_persistence()
        self.user_id = new_user_id
        self._load_from_persistence()
        self._setup_journal()
        self._setup_ingest_journal()
        self._log(f"👤 Switched context to user: {new_user_id}")

    def get_all_users(self) -> List[str]:
        if hasattr(self.store, "get_all_users"):
            users = self.store.get_all_users()
            return users if users else [self.user_id]
        return [self.user_id]

    # ----------------------------------------------------------------- search
    def search_memories(self, query: str, limit: int = 5) -> List[Node]:
        query_emb = self._get_embedding(query)
        if self._use_fused_serving():
            # Through the scheduler: a lone call ships at once, concurrent
            # callers share one dispatch.
            res = self._ensure_scheduler().submit(RetrievalRequest(
                query=np.asarray(query_emb, np.float32),
                tenant=self.user_id, k=limit)).result()
            ids = res.ids
        else:
            ids, _ = self.index.search(np.asarray(query_emb, np.float32),
                                       self.user_id, k=limit, super_filter=-1)
        results = []
        for qid in ids:
            node = self.buffer.get_node(qid.partition(":")[2])
            if node:
                results.append(node)
        return results

    def search_memories_batch(self, queries: List[str], limit: int = 5
                              ) -> List[List[Node]]:
        """``search_memories`` for many queries: one batched embed and one
        kernel launch. With fused serving the group rides the scheduler
        contiguously and shares batches with concurrent chat turns."""
        if not queries:
            return []
        embs = np.asarray(self._batch_embed(list(queries)), np.float32)
        if self._use_fused_serving():
            reqs = [RetrievalRequest(query=embs[i], tenant=self.user_id,
                                     k=limit) for i in range(len(queries))]
            futures = self._ensure_scheduler().submit_many(reqs)
            per_query = [(f.result().ids, f.result().scores) for f in futures]
        else:
            per_query = self.index.search_batch(embs, self.user_id, k=limit,
                                                super_filter=-1)
        results: List[List[Node]] = []
        for ids, _scores in per_query:
            nodes = []
            for qid in ids:
                node = self.buffer.get_node(qid.partition(":")[2])
                if node:
                    nodes.append(node)
            results.append(nodes)
        return results

    def get_connected_memories(self, node_id: str) -> List[Node]:
        """The nodes one edge away from ``node_id``, either direction."""
        connected: Set[str] = set()
        for shard in self.shards.values():
            for (src, tgt) in shard.edges:
                if src == node_id:
                    connected.add(tgt)
                elif tgt == node_id:
                    connected.add(src)
        return [n for n in (self.buffer.get_node(c) for c in connected) if n]

    # ------------------------------------------------------ deep consolidation
    def run_consolidation(self, weight_threshold: float = 0.6,
                          merge_similar: bool = True,
                          persist: bool = True) -> str:
        """Merge near-duplicate nodes, extract profile insights from the
        strong components of the graph (or from every node when none
        qualifies), prune weak edges (``lazzaro_tpu/core/memory_system.py:
        run_consolidation``). Each stage's host wall time goes to the
        ``consolidation.stage_ms`` timer under its ``stage`` label (``pairs``,
        ``merge_loop``, ``components``, ``weights``, ``profile``, ``prune``),
        the pair and component counts to the ``consolidation.merge_pairs``
        and ``consolidation.components`` gauges."""
        results = []
        self._log("🔄 Running consolidation...")
        self._flush_pending_boosts()   # consolidation reads arena salience

        if merge_similar:
            merged = self._merge_similar_nodes(self.config.merge_similarity)
            if merged > 0:
                self._status(results, f"✓ Merged {merged} similar nodes")

        with self._stage("components"):
            components = self.buffer.get_connected_components()
        self.telemetry.gauge("consolidation.components", len(components))
        with self._stage("weights"):
            w_sum, w_cnt = self._component_weights(components)
        with self._stage("profile"):
            profile_updates = self._profile_from_components(components, w_sum,
                                                            w_cnt, results)

        with self._stage("prune"):
            pruned = self._prune_weak_edges(self.prune_threshold)
        if pruned > 0:
            self._status(results, f"✓ Pruned {pruned} weak edges")

        if profile_updates > 0:
            self._status(results, f"✓ Updated {profile_updates} profile domains")
        else:
            all_contents = [n.content for n in self.buffer.nodes.values()
                            if not n.is_super_node]
            if len(all_contents) >= self.config.component_min_size:
                with self._stage("profile"):
                    update = self._extract_profile_from_contents(all_contents)
                if "Updated" in update:
                    results.append(update)

        if not results:
            self._status(results, "✓ No consolidation actions needed")
        elif persist:
            # A standalone call saves the merges and the profile now; a
            # conversation end passes persist=False and saves right after.
            self._save_to_persistence()
        return "\n".join(results)

    def _stage(self, name: str):
        """A span of one consolidation stage (see :meth:`run_consolidation`)."""
        return self.telemetry.span("consolidation.stage_ms", {"stage": name})

    def _component_weights(self, components: List[Set[str]]
                           ) -> Tuple[List[float], List[int]]:
        """One pass over every edge: the summed weight and the count of the
        edges inside each component."""
        comp_of: Dict[str, int] = {}
        for ci, component in enumerate(components):
            for nid in component:
                comp_of[nid] = ci
        w_sum = [0.0] * len(components)
        w_cnt = [0] * len(components)
        for s in self.shards.values():
            for (src, tgt), e in s.edges.items():
                ci = comp_of.get(src)
                if ci is not None and comp_of.get(tgt) == ci:
                    w_sum[ci] += e.weight
                    w_cnt[ci] += 1
        return w_sum, w_cnt

    def _profile_from_components(self, components: List[Set[str]],
                                 w_sum: List[float], w_cnt: List[int],
                                 results: List[str]) -> int:
        """Profile extraction from every component of at least
        ``component_min_size`` nodes whose mean edge weight beats
        ``component_min_avg_weight``; returns the updates made."""
        updates = 0
        for ci, component in enumerate(components):
            if len(component) < self.config.component_min_size or not w_cnt[ci]:
                continue
            if w_sum[ci] / w_cnt[ci] > self.config.component_min_avg_weight:
                update = self._extract_profile_from_component(component)
                if "Updated" in update:
                    updates += 1
                    results.append(update)
        return updates

    def _extract_profile_from_component(self, component: Set[str]) -> str:
        contents = []
        for nid in component:
            node = self.buffer.get_node(nid)
            if node and not node.is_super_node:
                contents.append(node.content)
        if not contents:
            return "No content to extract"
        return self._extract_profile_from_contents(contents)

    _PROFILE_PROMPT = """Analyze these related memories and generate brief, factual personality insights (1-2 sentences each).
Identify all applicable domains: preferences, personality_traits, knowledge_domains, interaction_style, or key_experiences.
Return a JSON object where keys are the domain names and values are the specific insights.
Example: {"preferences": "User prefers Python for data science.", "knowledge_domains": "Exhibits deep expertise in memory systems."}"""

    def _extract_profile_from_contents(self, contents: List[str]) -> str:
        if not contents:
            return "No content to extract"
        prompt = "Related memories:\n" + "\n".join(f"- {c}" for c in contents[:10])
        response = self._call_llm(
            [{"role": "system", "content": self._PROFILE_PROMPT},
             {"role": "user", "content": prompt}],
            response_format={"type": "json_object"})
        try:
            data = json.loads(_extract_json_object(response))
            if not isinstance(data, dict):
                # a top-level array or scalar parses but has no domains
                return "Failed to extract profile"
            updated_any = False
            for domain, insight in data.items():
                if domain in self.profile.data and insight:
                    current = self.profile.data.get(domain, "")
                    if current and insight not in current:
                        updated = f"{current}. {insight}".strip()
                    else:
                        updated = insight
                    self.profile.update_domain(domain, updated)
                    self._log(f"  ✓ Profile updated: {domain} = {insight[:50]}...")
                    updated_any = True
            if updated_any:
                return "✓ Updated profile domains"
        except json.JSONDecodeError as e:
            self._log(f"  ⚠ JSON parse error: {e}")
        return "Failed to extract profile"

    def _merge_similar_nodes(self, similarity_threshold: float = 0.95) -> int:
        """All-pairs near-duplicate merge (``lazzaro_tpu/core/memory_system.py:
        _merge_similar_nodes``): the pairs come from one launch of the
        pairwise scan kernel (``MemoryIndex.merge_candidates``); each pair
        whose nodes are both still there folds the second into the first
        (contents joined, the larger salience, summed access counts), moves
        the second's edges in every shard onto the first and deletes it."""
        with self._mutex:
            if len(self.buffer.nodes) < 2:
                return 0
            with self._stage("pairs"):
                pairs = self.index.merge_candidates(self.user_id,
                                                    similarity_threshold)
            self.telemetry.gauge("consolidation.merge_pairs", len(pairs))
            with self._stage("merge_loop"):
                return self._merge_pairs(pairs)

    def _merge_pairs(self, pairs) -> int:
        """The host side of :meth:`_merge_similar_nodes` (under the mutex)."""
        merged_count = 0
        absorbed: Set[str] = set()
        for qkeep, qmerge, _sim in pairs:
            user, _, keep_id = qkeep.partition(":")
            if user != self.user_id:
                continue
            merge_id = qmerge.partition(":")[2]
            if keep_id in absorbed or merge_id in absorbed:
                continue
            node1 = self.buffer.get_node(keep_id)
            node2 = self.buffer.get_node(merge_id)
            if node1 is None or node2 is None or node1.is_super_node or node2.is_super_node:
                continue

            node1.content = f"{node1.content} | {node2.content}"
            node1.salience = max(node1.salience, node2.salience)
            node1.access_count += node2.access_count

            # Cross-links live in the source node's shard, not
            # necessarily the merged node's: rewire in every shard.
            for shard in self.shards.values():
                rewires = []
                for (src, tgt) in list(shard.edges.keys()):
                    if src == merge_id:
                        rewires.append(((src, tgt), (keep_id, tgt)))
                    elif tgt == merge_id:
                        rewires.append(((src, tgt), (src, keep_id)))
                for old_key, new_key in rewires:
                    edge = shard.edges.pop(old_key)
                    self._edge_shard.pop(old_key, None)
                    self._mark_edge_deleted(edge)
                    edge.source, edge.target = new_key
                    if new_key[0] != new_key[1]:
                        shard.edges[new_key] = edge
                        self._edge_shard[new_key] = shard.shard_key
                        self.index.add_edges(
                            [(self._q(new_key[0]), self._q(new_key[1]), edge.weight)],
                            self.user_id)
                        self._mark_edge_dirty(new_key)
                if merge_id in shard.nodes:
                    del shard.nodes[merge_id]
                    self._node_shard_cache.pop(merge_id, None)

            self.index.merge_touch([qkeep], [node1.salience])
            self.index.delete([qmerge])
            absorbed.add(merge_id)
            self._dirty_nodes.discard(merge_id)
            merged_count += 1
            # The merged content and the arena's merge touch reach the store
            # at the save after this consolidation.
            self._mark_dirty(keep_id)
        if absorbed:
            self.store.delete_nodes(sorted(absorbed), user_id=self.user_id)
        if merged_count and self.query_cache:
            self.query_cache.invalidate_results(self.user_id)
        return merged_count

    # ------------------------------------------------------------ persistence
    def _store_stage(self, name: str):
        """A span of one part of a save or a reload
        (``store.save_ms`` / ``store.load_ms`` under ``part``)."""
        kind, _, part = name.partition(".")
        return self.telemetry.span(f"store.{kind}_ms", {"part": part})

    def _bulk_fill_embeddings(self, dicts: List[Dict[str, Any]],
                              node_ids: List[str]) -> None:
        """Fill the missing ``embedding`` entries from the arena in one
        gather."""
        valid = []
        for i, (d, nid) in enumerate(zip(dicts, node_ids)):
            if not d.get("embedding"):
                r = self.index.id_to_row.get(self._q(nid))
                if r is not None:
                    valid.append((i, r))
        if not valid:
            return
        gathered = self.index.embeddings_of_rows([r for _, r in valid])
        for (i, _), e in zip(valid, gathered):
            dicts[i]["embedding"] = [float(x) for x in e]

    def _save_to_persistence(self) -> None:
        """Persist the tenant's durable rows. With a segmented store, once
        synced: upsert only the rows dirtied since the last save, write the
        edge tombstones and the decay-pass counter. Otherwise (an injected
        store of the bare protocol, or before the first sync): delete all
        and write everything."""
        with self._mutex:
            # Queued boosts land before the pull, or the boosted host
            # copies would be overwritten with stale values.
            self._flush_pending_boosts_locked()
            if self._supports_incremental and self._store_synced:
                self._save_incremental()
            else:
                self._save_full()
            self._last_version = self.store.get_latest_version()

    def _save_incremental(self) -> None:
        with self._store_stage("save.sync"):
            self._sync_from_arena(node_ids=set(self._dirty_nodes),
                                  edge_keys=set(self._dirty_edges))
        with self._store_stage("save.write"):
            nodes = [n for n in (self.buffer.get_node(nid)
                                 for nid in sorted(self._dirty_nodes))
                     if n is not None]
            # A row without a host vector upserts NULL, and the store keeps
            # its stored f32 vector: no gather from the arena's dtype.
            rows = [self._node_row(n) for n in nodes]
            if rows:
                self.store.add_nodes(rows, user_id=self.user_id)
            # Tombstones go first: segments merge last-wins, so an edge
            # deleted and re-created within one interval ends upserted.
            if self._deleted_edge_ids:
                self.store.delete_edges(sorted(self._deleted_edge_ids),
                                        user_id=self.user_id)
            edge_rows = [self._edge_row(e) for e in
                         (self._find_edge(k) for k in sorted(self._dirty_edges))
                         if e is not None]
            if edge_rows:
                self.store.add_edges(edge_rows, user_id=self.user_id)
            self.store.save_profile(self.profile.to_dict(), user_id=self.user_id)
            self.store.save_sys_meta({"decay_pass": self._decay_pass,
                                      "node_counter": self.node_counter},
                                     user_id=self.user_id)
        self._dirty_nodes.clear()
        self._dirty_edges.clear()
        self._deleted_edge_ids.clear()
        self._log(f"💾 Saved {len(rows)} nodes, {len(edge_rows)} edges (delta)")

    def _save_full(self) -> None:
        """Delete all and write everything. The stored rows are destroyed
        first, so every vector is materialized before: the store's own f32
        copy where it has one, else a gather from the arena."""
        self._sync_from_arena()
        all_nodes = list(self.buffer.nodes.values())
        nodes_data = [self._node_row(n) for n in all_nodes]
        self._preserve_stored_embeddings(nodes_data)
        self._bulk_fill_embeddings(nodes_data, [n.id for n in all_nodes])
        edges_data = [self._edge_row(edge)
                      for shard in self.shards.values()
                      for edge in shard.edges.values()]
        self.store.delete_nodes([], user_id=self.user_id)
        if nodes_data:
            self.store.add_nodes(nodes_data, user_id=self.user_id)
        self.store.delete_edges([], user_id=self.user_id)
        if edges_data:
            self.store.add_edges(edges_data, user_id=self.user_id)
        self.store.save_profile(self.profile.to_dict(), user_id=self.user_id)
        if self._supports_incremental:
            self.store.save_sys_meta({"decay_pass": self._decay_pass,
                                      "node_counter": self.node_counter},
                                     user_id=self.user_id)
            self._store_synced = True
        self._dirty_nodes.clear()
        self._dirty_edges.clear()
        self._deleted_edge_ids.clear()
        self._log(f"💾 Saved {len(nodes_data)} nodes, {len(edges_data)} edges")

    def _preserve_stored_embeddings(self, rows: List[Dict[str, Any]]) -> None:
        """Backfill empty ``embedding`` entries from the store's rows."""
        missing = {r["id"] for r in rows if not r.get("embedding")}
        if not missing or not hasattr(self.store, "get_nodes_columns"):
            return
        cols = self.store.get_nodes_columns(self.user_id)
        if cols is None:
            return
        ragged = cols.get("ragged_embeddings", {})
        byid: Dict[str, List[float]] = {}
        for i, rid in enumerate(cols["id"]):
            if rid not in missing:
                continue
            if cols["has_embedding"][i]:
                byid[rid] = cols["embedding"][i].tolist()
            elif i in ragged:
                byid[rid] = ragged[i].tolist()
        for r in rows:
            if not r.get("embedding") and r["id"] in byid:
                r["embedding"] = byid[r["id"]]

    def _edge_row(self, edge: Edge) -> Dict[str, Any]:
        return {
            "source_id": edge.source,
            "target_id": edge.target,
            "weight": edge.weight,
            "edge_type": edge.edge_type,
            "co_occurrence": edge.co_occurrence,
            "last_updated": edge.last_updated,
            "decay_pass": self._decay_pass,
        }

    def _node_row(self, node: Node) -> Dict[str, Any]:
        # embedding None: no new vector, the store keeps the stored one.
        emb = node.embedding
        return {
            "id": node.id,
            "content": node.content,
            "embedding": None if emb is None else [float(x) for x in emb],
            "type": node.type,
            "timestamp": node.timestamp,
            "access_count": node.access_count,
            "last_accessed": node.last_accessed,
            "salience": node.salience,
            "is_super_node": node.is_super_node,
            "child_ids": list(node.child_ids),
            "parent_id": node.parent_id,
            "shard_key": node.shard_key,
            # The decay sweep these numbers are current as of: a reload
            # replays the sweeps since.
            "decay_pass": self._decay_pass,
        }

    def _load_from_persistence(self) -> None:
        """Drop this tenant's rows from the arena, then rebuild its host
        graph and its rows from the store. The seconds of each part go to
        the ``store.load_ms`` timer under ``part``: ``read``, ``host_graph``,
        ``arena``, ``edges``."""
        with self._mutex:
            stale = list(self.index.tenant_nodes.get(self.user_id, set()))
            if stale:
                with self._store_stage("load.drop"):
                    self.index.delete(stale)
            self.shards.clear()
            self.super_nodes.clear()
            self._edge_shard.clear()
            self._node_shard_cache.clear()
            self._dirty_nodes.clear()
            self._dirty_edges.clear()
            self._deleted_edge_ids.clear()
            meta = (self.store.load_sys_meta(self.user_id)
                    if self._supports_incremental else {})
            self._decay_pass = int(meta.get("decay_pass", 0))

            if self._supports_incremental:
                self._load_columnar()
            else:
                self._load_rows()

            prof = self.store.load_profile(user_id=self.user_id)
            self.profile = Profile.from_dict(prof) if prof else Profile()

            self.node_counter = max(self.node_counter,
                                    int(meta.get("node_counter", 0)))
            self._last_version = self.store.get_latest_version()
            self._store_synced = True
            if self.query_cache:
                self.query_cache.invalidate_results()

    def _restore_counter(self, node_id: str) -> None:
        if node_id.startswith("node_"):
            try:
                self.node_counter = max(self.node_counter, int(node_id[5:]))
            except ValueError:
                pass

    @staticmethod
    def _replay_node_decay(stored: np.ndarray, missed: np.ndarray,
                           rate: float, floor: float) -> np.ndarray:
        """Replay the decay sweeps a stored row missed, bit-for-bit against
        the arena's decay (``state._arena_decay``): each pass is the f32
        difference, then the multiply-add in f64, rounded once to f32."""
        sal = np.asarray(stored, np.float32).copy()
        left = np.asarray(missed, np.int64).copy()
        fl32 = np.float32(floor)
        fl64, dec64 = np.float64(fl32), np.float64(np.float32(1.0)
                                                   - np.float32(rate))
        while True:
            m = left > 0
            if not m.any():
                break
            base = (sal[m] - fl32).astype(np.float64)
            sal[m] = (fl64 + base * dec64).astype(np.float32)
            left[m] -= 1
        return sal

    @staticmethod
    def _replay_edge_decay(stored: np.ndarray, missed: np.ndarray,
                           rate: float) -> np.ndarray:
        """Edge twin of :meth:`_replay_node_decay`: ``w *= (1 - rate)`` per
        missed pass, one f32 rounding per pass as ``state._edges_decay``."""
        w = np.asarray(stored, np.float32).copy()
        left = np.asarray(missed, np.int64).copy()
        dec32 = np.float32(1.0) - np.float32(rate)
        while True:
            m = left > 0
            if not m.any():
                break
            w[m] = w[m] * dec32
            left[m] -= 1
        return w

    def _load_columnar(self) -> None:
        """Columnar reload: the vectors go to the arena as one matrix in one
        upload, the host nodes carry none, and each row's salience and edge
        weight replay the decay sweeps missed since its stamp."""
        with self._store_stage("load.read"):
            cols = self.store.get_nodes_columns(self.user_id)
        if cols is None:
            return
        rate = self.config.decay_rate
        floor = self.config.salience_floor
        with self._store_stage("load.host_graph"):
            missed = np.maximum(self._decay_pass - cols["decay_pass"], 0)
            sal = self._replay_node_decay(cols["salience"], missed, rate, floor)
            ids = cols["id"]
            types = cols["type"]
            shard_keys = cols["shard_key"]
            ts = cols["timestamp"]
            la = cols["last_accessed"]
            ac = cols["access_count"]
            is_super = cols["is_super_node"]
            ragged = cols.get("ragged_embeddings", {})
            self._build_host_nodes(cols, sal, ragged)

        with self._store_stage("load.arena"):
            matrix = cols["embedding"]
            if matrix.shape[1] != self.embed_dim:
                # The store's modal width differs from the embedder's: only
                # the rows at the embedder's width are served from the arena.
                idx = np.asarray(sorted(i for i, v in ragged.items()
                                        if v.size == self.embed_dim), np.int64)
                emb_rows = (np.stack([ragged[int(i)] for i in idx]) if idx.size
                            else np.zeros((0, self.embed_dim), np.float32))
            else:
                idx = np.nonzero(cols["has_embedding"])[0]
                emb_rows = matrix[idx]
            if idx.size:
                qids = [self._q(ids[i]) for i in idx]
                self.index.add(
                    qids, emb_rows, sal[idx], ts[idx],
                    [types[i] or "semantic" for i in idx],
                    [shard_keys[i] or "default" for i in idx],
                    self.user_id, is_super[idx])
                self.index.restore_access(qids, ac[idx], la[idx])

        with self._store_stage("load.read"):
            ecols = self.store.get_edges_columns(self.user_id)
        if ecols is None:
            return
        with self._store_stage("load.edges"):
            missed_e = np.maximum(self._decay_pass - ecols["decay_pass"], 0)
            weights = self._replay_edge_decay(ecols["weight"], missed_e, rate)
            node_shard = {ids[i]: shard_keys[i] or "default"
                          for i in range(len(ids)) if not is_super[i]}
            srcs = ecols["source_id"]
            tgts = ecols["target_id"]
            ets = ecols["edge_type"]
            cos = ecols["co_occurrence"].tolist()
            lus = ecols["last_updated"].tolist()
            wl = weights.tolist()
            triples = []
            for i in range(len(srcs)):
                edge = Edge(source=srcs[i], target=tgts[i], weight=wl[i],
                            edge_type=ets[i] or "relates_to",
                            co_occurrence=int(cos[i]), last_updated=lus[i])
                key = (edge.source, edge.target)
                owner = self.shards.get(node_shard.get(edge.source, "default"))
                if owner is None:
                    owner = self._get_or_create_shard("default")
                owner.edges[key] = edge
                self._edge_shard[key] = owner.shard_key
                triples.append((self._q(edge.source), self._q(edge.target),
                                edge.weight))
            if triples:
                self.index.add_edges(triples, self.user_id)

    def _build_host_nodes(self, cols: Dict[str, Any], sal: np.ndarray,
                          ragged: Dict[int, np.ndarray]) -> None:
        """The host nodes of a columnar reload, without vectors (the arena
        holds them) except for rows stored at another width, whose host copy
        keeps the vector a later upsert must not lose."""
        ids, contents, types = cols["id"], cols["content"], cols["type"]
        shard_keys, parents = cols["shard_key"], cols["parent_id"]
        child_json = cols["child_ids"]
        ts = cols["timestamp"].tolist()
        la = cols["last_accessed"].tolist()
        ac = cols["access_count"].tolist()
        is_super = cols["is_super_node"].tolist()
        sal = sal.astype(np.float64).tolist()
        for i in range(len(ids)):
            node = Node(
                id=ids[i],
                content=contents[i] or "",
                embedding=(ragged[i].tolist() if i in ragged else None),
                type=types[i] or "semantic",
                timestamp=ts[i],
                access_count=int(ac[i]),
                last_accessed=la[i],
                salience=sal[i],
                is_super_node=bool(is_super[i]),
                child_ids=(json.loads(child_json[i])
                           if child_json[i] and child_json[i] != "[]" else []),
                parent_id=parents[i] or None,
                shard_key=shard_keys[i] or "default",
            )
            if node.is_super_node:
                self.super_nodes[node.id] = node
            else:
                self._get_or_create_shard(node.shard_key).add_node(node)
            self._restore_counter(node.id)

    def _load_rows(self) -> None:
        """Row-dict reload for a store of the bare protocol."""
        rows = self.store.get_nodes(user_id=self.user_id)
        batch: List[Node] = []
        for r in rows:
            node = Node(
                id=r["id"],
                content=r.get("content", ""),
                embedding=r.get("embedding") or None,
                type=r.get("type", "semantic"),
                timestamp=r.get("timestamp", time.time()),
                access_count=int(r.get("access_count", 0)),
                last_accessed=r.get("last_accessed", time.time()),
                salience=float(r.get("salience", 0.5)),
                is_super_node=bool(r.get("is_super_node", False)),
                child_ids=list(r.get("child_ids") or []),
                parent_id=r.get("parent_id"),
                shard_key=r.get("shard_key") or "default",
            )
            if node.is_super_node:
                self.super_nodes[node.id] = node
            else:
                self._get_or_create_shard(node.shard_key).add_node(node)
            if node.embedding is not None and len(node.embedding) == self.embed_dim:
                batch.append(node)
            self._restore_counter(node.id)

        if batch:
            qids = [self._q(n.id) for n in batch]
            self.index.add(
                qids,
                np.asarray([n.embedding for n in batch], np.float32),
                [n.salience for n in batch],
                [n.timestamp for n in batch],
                [n.type for n in batch],
                [n.shard_key or "default" for n in batch],
                self.user_id,
                [n.is_super_node for n in batch])
            self.index.restore_access(qids,
                                      [n.access_count for n in batch],
                                      [n.last_accessed for n in batch])

        triples = []
        for r in self.store.get_edges(user_id=self.user_id):
            edge = Edge(
                source=r.get("source_id") or r.get("source"),
                target=r.get("target_id") or r.get("target"),
                weight=float(r.get("weight", 0.5)),
                edge_type=r.get("edge_type", "relates_to"),
                co_occurrence=int(r.get("co_occurrence", 1)),
                last_updated=r.get("last_updated", time.time()),
            )
            key = (edge.source, edge.target)
            owner = self._shard_of_node(edge.source)
            if owner is None:
                owner = self._get_or_create_shard("default")
            owner.edges[key] = edge
            self._edge_shard[key] = owner.shard_key
            triples.append((self._q(edge.source), self._q(edge.target), edge.weight))
        if triples:
            self.index.add_edges(triples, self.user_id)

    def check_for_updates(self) -> bool:
        """Reload the tenant when another process wrote the store since this
        one last read or wrote it; True when it did."""
        try:
            current = self.store.get_latest_version()
            if current > self._last_version:
                self._log(f"🔄 Store updated (v{current}), reloading...")
                self._load_from_persistence()
                return True
        except Exception:       # noqa: BLE001 — a poll never raises
            _logger.warning("store poll failed", exc_info=True)
        return False

    # ------------------------------------------------------------ snapshots
    def _host_graph(self, node_dict) -> Dict[str, Any]:
        """The current user's host graph, profile, counters and settings:
        the JSON of both snapshot kinds, nodes through ``node_dict``."""
        return {
            "shards": {
                k: {"nodes": node_dict(list(v.nodes.values())),
                    "edges": [e.to_dict() for e in v.edges.values()]}
                for k, v in self.shards.items()},
            "super_nodes": node_dict(list(self.super_nodes.values())),
            "profile": self.profile.to_dict(),
            "node_counter": self.node_counter,
            "conversation_count": self.conversation_count,
            "settings": {
                "auto_consolidate": self.auto_consolidate,
                "consolidate_every": self.consolidate_every,
                "auto_prune": self.auto_prune,
                "prune_threshold": self.prune_threshold,
                "max_buffer_size": self.max_buffer_size,
            },
        }

    def _restore_host_counters(self, saved: Dict[str, Any]) -> None:
        profile_data = saved.get("profile", {})
        self.profile.data = profile_data.get("data", self.profile.data)
        self.profile.last_updated = profile_data.get("last_updated", time.time())
        self.node_counter = saved.get("node_counter", 0)
        self.conversation_count = saved.get("conversation_count", 0)
        for key, val in saved.get("settings", {}).items():
            if hasattr(self, key):
                setattr(self, key, val)
        # The restored graph no longer matches the store's rows: the next
        # save is a full rewrite.
        self._store_synced = False
        self._dirty_nodes.clear()
        self._dirty_edges.clear()
        self._deleted_edge_ids.clear()

    def save_snapshot(self, snapshot_dir: str) -> str:
        """Binary system snapshot (``lazzaro_tpu/core/memory_system.py:
        save_snapshot``): the index checkpoint of every tenant's rows
        (``core.checkpoint``) plus ``host.json``, the current user's host
        graph without embeddings. Both halves carry one ``snapshot_id``."""
        import uuid

        from lazzaro_tpu_torch.core import checkpoint as ckpt
        from lazzaro_tpu_torch.core.store import _atomic_write

        # Drain before the mutex: the worker takes it to consolidate.
        self._drain_background()
        with self._mutex:
            self._sync_from_arena()

            def slim(nodes: List[Node]) -> List[Dict[str, Any]]:
                out = []
                for n in nodes:
                    d = n.to_dict()
                    d.pop("embedding", None)
                    out.append(d)
                return out

            # The halves are written apart (never atomic as a pair): a crash
            # between them pairs a fresh half with a stale one, which
            # load_snapshot detects by this id.
            snapshot_id = uuid.uuid4().hex
            host = {"snapshot_id": snapshot_id, "user_id": self.user_id,
                    **self._host_graph(slim)}
            os.makedirs(snapshot_dir, exist_ok=True)
            _atomic_write(os.path.join(snapshot_dir, "host.json"),
                          json.dumps(host).encode())
            ckpt.save_index(self.index, os.path.join(snapshot_dir, "index"),
                            extra_meta={"snapshot_id": snapshot_id})
        return f"✓ Snapshot saved to {snapshot_dir}"

    def load_snapshot(self, snapshot_dir: str) -> str:
        """Restore from :meth:`save_snapshot` output. Host nodes come back
        with ``embedding=None`` (the arena owns the vectors). An in-flight
        conversation is discarded, and the journals reopen for the
        snapshot's user. A missing or corrupt snapshot leaves the system as
        it was and returns a warning."""
        from lazzaro_tpu_torch.core import checkpoint as ckpt

        try:
            with open(os.path.join(snapshot_dir, "host.json")) as f:
                host = json.load(f)
        except FileNotFoundError:
            return f"⚠ No snapshot at {snapshot_dir}"
        except json.JSONDecodeError as e:
            return f"⚠ Corrupt snapshot at {snapshot_dir}: {e}"
        if not isinstance(host, dict):
            return f"⚠ Corrupt snapshot at {snapshot_dir}: host.json is not an object"

        # Everything fallible is staged before live state is touched.
        pair_warning = ""
        index_dir = os.path.join(snapshot_dir, "index")
        cfg = self.config
        try:
            new_index = ckpt.load_index(
                index_dir, mesh=self.mesh,
                device=self.device if self.mesh is None else None,
                telemetry=self.telemetry, serve_ragged=cfg.serve_ragged,
                serve_k_max=cfg.serve_k_max,
                serve_pad_granularity=cfg.serve_pad_granularity,
                **self._index_reliability_kwargs())
            sid_host = host.get("snapshot_id")
            sid_index = ckpt.read_meta(index_dir).get("snapshot_id")
            if sid_host and sid_index and sid_host != sid_index:
                pair_warning = (" ⚠ host.json and index checkpoint carry "
                                "different snapshot ids — one half is stale "
                                "(crash between the two writes?)")
                self._log(f"⚠ snapshot pair mismatch in {snapshot_dir}: "
                          f"host={sid_host[:8]} index={sid_index[:8]}")
            staged_shards: Dict[str, Tuple[List[Node], List[Edge]]] = {}
            for shard_key, sd in host.get("shards", {}).items():
                staged_shards[shard_key] = (
                    [Node.from_dict(nd) for nd in sd.get("nodes", [])],
                    [Edge.from_dict(ed) for ed in sd.get("edges", [])])
            staged_supers = [Node.from_dict(nd)
                             for nd in host.get("super_nodes", [])]
        except (OSError, ValueError, KeyError, TypeError) as e:
            return f"⚠ Corrupt snapshot at {snapshot_dir}: {e}"

        self._drain_background()   # outside the mutex: the worker needs it
        with self._mutex:
            self.index = new_index
            self.user_id = host.get("user_id", self.user_id)
            self.shards.clear()
            self.super_nodes.clear()
            self._edge_shard.clear()
            self._node_shard_cache.clear()
            self.conversation_active = False
            self.short_term_memory.clear()
            self.conversation_history.clear()
            self.consolidation_queue.clear()
            self._inflight_batches.clear()
            # The old user's turn journal: the discarded turns must not
            # replay as crashed ones.
            self._journal_sync()
            for shard_key, (nodes, edges) in staged_shards.items():
                shard = self._get_or_create_shard(shard_key)
                for node in nodes:
                    shard.add_node(node)
                for edge in edges:
                    key = (edge.source, edge.target)
                    shard.edges[key] = edge
                    self._edge_shard[key] = shard_key
            for node in staged_supers:
                self.super_nodes[node.id] = node
            self._restore_host_counters(host)
            if self.query_cache:
                self.query_cache.invalidate_results()
        # Reopen the journals for the restored user, as switch_user does.
        self._setup_journal()
        self._setup_ingest_journal()
        return f"✓ Snapshot loaded from {snapshot_dir}{pair_warning}"

    def save_state(self, filename: str = "memory_state.json") -> str:
        """The current user's graph as human-readable JSON, embeddings
        included (filled from the arena where a host node has none)."""
        with self._mutex:
            self._sync_from_arena()

            def with_embeddings(nodes: List[Node]) -> List[Dict[str, Any]]:
                out = [n.to_dict() for n in nodes]
                self._bulk_fill_embeddings(out, [n.id for n in nodes])
                return out

            state = self._host_graph(with_embeddings)
        with open(filename, "w") as f:
            json.dump(state, f, indent=2)
        return f"✓ State saved to {filename}"

    def load_state(self, filename: str = "memory_state.json") -> str:
        """Replace the current user's graph with a :meth:`save_state` file;
        its nodes with an embedding of the arena's width go to the arena in
        one ``add``."""
        try:
            with open(filename) as f:
                state = json.load(f)
        except FileNotFoundError:
            return f"⚠ File {filename} not found"

        with self._mutex:
            stale = list(self.index.tenant_nodes.get(self.user_id, set()))
            if stale:
                self.index.delete(stale)
            self.shards.clear()
            self.super_nodes.clear()
            self._edge_shard.clear()
            self._node_shard_cache.clear()

            def arena_ready(node: Node) -> bool:
                return (node.embedding is not None
                        and len(node.embedding) == self.embed_dim)

            batch: List[Node] = []
            for shard_key, shard_data in state.get("shards", {}).items():
                shard = self._get_or_create_shard(shard_key)
                for nd in shard_data.get("nodes", []):
                    node = Node.from_dict(nd)
                    shard.add_node(node)
                    if arena_ready(node):
                        batch.append(node)
                for ed in shard_data.get("edges", []):
                    edge = Edge.from_dict(ed)
                    key = (edge.source, edge.target)
                    shard.edges[key] = edge
                    self._edge_shard[key] = shard_key
            for nd in state.get("super_nodes", []):
                node = Node.from_dict(nd)
                self.super_nodes[node.id] = node
                if arena_ready(node):
                    batch.append(node)

            if batch:
                self.index.add(
                    [self._q(n.id) for n in batch],
                    np.asarray([n.embedding for n in batch], np.float32),
                    [n.salience for n in batch],
                    [n.timestamp for n in batch],
                    [n.type for n in batch],
                    [n.shard_key or "default" for n in batch],
                    self.user_id,
                    [n.is_super_node for n in batch])
            triples = [(self._q(e.source), self._q(e.target), e.weight)
                       for sh in self.shards.values() for e in sh.edges.values()]
            if triples:
                self.index.add_edges(triples, self.user_id)
            self._restore_host_counters(state)
        return f"✓ State loaded from {filename}"

    # ------------------------------------------------------ export/insights
    def export_observations(self, format: str = "markdown") -> str:
        """The ``export_top_n`` most salient (then most recently used)
        non-super memories, as markdown or JSON, after a sync from the
        arena."""
        with self._mutex:
            self._sync_from_arena()
            nodes = [n for s in self.shards.values() for n in s.nodes.values()
                     if not n.is_super_node]
        nodes.sort(key=lambda n: (n.salience, n.last_accessed), reverse=True)
        top = nodes[:self.config.export_top_n]

        if format == "json":
            return json.dumps([n.to_dict() for n in top], indent=2)

        lines = [f"# Memory Observations for {self.user_id}", ""]
        for n in top:
            lines.append(f"### {n.type.capitalize()} Memory ({n.shard_key})")
            lines.append(f"- **Content**: {n.content}")
            lines.append(f"- **Salience**: {n.salience:.2f}")
            lines.append(f"- **Last Accessed**: {time.ctime(n.last_accessed)}")
            lines.append("")
        return "\n".join(lines)

    def get_insights(self) -> str:
        """One LLM call over the exported observations: a profile of the
        user's traits, interests, patterns and recent focus."""
        observations = self.export_observations(format="json")
        system_prompt = f"""Analyze these atomic memories for user '{self.user_id}' and provide a comprehensive psychological and knowledge profile.
Identify long-term patterns, core beliefs, persistent interests, and significant life events reflected in the data.

Structure your response as:
1. **Personality Traits**: Key characteristics detected.
2. **Core Interests & Knowledge**: What the user knows and cares about.
3. **Behavioral Patterns**: How the user typically interacts or works.
4. **Recent Focus**: Most salient topics from recent memories.

Be clinical yet insightful. Do not include conversational filler."""
        return self._call_llm([
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": f"User Observations:\n{observations}"},
        ])

    # ------------------------------------------------------------------ stats
    def get_stats(self) -> Dict:
        nodes, edges = self.buffer.size()
        rt = self.telemetry.timer_values("chat.retrieval_ms")
        ct = self.telemetry.timer_values("consolidation.run_ms")
        cache_hit_rate = self.query_cache.get_hit_rate() if self.query_cache else 0.0
        return {
            "buffer_nodes": nodes,
            "buffer_edges": edges,
            "num_shards": len(self.shards),
            "num_super_nodes": len(self.super_nodes),
            "short_term_memories": len(self.short_term_memory),
            "conversation_active": self.conversation_active,
            "conversation_count": self.conversation_count,
            "profile_domains_filled": sum(1 for v in self.profile.data.values() if v),
            "auto_consolidate": self.auto_consolidate,
            "vector_store": ((f"device arena on {self.device}"
                              if self.mesh is None else
                              f"device arena over a {self.mesh.size}-shard mesh")
                             + f" + {type(self.store).__name__}"),
            "mesh_size": self.mesh.size if self.mesh is not None else 1,
            "performance": {
                "avg_retrieval_ms": f"{float(np.mean(rt)) if rt else 0:.1f}",
                "p95_retrieval_ms": f"{float(np.percentile(rt, 95)) if rt else 0:.1f}",
                "avg_consolidation_s": f"{float(np.mean(ct)) / 1e3 if ct else 0:.2f}",
                "cache_hit_rate": f"{cache_hit_rate:.1%}",
                "llm_calls": self.metrics["llm_calls"],
                "embedding_calls": self.metrics["embedding_calls"],
            },
            "index": self.index.stats(),
            "serving": (self.query_scheduler.stats()
                        if self.query_scheduler is not None else None),
            "providers": {"llm": type(self.llm).__name__,
                          "embedder": type(self.embedder).__name__},
        }

    def display_stats(self) -> str:
        stats = self.get_stats()
        next_consolidation = self.consolidate_every - (
            self.conversation_count % self.consolidate_every)
        return f"""
📊 SCALABLE MEMORY SYSTEM STATS:
STORAGE:
  • Buffer nodes: {stats["buffer_nodes"]} / {self.max_buffer_size} max
  • Buffer edges: {stats["buffer_edges"]}
  • Shards: {stats["num_shards"]}
  • Super-nodes: {stats["num_super_nodes"]}
  • STM: {stats["short_term_memories"]}
  • Conversations: {stats["conversation_count"]}
  • Profile domains: {stats["profile_domains_filled"]}/5

⚡ PERFORMANCE:
  • Avg retrieval: {stats["performance"]["avg_retrieval_ms"]}ms
  • P95 retrieval: {stats["performance"]["p95_retrieval_ms"]}ms
  • Avg consolidation: {stats["performance"]["avg_consolidation_s"]}s
  • Cache hit rate: {stats["performance"]["cache_hit_rate"]}
  • LLM calls: {stats["performance"]["llm_calls"]}
  • Embedding calls: {stats["performance"]["embedding_calls"]}

⚙️ AUTO-MANAGEMENT:
  • Auto-consolidate: {"ON" if stats["auto_consolidate"] else "OFF"} (every {self.consolidate_every})
    → Next in: {next_consolidation} conversation(s)
  • Auto-prune: {"ON" if self.auto_prune else "OFF"} (threshold: {self.prune_threshold})
  • Max buffer: {self.max_buffer_size} nodes
  • Sharding: {"ON" if self.enable_sharding else "OFF"}
  • Hierarchy: {"ON" if self.enable_hierarchy else "OFF"}
  • Caching: {"ON" if self.enable_caching else "OFF"}
  • Async: {"ON" if self.enable_async else "OFF"}
"""

    def display_memories(self, limit: int = 10) -> str:
        if not self.buffer.nodes:
            return "No memories stored yet."
        nodes = self.buffer.get_all_nodes_summary()
        out = [f"\n💭 Stored Memories (showing {min(limit, len(nodes))} of {len(nodes)}):"]
        for i, node in enumerate(nodes[:limit], 1):
            out.append(f"\n{i}. [{node['type']}] 📦 {node['shard']} "
                       f"(salience: {node['salience']:.2f}, accessed: {node['access_count']}x)")
            out.append(f"   {node['content']}")
        return "\n".join(out)

    def display_profile(self) -> str:
        return f"\n👤 User Profile:\n{self.profile.get_context()}\n"

    # ------------------------------------------------------------------ close
    def close(self) -> None:
        lpump = getattr(self, "lifecycle_pump", None)
        if lpump is not None:
            lpump.stop()
        sched = getattr(self, "query_scheduler", None)
        if sched is not None:
            sched.close()
        if getattr(self, "background_executor", None):
            self.background_executor.shutdown(wait=True)
        # Facts the flush policy deferred land now rather than never.
        if getattr(self, "_ingest_coalescer", None) and len(self._ingest_coalescer):
            start = time.time()
            wait_ms = self._ingest_coalescer.oldest_age_s() * 1e3
            commit_to = (self._ingest_journal.last_seq
                         if self._ingest_journal is not None else 0)
            drained: List[Tuple[str, str]] = []
            for facts, _n_convs in self._ingest_coalescer.drain():
                self.telemetry.record("ingest.coalesce_wait_ms", wait_ms)
                drained.extend(self._ingest_facts(facts))
            self._finish_consolidation(drained, start)
            if self._ingest_journal is not None:
                self._ingest_journal.commit(commit_to)
        if getattr(self, "_pending_boosts", None):
            self._flush_pending_boosts()
        if getattr(self, "store", None) is not None:
            self.store.close()
