"""Central configuration of the PyTorch/CUDA port.

Counterpart of ``lazzaro_tpu/config.py``: the same dataclass with every
field, so a configuration moves between the two packages unchanged. The port
runs dense single-chip serving (fused by default) and the classic ingest;
fields whose paths are not ported yet
default to the values that path needs (each marked "not ported yet"), and
:meth:`MemoryConfig.check_ported` raises ``NotImplementedError`` naming the
ROADMAP item when one of those paths is switched on. When a later slice
ports a path, that field's default goes back to the JAX default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class MemoryConfig:
    # --- geometry ----------------------------------------------------------
    embed_dim: int = 768            # first-class (ref hardcodes 1536 in schema)
    initial_capacity: int = 1024    # arena rows; grows by doubling
    max_edges: int = 8192           # edge arena rows; grows by doubling
    dtype: str = "float32"          # arena embedding dtype ("bfloat16" for 1M+)
    # Paged embedding arena: the master emb becomes fixed-size
    # HBM pages behind an int32 row_map indirection with a device-side
    # free list — delete/tier-demote push pool slots back (demotion
    # reclaims real capacity), logical growth is O(metadata) and never
    # copies the pool. Bit-parity with the dense arena on every fused
    # mode; single-chip only (ignored with a warning under a mesh).
    paged_arena: bool = False
    arena_page_rows: int = 4096     # pool page granularity (rows/page)
    # Int8 serving shadow (ops/quant.py): user-facing searches scan a
    # per-row-quantized copy at half the HBM bytes (the bandwidth floor is
    # what bounds 1M-row retrieval); consolidation's dedup/link/merge
    # decisions keep scanning the exact master arena. Composes with a
    # mesh: the shadow row-shards like the master and each chip scans its
    # local int8 rows (ops/topk.py make_sharded_int8_topk).
    int8_serving: bool = False
    # IVF coarse stage (ops/ivf.py): > 0 sets nprobe and routes serving
    # searches through centroid prefilter + member gather once the arena
    # passes ~4k live rows (below that exact scans are trivial). Fresh
    # rows serve exactly from a residual until the periodic rebuild;
    # recall is controlled by nprobe (== n_clusters is exact). Consolidation
    # gates always use the exact master. Single-chip only.
    ivf_serving: int = 0
    # Online IVF maintenance: with ivf_serving > 0 and a seeded
    # build, cluster assignments are maintained INSIDE the fused ingest
    # dispatch — the accepted batch is scored against the centroids in the
    # same program that already computes the dedup/link score matrix, rows
    # append to per-cluster member tables in-kernel (prefix-sum compacted,
    # overflow rides the packed-readback flag and re-inserts host-side
    # into the exact-scan extras), and a bounded mini-batch spherical
    # k-means update amortizes centroid refinement over ingest batches.
    # ``ivf_maintenance`` then demotes to a rare host-driven re-seed
    # (centroid-count changes / heavy delete churn) — no stop-the-world
    # k-means on the write path, assignments never stale behind a rebuild.
    # Off = the sealed/fresh split (every fresh row serves from the
    # exact residual until the next offline rebuild).
    ivf_online: bool = True
    # Per-cluster member capacity of the online tables: capacity =
    # factor · N/C (pow2-rounded) — the same knob build_ivf takes. Rows
    # past a cluster's capacity overflow into the exact-scan extras
    # (counted in ivf.member_overflows), never dropped.
    ivf_member_cap_factor: int = 4
    # Scale on the mini-batch centroid learning rate (eta_c =
    # scale · b_c / (count_c + b_c)): 1.0 is the classic mini-batch
    # k-means step; smaller values trade adaptation speed for assignment
    # stability (lower ivf.assignment_staleness under drift).
    ivf_online_eta: float = 1.0
    # Coarse-stage over-fetch slack shared by every two-stage serving path
    # (MemoryIndex.coarse_slack): the IVF member scan and the int8 fused
    # kernel both fetch k + slack coarse candidates before exact
    # rescore/dedup, so duplicate slots (IVF) or int8 ranking error at the
    # k boundary (quantized fused serving) can never shrink a result below
    # k live rows.
    coarse_fetch_slack: int = 8
    # IVF-PQ member storage (ops/pq.py; LanceDB's default index family):
    # with ivf_serving > 0, the member scan reads product-quantized codes
    # (m = dim/8 bytes per row instead of dim·2) and the top shortlist is
    # re-scored exactly from the master, so returned scores stay exact.
    # Serves fused (state.search_fused_pq — ADC table build, m-byte
    # member scan, exact rescore, gate/CSR/boost tail in ONE dispatch)
    # with codes maintained INSIDE the fused ingest dispatch against the
    # frozen codebook; the codebook retrains only on ivf_maintenance's
    # rare re-seed. Composes with tiering (cold rows scan the PQ slab)
    # and the mesh. No effect without ivf_serving.
    pq_serving: bool = False
    # Fused single-dispatch ingest (core/state.py ingest_fused): the
    # per-conversation mutation sequence (node scatter, dedup merge touch,
    # two-mode link scan, gated edge insert) runs as ONE donated device
    # program + ONE packed readback. Off = the classic four-dispatch
    # sequence (debug/fallback; semantics are identical).
    ingest_fused: bool = True
    # Cross-conversation ingest coalescing cap (utils/batching.py
    # IngestCoalescer): facts from every buffered conversation merge into
    # mega-batches of at most this many rows per fused dispatch.
    ingest_coalesce_max: int = 8192
    # Time/size flush policy for the coalescer (utils/batching.FlushPolicy):
    # > 0 DEFERS small young mega-batches for up to this many seconds so a
    # steady trickle of single conversations coalesces into dense fused
    # dispatches instead of draining one conversation at a time. Deferred
    # facts stay journaled (their source turns remain in the WAL) until
    # ingested. 0 (default) = eager: every consolidation drains immediately.
    ingest_flush_wait_s: float = 0.0
    # Edge-slot pool sizing hint for the compacting fused ingest (ROADMAP
    # ceiling #2): the gated link insert pre-allocates ceil(hint · 2·B·k)
    # edge slots instead of the 2·B·k worst case (2 = shard modes, B =
    # mega-batch facts, k = cross_link_top_k). Set it near the workload's
    # measured link-acceptance rate (e.g. 0.25) to stop huge mostly-
    # rejected batches from transiently draining the edge free list; the
    # rare batch whose acceptance beats the hint raises an in-kernel
    # overflow flag and the host re-inserts exactly the overflowed edges
    # (one extra dispatch for that batch, MemoryIndex.link_pool_overflows
    # counts them). 1.0 (default) = worst-case pool, never overflows.
    link_accept_hint: float = 1.0
    # Fold the dedup probe into the fused ingest program
    # (state.ingest_dedup_fused): the masked pre-add top-1 + intra-batch
    # gram that _ingest_facts otherwise pays a separate search_batch
    # dispatch+readback for runs INSIDE the same donated dispatch, making
    # ingest ONE round trip end-to-end. Only effective with ingest_fused.
    ingest_dedup_fused: bool = True
    # Pod-scale fused ingest: under a mesh, run the whole
    # dedup-fused ingest program as ONE distributed shard_map dispatch
    # (state.make_ingest_fused_sharded) — shard-local dedup/link scans,
    # one all_gather candidate merge, owner-chip-local node/edge/shadow
    # scatters — so write throughput scales with the mesh like read
    # throughput does. Off = let GSPMD partition the plain jit
    # kernel (correct, but re-replicates candidate tensors chip-to-chip
    # every batch; debug/fallback). No effect without a mesh.
    ingest_sharded: bool = True

    # --- serving path (lazzaro_tpu/serve) ----------------------------------
    # Fused single-dispatch retrieval (core/state.py search_fused): the
    # per-chat-turn serving sequence — super-node top-1 gate, main-arena
    # ANN top-k, CSR neighbor gather, neighbor- + access-salience boosts —
    # runs as ONE donated device program + ONE packed readback, routed
    # through the cross-request QueryScheduler so concurrent users share
    # dense device batches. Off = the classic 3-4 dispatch sequence.
    # With int8_serving on, the fused program streams the int8 shadow for
    # a coarse top-(k + coarse_fetch_slack) and exactly rescores the
    # survivors from the master (state.search_fused_quant) — still ONE
    # dispatch. With ivf_serving > 0 and a published build, the coarse
    # stage becomes the IVF centroid prefilter + member gather INSIDE the
    # same dispatch (state.search_fused_ivf; composes with int8 as
    # gathered-int8 coarse + exact rescore). Under a MESH the same
    # chat-turn program runs as ONE distributed shard_map dispatch
    # (state.make_fused_sharded): shard-local scan (exact or int8
    # coarse+rescore), one all_gather + global top-k merge, then the
    # gate/CSR/boost tail with shard-local scatters — the pod path keeps
    # the full serving semantics. With pq_serving on, the coarse stage is
    # the in-dispatch ADC member scan over the m-byte code slab
    # (state.search_fused_pq) — every mode is fused now.
    serve_fused: bool = True
    # QueryScheduler flush policy: a pending batch ships when it reaches
    # serve_batch_max requests OR when its oldest request has waited
    # serve_flush_us microseconds — bursty load coalesces, a lone request
    # is never held hostage. Batches pad to power-of-two buckets so jit
    # specializations stay bounded. With serve_continuous (default) the
    # wait only ever applies while a dispatch is in flight — an idle
    # scheduler ships immediately.
    serve_batch_max: int = 64
    serve_flush_us: int = 2000
    # Continuous batching: instead of flush-boundary mega-
    # batches, the scheduler admits pending requests into the next
    # dispatch the moment the worker is free — a lone request on an idle
    # scheduler dispatches immediately (no serve_flush_us wait), and
    # requests arriving while a dispatch is in flight coalesce naturally
    # into the next one (the in-flight dispatch IS the batching window).
    # Off = the flush-boundary policy (A/B + fallback).
    serve_continuous: bool = True
    # Per-tenant admission control for continuous batching: at most this
    # many of one tenant's requests are admitted into a single dispatch
    # (oldest-first across tenants; over-cap requests stay queued for the
    # next dispatch, so one flooding tenant cannot monopolize the batch).
    # 0 = unlimited.
    serve_tenant_max_inflight: int = 0
    # Ragged fused serving: per-query k / cap_take / nprobe
    # ride into the kernel as int32 sidecar columns (device data) instead
    # of trace constants — the scan bodies compute to the serve_k_max
    # ceiling and mask each query at its own top-k boundary, so ONE
    # compiled kernel per (mode × geometry) serves any mix of request
    # shapes: a k=100 request no longer re-keys the whole batch's kernel,
    # and mixed-k traffic stops burning compile-cache entries. Off = one
    # kernel per (mode × batch-max-k-bucket).
    serve_ragged: bool = True
    # Static per-query k ceiling of the ragged kernels (requests clamp to
    # it; raising it retraces once per mode). 128 covers the classic API
    # surface (ann_limit, retrieval caps) with headroom.
    serve_k_max: int = 128
    # Query-batch padding granularity of the ragged path: batches pad to
    # the next multiple of this instead of the next power of two — worst-
    # case padded waste drops from ~50% of the dispatch to granularity-1
    # slots, and jit specializations stay bounded by
    # serve_batch_max / granularity buckets.
    serve_pad_granularity: int = 8
    # LRU cap on the compiled serving-kernel caches (single-chip sharded
    # factory cache and the pod index's fused cache): with ragged kernels
    # the keys collapse to per-mode entries anyway; the cap evicts stale
    # per-k-bucket kernels left behind by non-ragged traffic instead of
    # letting kernel.cache_entries grow without bound.
    # (This package runs no jit, so it has nothing to cache: the field is
    # kept for the JAX field set and read by nothing.)
    serve_kernel_cache_max: int = 8
    # Neighbor-gather width of the fused retrieval kernel: at most this
    # many CSR neighbors per retrieved row receive the neighbor-salience
    # boost on device. Nodes with higher degree get a truncated boost set
    # (bounded device work is the contract; raise for denser graphs).
    serve_max_nbr: int = 32
    # Deferred-boost accumulator cap: cache-hit chat turns queue (access,
    # neighbor) boost counts host-side and flush them as ONE scatter at
    # conversation end / save; the flush also triggers early past this
    # many distinct nodes.
    serve_boost_flush_max: int = 4096
    # Semantic query cache: a device-resident ring of recent
    # query embeddings + their packed top-k results, probed INSIDE every
    # fused serving kernel — a query whose top-1 cosine against the ring
    # clears semantic_cache_threshold substitutes the cached result and
    # early-outs its scan, in the SAME one dispatch + one packed
    # readback. Misses write themselves back into the ring in-dispatch
    # (LIFO rotation). Entries are keyed by (tenant, serving-mode,
    # requested k/nprobe), so a mode flip or geometry change is an
    # automatic miss; host-side invalidation (ingest, delete, tier
    # moves, lifecycle) flips validity bits via a row→slot reverse
    # index, so stale hits never serve. Off by default: exact-text hits
    # already ride the host QueryCache; this tier catches PARAPHRASED
    # repeated intent at near-zero device cost.
    semantic_cache: bool = False
    # Ring capacity in cached queries (per index; the pod path keeps one
    # replicated ring). HBM cost ≈ slots · (d·4 + width·8) bytes.
    semantic_cache_slots: int = 64
    # Top-1 cosine a probe must clear against a same-(tenant, mode,
    # geometry) ring entry to substitute its cached result. Near-dup
    # paraphrases of one intent sit ≥ 0.98 under typical embedders;
    # raise toward 1.0 to serve only near-verbatim repeats.
    semantic_cache_threshold: float = 0.985
    # Static block width of the in-kernel miss scan's early-out loop
    # (queries per while_loop step; trace-time constant).
    semantic_cache_block: int = 16

    # --- reliability --------------------------------------------
    # Per-dispatch watchdog deadline for the query scheduler: > 0 arms a
    # timer per device dispatch; on expiry the batch's futures fail with
    # the typed DispatchTimeout (the stuck dispatch is left to finish and
    # its late results are discarded) and the circuit breaker records a
    # failure. 0 (default) = no deadline.
    serve_dispatch_timeout_s: float = 0.0
    # Serving circuit breaker: this many CONSECUTIVE dispatch failures/
    # timeouts open it; while open (for serve_breaker_cooldown_s) every
    # batch serves DEGRADED — per-request nprobe/cap_take clamped to the
    # serve_degrade_* rung (cheaper device work, same k results) — then
    # one half-open probe at full quality decides re-close vs re-open.
    # 0 disables the breaker.
    serve_breaker_threshold: int = 5
    serve_breaker_cooldown_s: float = 5.0
    serve_degrade_cap_take: int = 1
    # (Read by nothing until IVF serving is ported: the dense path has no
    # nprobe to clamp.)
    serve_degrade_nprobe: int = 1
    # Admission load-shedding budgets: a submit that would push the
    # pending queue past this many requests (or this many query bytes)
    # fails immediately with the typed LoadShed — the device never sees
    # it, and the caller backs off instead of queueing unboundedly.
    # 0 = unlimited.
    serve_shed_depth: int = 0
    serve_shed_bytes: int = 0
    # --- replica-group serving ----------------------------------
    # Partition the mesh into this many replica groups, each holding a
    # FULL copy of the hot arena (master emb, int8 shadow, live IVF/PQ
    # tables, edge CSR) over a group-local sub-mesh. Every coalesced
    # mega-batch routes to exactly ONE group — tenant-affine for overlay
    # reads (read-your-writes), least-loaded for shared-tier reads — so
    # aggregate QPS scales with group count while each turn stays ONE
    # dispatch + ONE packed readback. 1 = classic single-copy serving.
    serve_replica_groups: int = 1
    # Bounded-staleness window for non-primary groups: writes apply to
    # the tenant's home group synchronously and replay to the others via
    # the IngestJournal; the oldest journal entry not yet applied on
    # every group must be younger than this (journal.replica_lag /
    # serve.replica_staleness_s gauges measure it).
    serve_replica_staleness_s: float = 5.0
    # Donation-safe dispatch recovery (reliability.guard): a failed
    # donated dispatch whose input survived retries through the
    # non-donating *_copy twin this many times with exponential backoff
    # (serve.dispatch_retries{mode,reason} counts); one whose input was
    # consumed poisons the index and raises the typed ArenaPoisoned.
    dispatch_retry_max: int = 2
    dispatch_retry_backoff_s: float = 0.005
    # --- memory-safe serving ------------------------------------
    # Per-chip HBM budget the admission-time planner (lazzaro_tpu/plan)
    # guarantees BEFORE any fused serving/ingest geometry compiles: a
    # request predicted to exceed budget minus headroom is served as a
    # chunked-scan single dispatch or as PLANNED sub-dispatches riding
    # the linear pad buckets (plan.split_dispatches counts them — never
    # silent), and a geometry no split can fit is rejected with the typed
    # PlanInfeasible (shed like LoadShed). Runtime RESOURCE_EXHAUSTED is
    # reclassified non-transient (guard.run_guarded): one replan through
    # the copy twins, then typed failure. 0 (default) disables planning
    # entirely — the fused paths then run unplanned.
    hbm_budget_bytes: int = 0
    # Fraction of the budget held back as headroom (allocator slop,
    # fragmentation, the packed readback's host staging).
    hbm_headroom_fraction: float = 0.1
    # Hard ceiling on how many planned sub-dispatches one turn may split
    # into before the planner declares the geometry infeasible.
    plan_max_splits: int = 16
    # Where the cost model persists its calibration (per-family safety
    # multipliers grown until predictions over-bound every recorded AOT
    # memory_analysis() gauge, plus the residual log CI re-checks).
    # None = in-memory only.
    plan_calibration_path: Optional[str] = None

    # Durable ingest journal (reliability.journal): extracted facts are
    # appended to a CRC-framed WAL the moment extraction returns and
    # committed only after their fused ingest dispatch lands, so a crash
    # anywhere in the extraction → coalescer → dispatch window loses
    # ZERO facts — startup replays uncommitted batches through the
    # normal ingest, where the in-dispatch dedup probe makes the replay
    # idempotent. ingest_journal_fsync additionally fsyncs per append
    # (power-loss durability) at ~1 ms/batch cost.
    ingest_journal: bool = True
    ingest_journal_fsync: bool = False

    # --- tiered memory -------------------------------------------
    # Hot-row budget: > 0 attaches the tiered-memory manager + pump
    # (tier.TierManager / tier.TierPump). The int8 shadow stays HBM-
    # resident for EVERY row so the fused coarse scan still covers the
    # whole corpus in one dispatch; rows past the budget demote their
    # full-precision embedding to a host ColdStore (optionally memory-
    # mapped under tier_cold_dir), chosen coldest-first by the salience/
    # recency signal the decay sweeps already maintain. Hot-only chat
    # turns stay ONE dispatch; a turn whose candidates touch cold rows
    # pays one bounded second dispatch (exact rescore of the host-
    # gathered rows + the deferred boosts) — never a full-arena fault-in.
    # 0 (default) = single-tier, everything HBM-resident.
    tier_hot_budget_rows: int = 0
    # Demotion fires when hot rows exceed high_watermark · budget and
    # drains down to low_watermark · budget; the gap is the anti-thrash
    # hysteresis band.
    tier_high_watermark: float = 0.9
    tier_low_watermark: float = 0.75
    # Rows per pump chunk (double-buffered device↔host transfers).
    tier_chunk_rows: int = 4096
    # Never demote a row accessed within this many seconds (0 = off).
    tier_min_idle_s: float = 0.0
    # A cold row promotes back to HBM after this many serving hits.
    tier_promote_hits: int = 1
    # A freshly promoted row is demotion-immune for this many seconds.
    tier_hysteresis_s: float = 30.0
    # Background pump cadence; 0 disables the thread (call
    # index.tiering.run_once() manually — tests and bench do).
    tier_pump_interval_s: float = 1.0
    # Directory for memory-mapped cold vector slabs (the SSD tier);
    # None keeps the cold tier in host RAM.
    tier_cold_dir: Optional[str] = None

    # --- device-side lifecycle ----------------------------------
    # ``MemorySystem.lifecycle_tick`` runs decay + weak-edge prune +
    # importance-ranked archive verdicts for ALL tenants as ONE dispatch
    # + ONE packed readback; "archived" means demoted-to-cold (verdicts
    # feed the TierPump queue), never deleted. False falls back
    # to the classic host-driven per-tenant loop (the A/B + bit-parity
    # oracle).
    lifecycle_fused: bool = True
    # Background tick cadence; 0 disables the thread (call
    # ``lifecycle_tick()`` manually — tests and bench do).
    lifecycle_interval_s: float = 0.0
    # Bottom-k archive verdicts per tenant per sweep (0 skips the archive
    # stage's host decode; the readback layout is unchanged).
    lifecycle_archive_k: int = 8
    # Scheduler-awareness: a tick defers (lifecycle.deferred_busy) while
    # the serving scheduler reports more than this many pending+inflight
    # requests, so maintenance never queues behind — or races — an
    # in-flight serve/ingest donation.
    lifecycle_busy_load: int = 0

    # --- serving telemetry ---------------------------------------
    # Host spans + device counters: every request records enqueue→flush
    # queue wait (per-tenant label), every coalesced batch records pad
    # inflation, device dispatch wall time and readback-decode time, and
    # the fused kernels append an int32 counter tail (gate hit/miss, top-k
    # shortfall, dedup hits, boost-scatter rows, link-pool occupancy/
    # overflow) to the packed readback that already exists — bytes, not
    # dispatches. Off = the registry stays empty but the readback layout
    # is unchanged (the tail always rides; decoding it is nearly free).
    serve_telemetry: bool = True
    # Telemetry ring-buffer window per timer series (percentiles are
    # computed over at most this many recent samples).
    serve_telemetry_window: int = 10_000
    # AOT-lower each fused serving geometry's read twin ONCE to record its
    # compiled ``memory_analysis()`` peak-HBM gauge
    # (kernel.peak_hbm_bytes{mode,k,rows,mesh}). Costs one extra compile
    # per (mode × geometry × mesh) key — never an extra dispatch — so it
    # defaults off; bench runs and the HBM-budget CI direction (ROADMAP
    # item 8) turn it on.
    serve_telemetry_hbm: bool = False

    # --- behavior flags (parity with memory_system.py:63-84) ---------------
    enable_sharding: bool = True
    enable_hierarchy: bool = True
    enable_caching: bool = True
    enable_async: bool = True

    # --- scale knobs -------------------------------------------------------
    max_shard_size: int = 500       # shard split threshold (ref declared, never used)
    super_node_threshold: int = 20
    auto_consolidate: bool = True
    consolidate_every: int = 3
    auto_prune: bool = True
    prune_threshold: float = 0.5
    max_buffer_size: int = 10
    cache_size: int = 1000

    # --- durability --------------------------------------------------------
    # The reference persists only at conversation end (memory_system.py:648);
    # a crash mid-conversation loses every buffered turn (SURVEY §5 "failure
    # detection: none"). With journaling on, each short-term turn is appended
    # to a CRC-framed WAL (native/) and replayed on restart. journal_fsync
    # additionally fsyncs per append (survives power loss, not just process
    # crash) at ~1ms/turn cost.
    journal: bool = True
    journal_fsync: bool = False

    # --- semantic thresholds (exact parity per SURVEY §7 "hard parts") -----
    dedup_similarity: float = 0.95      # memory_system.py:719-741
    super_node_gate: float = 0.4        # hierarchy fast path :472
    link_gate: float = 0.5              # _link_within_shards :797-836
    link_weight_scale: float = 0.8      # link weight = sim * 0.8
    chain_link_weight: float = 0.5      # consecutive new-node chain links
    salience_floor: float = 0.2         # asymptotic decay floor, memory_shard.py:73-77
    decay_rate: float = 0.01            # end_conversation :624
    edge_reinforce: float = 0.1         # add_edge existing-edge bump, memory_shard.py:42
    access_salience_boost: float = 0.05 # update_access, buffer_graph.py:79
    neighbor_salience_boost: float = 0.02  # _boost_neighbors :242-260
    retrieval_cap: int = 5              # merged results cap :488-510
    ann_limit: int = 10                 # store search limit :484-486
    hierarchy_children: int = 10        # fast path takes first 10 children
    history_window: int = 10            # last-N chat history messages :325
    importance_w_salience: float = 0.5  # _enforce_buffer_limit :544-549
    importance_w_access: float = 0.3
    importance_w_recency: float = 0.2
    merge_similarity: float = 0.95      # _merge_similar_nodes threshold
    component_min_size: int = 3         # run_consolidation :970-989
    component_min_avg_weight: float = 0.3
    cross_link_top_k: int = 3           # _link_to_existing_memories top-3
    export_top_n: int = 50              # export_observations :1488-1519

    # --- persistence -------------------------------------------------------
    db_dir: str = "db"
    user_id: str = "default"
    load_from_disk: bool = True

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for a switched-on path the port has
        not reached yet, naming its ROADMAP item."""
        for name, on, item in _UNPORTED:
            if on(getattr(self, name)):
                raise NotImplementedError(
                    f"MemoryConfig.{name}={getattr(self, name)!r}: not ported "
                    f"to lazzaro_tpu_torch yet (ROADMAP {item})")

# (field, "is switched on", ROADMAP item) for every path the port lacks.
_UNPORTED = (
    ("pq_serving", bool, "Queue 1 item 15, PQ"),
    ("paged_arena", bool, "Queue 1 item 16, paged arena"),
    ("tier_hot_budget_rows", lambda v: v > 0, "Queue 1 item 17, tiering"),
    ("semantic_cache", bool, "Queue 1 item 18, semantic cache"),
    ("hbm_budget_bytes", lambda v: v > 0, "Queue 1 item 19, planner"),
)
