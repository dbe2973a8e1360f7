"""Device-resident memory state: the structure-of-arrays arena, in torch.

Counterpart of the dense single-device subset of ``lazzaro_tpu/core/state.py``.
Every numeric per-memory field is one tensor with leading dim
``capacity + 1``; the last row is the sentinel scratch row that absorbs the
padded entries of every batched write, so scatters run on full index
vectors with no masking branches. Embeddings are stored L2-normalized, so
cosine similarity is a dot product.

Ownership: the JAX package donates its state to each mutation and gets a new
one back; here the mutations update the tensors in place (``index_put_``,
``scatter_reduce_``) and return the same state object. ``MemoryIndex`` owns
the live state and serializes writers.

Order of ties: wherever the JAX package calls ``lax.top_k`` this module
calls :func:`ops.topk.stable_topk` (score descending, ties to the lowest
row), and the arena scans go through :func:`ops.masked_topk.masked_topk`
(classic search) and :func:`ops.fused_topk.fused_topk` (fused serving), the
Hopper kernels on a CUDA arena.

Under a mesh (``MemoryIndex(mesh=...)``) the arena is a list of shards, one
``ArenaState`` per shard holding the global rows ``[p * L, (p + 1) * L)``,
the JAX package's row sharding: the global sentinel is the last row of the
last shard. Every single-device function here runs unchanged on one
shard's state with local rows, as each device sees a plain local array
under ``shard_map``; :func:`route_rows` splits a host row list by owner,
and :func:`search_fused_sharded` is the fused serving program over the
shards (``state.py:make_fused_sharded``, exact mode).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields, replace
from typing import ClassVar, Dict, List, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.ops.chunking import nt_dot
from lazzaro_tpu_torch.ops.dedup_resolve import dedup_resolve_gram
from lazzaro_tpu_torch.ops.fused_topk import fused_topk, fused_topk_grouped
from lazzaro_tpu_torch.ops.ingest_topk import ingest_topk
from lazzaro_tpu_torch.ops.int8_topk import int8_topk_keyed
from lazzaro_tpu_torch.ops.ivf import coarse_clusters, segment_sum
from lazzaro_tpu_torch.ops.ivf_topk import ivf_topk
from lazzaro_tpu_torch.ops.masked_topk import masked_topk
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.ops.sharded_merge import sharded_merge
from lazzaro_tpu_torch.ops.topk import ragged_mask, shard_groups, stable_topk

NEG_INF = -1e30

TYPE_IDS = {"semantic": 0, "episodic": 1, "procedural": 2}
TYPE_NAMES = {v: k for k, v in TYPE_IDS.items()}

# Arenas at or above one block allocate capacity + 1 in TOPK_BLOCK multiples
# (MemoryIndex._round_capacity), the JAX package's layout, kept so row numbers
# (and so tie order) match it. The Hopper kernel itself takes any N.
TOPK_BLOCK = 4096


@dataclass
class ArenaState:
    """Node arena; every tensor has leading dim ``capacity + 1``."""

    emb: torch.Tensor            # [cap+1, d] f32 or bf16, L2-normalized rows
    salience: torch.Tensor       # [cap+1] f32 in [0, 1]
    timestamp: torch.Tensor      # [cap+1] f32 seconds since the index epoch
    last_accessed: torch.Tensor  # [cap+1] f32
    access_count: torch.Tensor   # [cap+1] i32
    type_id: torch.Tensor        # [cap+1] i32 (TYPE_IDS)
    shard_id: torch.Tensor       # [cap+1] i32
    tenant_id: torch.Tensor      # [cap+1] i32
    alive: torch.Tensor          # [cap+1] bool
    is_super: torch.Tensor       # [cap+1] bool
    # Set by an in-place write; the dispatch guard clears it around each
    # program and reads it after a failure (reliability.guard).
    written: ClassVar[bool] = False

    @property
    def capacity(self) -> int:
        return self.salience.shape[0] - 1

    @property
    def dim(self) -> int:
        return self.emb.shape[1]


@dataclass
class EdgeState:
    """Edge arena: directed weighted associations between arena rows."""

    src: torch.Tensor            # [E+1] i32 arena row of the source node
    tgt: torch.Tensor            # [E+1] i32
    weight: torch.Tensor         # [E+1] f32 in [0, 1]
    co: torch.Tensor             # [E+1] i32 co-occurrence count
    last_updated: torch.Tensor   # [E+1] f32
    alive: torch.Tensor          # [E+1] bool
    tenant_id: torch.Tensor      # [E+1] i32 tenant of the owning graph
    written: ClassVar[bool] = False

    @property
    def capacity(self) -> int:
        return self.src.shape[0] - 1


ARENA_FIELDS = tuple(f.name for f in fields(ArenaState))
EDGE_FIELDS = tuple(f.name for f in fields(EdgeState))


def _writes(fn):
    """A program step that writes its state arguments in place: it marks
    every ``ArenaState`` / ``EdgeState`` it is given as written before it
    runs, so a failure from here on reads as a torn state
    (``reliability.guard``)."""
    @functools.wraps(fn)
    def step(*args, **kwargs):
        for a in args:
            if isinstance(a, (ArenaState, EdgeState)):
                a.written = True
        return fn(*args, **kwargs)
    return step


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_arena(capacity: int, dim: int, dtype=torch.float32,
               device="cpu") -> ArenaState:
    n = capacity + 1

    def full(v, dt):
        return torch.full((n,), v, dtype=dt, device=device)

    return ArenaState(
        emb=torch.zeros((n, dim), dtype=dtype, device=device),
        salience=full(0.0, torch.float32),
        timestamp=full(0.0, torch.float32),
        last_accessed=full(0.0, torch.float32),
        access_count=full(0, torch.int32),
        type_id=full(0, torch.int32),
        shard_id=full(-1, torch.int32),
        tenant_id=full(-1, torch.int32),
        alive=full(False, torch.bool),
        is_super=full(False, torch.bool),
    )


def init_edges(capacity: int, device="cpu") -> EdgeState:
    n = capacity + 1

    def full(v, dt):
        return torch.full((n,), v, dtype=dt, device=device)

    return EdgeState(
        src=full(-1, torch.int32),
        tgt=full(-1, torch.int32),
        weight=full(0.0, torch.float32),
        co=full(0, torch.int32),
        last_updated=full(0.0, torch.float32),
        alive=full(False, torch.bool),
        tenant_id=full(-1, torch.int32),
    )


def _grow(fresh, state, names):
    old = state.capacity
    for name in names:
        getattr(fresh, name)[:old] = getattr(state, name)[:old]
    return fresh


def grow_arena(state: ArenaState, new_capacity: int) -> ArenaState:
    """Reallocate at ``new_capacity`` and copy the live rows (rare)."""
    assert new_capacity > state.capacity
    fresh = init_arena(new_capacity, state.dim, state.emb.dtype,
                       state.emb.device)
    return _grow(fresh, state, ARENA_FIELDS)


def grow_edges(state: EdgeState, new_capacity: int) -> EdgeState:
    assert new_capacity > state.capacity
    return _grow(init_edges(new_capacity, state.src.device), state,
                 EDGE_FIELDS)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a numpy array as a tensor on ``device``, bf16 (ml_dtypes)
    included without importing it. Copied, since the state is then updated
    in place."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def arena_from_numpy(cols: Dict[str, np.ndarray], device) -> ArenaState:
    return ArenaState(**{f: _tensor(cols[f], device) for f in ARENA_FIELDS})


def edges_from_numpy(cols: Dict[str, np.ndarray], device) -> EdgeState:
    return EdgeState(**{f: _tensor(cols[f], device) for f in EDGE_FIELDS})


def pad_rows(rows: np.ndarray, sentinel: int, min_bucket: int = 8) -> np.ndarray:
    """Pad an int row-index vector with the sentinel row to a size bucket:
    powers of two up to 4096, then multiples of 1024 (the JAX package's
    buckets, kept so both packages write the same scratch positions)."""
    n = len(rows)
    if n > 4096:
        bucket = -(-n // 1024) * 1024
    else:
        bucket = max(min_bucket, 1 << (max(1, n - 1)).bit_length())
    out = np.full((bucket,), sentinel, np.int32)
    out[:n] = rows
    return out


def normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return (xf / torch.clamp(n, min=1e-9)).to(x.dtype)


def _rows(rows, device) -> torch.Tensor:
    return torch.as_tensor(rows, device=device).long()


# ---------------------------------------------------------------------------
# Arena mutations (in place; each returns the state it was given)
# ---------------------------------------------------------------------------


@_writes
def _arena_add(state: ArenaState, rows, emb, salience, timestamp, type_id,
               shard_id, tenant_id, is_super) -> ArenaState:
    dev = state.emb.device
    r = _rows(rows, dev)
    state.emb[r] = normalize(torch.as_tensor(emb, device=dev).float()).to(
        state.emb.dtype)
    ts = torch.as_tensor(timestamp, dtype=torch.float32, device=dev)
    state.salience[r] = torch.as_tensor(salience, dtype=torch.float32, device=dev)
    state.timestamp[r] = ts
    state.last_accessed[r] = ts
    state.access_count.index_fill_(0, r, 0)
    state.type_id[r] = torch.as_tensor(type_id, dtype=torch.int32, device=dev)
    state.shard_id[r] = torch.as_tensor(shard_id, dtype=torch.int32, device=dev)
    state.tenant_id[r] = torch.as_tensor(tenant_id, dtype=torch.int32, device=dev)
    state.alive.index_fill_(0, r, True)
    state.is_super[r] = torch.as_tensor(is_super, dtype=torch.bool, device=dev)
    return state


@_writes
def _arena_delete(state: ArenaState, rows) -> ArenaState:
    r = _rows(rows, state.emb.device)
    state.alive[r] = False
    state.tenant_id[r] = -1
    return state


@_writes
def _arena_update_access(state: ArenaState, rows, now, boost,
                         cap_salience: float = 1.0) -> ArenaState:
    """access_count += 1, salience += boost (capped), last_accessed = now."""
    dev = state.emb.device
    r = _rows(rows, dev)
    state.salience.index_put_((r,), _f32(boost, dev).expand(r.shape[0]),
                              accumulate=True)
    torch.clamp_(state.salience, max=cap_salience)
    state.access_count.index_put_(
        (r,), torch.ones_like(r, dtype=torch.int32), accumulate=True)
    state.last_accessed[r] = _f32(now, dev)
    return state


@_writes
def _arena_boost(state: ArenaState, rows, now, boost) -> ArenaState:
    """Neighbor boost: salience += boost (cap 1.0), last_accessed = now, no
    access_count bump."""
    dev = state.emb.device
    r = _rows(rows, dev)
    state.salience.index_put_((r,), _f32(boost, dev).expand(r.shape[0]),
                              accumulate=True)
    torch.clamp_(state.salience, max=1.0)
    state.last_accessed[r] = _f32(now, dev)
    return state


@_writes
def _arena_merge_touch(state: ArenaState, rows, candidate_salience,
                       now) -> ArenaState:
    """Dedup merge: salience = max(salience, candidate), access_count += 1,
    last_accessed = now."""
    dev = state.emb.device
    r = _rows(rows, dev)
    state.salience.scatter_reduce_(
        0, r, torch.as_tensor(candidate_salience, dtype=torch.float32,
                              device=dev), reduce="amax")
    state.access_count.index_put_(
        (r,), torch.ones_like(r, dtype=torch.int32), accumulate=True)
    state.last_accessed[r] = _f32(now, dev)
    return state


@_writes
def _arena_set_salience(state: ArenaState, rows, values) -> ArenaState:
    dev = state.emb.device
    state.salience[_rows(rows, dev)] = torch.as_tensor(
        values, dtype=torch.float32, device=dev)
    return state


@_writes
def _arena_set_parentage(state: ArenaState, rows, is_super) -> ArenaState:
    dev = state.emb.device
    state.is_super[_rows(rows, dev)] = torch.as_tensor(
        is_super, dtype=torch.bool, device=dev)
    return state


@_writes
def _arena_apply_boosts(state: ArenaState, rows, acc_cnt, nbr_cnt, now_vals,
                        acc_boost, nbr_boost) -> ArenaState:
    """Deferred boost flush: summed (access, neighbor) counts of many
    cache-hit turns in one scatter; padding rows carry ``-inf`` times."""
    dev = state.emb.device
    r = _rows(rows, dev)
    acc = torch.as_tensor(acc_cnt, dtype=torch.int32, device=dev)
    nbr = torch.as_tensor(nbr_cnt, dtype=torch.int32, device=dev)
    add = acc.float() * _f32(acc_boost, dev) + nbr.float() * _f32(nbr_boost, dev)
    state.salience.index_put_((r,), add, accumulate=True)
    torch.clamp_(state.salience, max=1.0)
    state.access_count.index_put_((r,), acc, accumulate=True)
    state.last_accessed.scatter_reduce_(
        0, r, torch.as_tensor(now_vals, dtype=torch.float32, device=dev),
        reduce="amax")
    return state


@_writes
def _arena_restore_access(state: ArenaState, rows, access_count,
                          last_accessed) -> ArenaState:
    """Reload path: ``_arena_add`` zeroes the access history of a fresh
    row; a restored row gets its persisted counters back, so eviction keeps
    ranking by use across restarts."""
    dev = state.emb.device
    r = _rows(rows, dev)
    state.access_count[r] = torch.as_tensor(access_count, dtype=torch.int32,
                                            device=dev)
    state.last_accessed[r] = torch.as_tensor(last_accessed,
                                             dtype=torch.float32, device=dev)
    return state


@_writes
def _arena_decay(state: ArenaState, tenant, rate, floor) -> ArenaState:
    """s' = floor + (s - floor)(1 - rate) on the tenant's live rows, rounded
    once as the JAX package's fused multiply-add rounds it: the f32
    difference and the f32 ``1 - rate`` multiply and add in f64, which holds
    their product exactly, and round to f32 at the end. Eager f32 ops would
    round the product and the sum apart; a reload's replay of missed passes
    (``MemorySystem._replay_node_decay``) rounds once too."""
    dev = state.emb.device
    rate, floor = _f32(rate, dev), _f32(floor, dev)
    s = state.salience
    mask = state.alive & (state.tenant_id == int(tenant))
    torch.where(mask, _decay_step(s, floor, 1.0 - rate), s, out=state.salience)
    return state


def _decay_step(s: torch.Tensor, floor: torch.Tensor, factor: torch.Tensor
                ) -> torch.Tensor:
    """One decay pass, ``floor + (s - floor) * factor`` rounded once: the
    f32 difference and the f32 factor multiply and add in f64 and round to
    f32 at the end (:func:`_arena_decay`)."""
    return (floor.double() + (s - floor).double() * factor.double()).float()


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 operands with one rounding, as a fused
    multiply-add rounds it (XLA's CPU backend contracts the JAX package's
    multiply-adds into them). The product is exact in f64; the f64 sum is
    rounded to odd (its error from a two-sum, the last bit made odd where
    the sum was inexact), so rounding it to f32 gives the correctly rounded
    result with no double rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.float()


# ---------------------------------------------------------------------------
# Retrieval and scoring
# ---------------------------------------------------------------------------


def arena_mask(state: ArenaState, tenant, super_filter: int = 0) -> torch.Tensor:
    """alive ∧ tenant ∧ super-node filter (1: only super, -1: no super)."""
    mask = state.alive & (state.tenant_id == int(tenant))
    if super_filter == 1:
        mask = mask & state.is_super
    elif super_filter == -1:
        mask = mask & ~state.is_super
    return mask


def arena_search(state: ArenaState, query: torch.Tensor, tenant, k: int,
                 super_filter: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k over the whole arena (``state.py:719`` with
    ``impl="auto"``): on a CUDA arena always the Hopper kernel, any row
    count, any batch, any k up to the row count. Returns ``(scores, rows)``
    shaped like the query's batch dims."""
    q = normalize(torch.atleast_2d(query).float()).to(state.emb.dtype)
    top_s, top_r = masked_topk(state.emb, arena_mask(state, tenant, super_filter),
                               q, k)
    if query.ndim == 1:
        return top_s[0], top_r[0]
    return top_s, top_r


def arena_link_candidates_multi(state: ArenaState, new_rows, excl_rows,
                                tenant, k: int,
                                shard_modes: Tuple[int, ...] = (1, 0)):
    """For each new row, the top-k most similar live non-super rows of the
    tenant (excluding ``excl_rows``) under each shard mode (0 any shard,
    1 same shard, -1 other shards), every mode a mask over one scan of the
    arena (:func:`_ingest_scan_core` without the probe). Returns ``(scores,
    rows)`` pairs flattened in ``shard_modes`` order."""
    r = _rows(new_rows, state.emb.device)
    return arena_link_scan(state, state.emb[r], state.shard_id[r], excl_rows,
                           tenant, k, shard_modes)


def arena_link_scan(state: ArenaState, q_emb: torch.Tensor,
                    q_shard: torch.Tensor, excl_rows, tenant, k: int,
                    shard_modes: Tuple[int, ...] = (1, 0)):
    """:func:`arena_link_candidates_multi` for query rows given by value
    (``q_emb [B, d]``, ``q_shard [B]`` their shard ids): under a mesh each
    shard scans its own rows for new rows that may live on another shard.
    ``excl_rows`` are rows of ``state``."""
    excl = torch.zeros_like(state.alive)
    excl[_rows(excl_rows, state.emb.device)] = True
    return _ingest_scan_core(state, q_emb, q_shard, torch.zeros_like(excl),
                             excl, int(tenant), k, shard_modes,
                             with_probe=False)


def _ingest_scan_core(state: ArenaState, qd: torch.Tensor,
                      q_shard: torch.Tensor, probe_excl: torch.Tensor,
                      link_excl: torch.Tensor, tenant: int, k: int,
                      shard_modes: Tuple[int, ...], with_probe: bool = True):
    """The whole-arena ingest scan (``state.py:_ingest_scan_core``): the
    dedup-probe top-1 over the tenant's live non-super rows less
    ``probe_excl`` and, per shard mode, the link top-k over those less
    ``link_excl``, from one pass over the arena (``ops.ingest_topk``, the
    Hopper kernel on a CUDA arena). ``qd [B, d]`` is each fact's normalized
    embedding in the arena dtype (the bytes the node scatter stores). Returns
    the flat tuple ``(p_s [B, 1], p_r [B, 1], s_mode, r_mode, ...)``, rows
    i32; ``with_probe=False`` leaves out the probe pair."""
    return ingest_topk(state.emb, state.alive, state.tenant_id, state.is_super,
                       state.shard_id, probe_excl, link_excl,
                       qd.to(state.emb.dtype), q_shard, int(tenant), k,
                       shard_modes, with_probe)


def best_earlier_match(m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of a fact batch ``m [B, d]``, the most similar EARLIER
    row: ``(cols [B], sims [B])`` by cosine (zero rows count as norm 1), the
    first column on ties, ``(0, -inf)`` for row 0 (the host gram matrix of
    ``lazzaro_tpu/core/memory_system.py:1462-1474``, on the device)."""
    m = m.float()
    norms = torch.linalg.vector_norm(m, dim=1, keepdim=True)
    m = m / torch.where(norms == 0, torch.ones_like(norms), norms)
    gram = torch.matmul(m, m.t())
    lower = torch.ones_like(gram, dtype=torch.bool).tril(-1)
    gram = torch.where(lower, gram, _f32(float("-inf"), m.device))
    cols = torch.argmax(gram, dim=1)
    return cols, torch.gather(gram, 1, cols[:, None])[:, 0]


def arena_importance(state: ArenaState, now, w_sal, w_acc, w_rec) -> torch.Tensor:
    """importance = salience*w1 + min(1, access/10)*w2 + 1/(1+days_old)*w3,
    +inf for dead rows, to the JAX program's bits: its compiled form
    divides by multiplying with the f32 reciprocals of 86,400 and 10 and
    fuses three multiply-adds, ``1 + days_old = fma(age, 1/86400, 1)`` and
    ``fma(1/(1 + days_old), w3, fma(salience, w1, min(1, access/10)*w2))``
    (:func:`_fma`)."""
    dev = state.emb.device
    now, w_sal, w_acc, w_rec = (_f32(v, dev) for v in (now, w_sal, w_acc, w_rec))
    age = torch.clamp(now - state.last_accessed, min=0.0)
    recency = 1.0 / _fma(age, _f32(1.0 / 86400.0, dev), _f32(1.0, dev))
    access = torch.clamp(state.access_count.float() * _f32(0.1, dev), max=1.0)
    imp = _fma(recency, w_rec, _fma(state.salience, w_sal, access * w_acc))
    return torch.where(state.alive, imp, _f32(float("inf"), dev))


def arena_evict_candidates(state: ArenaState, tenant, now, w_sal, w_acc, w_rec,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(importance, rows) of the k least-important live non-super rows of a
    tenant, least important first (ties to the lowest row)."""
    imp = arena_importance(state, now, w_sal, w_acc, w_rec)
    mask = state.alive & (state.tenant_id == int(tenant)) & ~state.is_super
    imp = torch.where(mask, imp, _f32(float("inf"), imp.device))
    neg_scores, rows = stable_topk(-imp, k)
    return -neg_scores, rows


def arena_mean_embedding(state: ArenaState, rows) -> torch.Tensor:
    """Normalized mean of the given rows' embeddings (super-node centroid);
    sentinel-padded rows weigh zero."""
    r = _rows(rows, state.emb.device)
    valid = (r < state.capacity)[:, None].float()
    embs = state.emb[r].float() * valid
    return normalize(embs.sum(0) / torch.clamp(valid.sum(), min=1.0))


# ---------------------------------------------------------------------------
# Edge arena
# ---------------------------------------------------------------------------


@_writes
def _edges_add(state: EdgeState, slots, src, tgt, weight, co, now, tenant,
               live) -> EdgeState:
    """``live`` is False on sentinel-padded positions, so the scratch slot
    never becomes a live phantom edge."""
    dev = state.src.device
    s = _rows(slots, dev)
    state.src[s] = torch.as_tensor(src, dtype=torch.int32, device=dev)
    state.tgt[s] = torch.as_tensor(tgt, dtype=torch.int32, device=dev)
    state.weight[s] = torch.clamp(
        torch.as_tensor(weight, dtype=torch.float32, device=dev), 0.0, 1.0)
    state.co[s] = torch.as_tensor(co, dtype=torch.int32, device=dev)
    state.last_updated[s] = _f32(now, dev)
    state.alive[s] = torch.as_tensor(live, dtype=torch.bool, device=dev)
    state.tenant_id.index_fill_(0, s, int(tenant))
    return state


@_writes
def _edges_reinforce(state: EdgeState, slots, bump, now) -> EdgeState:
    """weight += bump (cap 1.0), co += 1, last_updated = now."""
    dev = state.src.device
    s = _rows(slots, dev)
    state.weight.index_put_((s,), _f32(bump, dev).expand(s.shape[0]),
                            accumulate=True)
    torch.clamp_(state.weight, max=1.0)
    state.co.index_put_((s,), torch.ones_like(s, dtype=torch.int32),
                        accumulate=True)
    state.last_updated[s] = _f32(now, dev)
    return state


@_writes
def _edges_decay(state: EdgeState, tenant, rate) -> EdgeState:
    """weight *= (1 - rate) on the tenant's live edges."""
    rate = _f32(rate, state.src.device)
    mask = state.alive & (state.tenant_id == int(tenant))
    torch.where(mask, state.weight * (1.0 - rate), state.weight,
                out=state.weight)
    return state


def _prune_compact(weak: torch.Tensor, prune_cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix-sum compaction of a weak-edge mask into ``[prune_cap]`` slot
    indices (ascending, -1 padded). Returns ``(ok, slots)``; ``ok`` is the
    mask of edges that fit (all of ``weak`` when the cap covers it)."""
    pos = torch.cumsum(weak.int(), 0) - 1
    ok = weak & (pos < prune_cap)
    buf = torch.full((prune_cap + 1,), -1, dtype=torch.int32, device=weak.device)
    where = torch.where(ok, torch.clamp(pos, max=prune_cap - 1), prune_cap)
    buf[where.long()] = torch.arange(weak.shape[0], dtype=torch.int32,
                                     device=weak.device)
    return ok, buf[:prune_cap]


@_writes
def _edges_prune(state: EdgeState, tenant, threshold, prune_cap: int
                 ) -> Tuple[EdgeState, torch.Tensor]:
    """Kill the tenant's live edges with weight < threshold; returns
    ``(state, pruned_slots)`` from :func:`_prune_compact`."""
    weak = (state.alive & (state.tenant_id == int(tenant))
            & (state.weight < _f32(threshold, state.src.device)))
    ok, slots = _prune_compact(weak, prune_cap)
    state.alive &= ~ok
    return state, slots


def _decay_fused(arena: ArenaState, edges: EdgeState, tenant, rate, floor
                 ) -> Tuple[ArenaState, EdgeState]:
    """Per-tenant decay of arena salience and edge weights together."""
    return (_arena_decay(arena, tenant, rate, floor),
            _edges_decay(edges, tenant, rate))


@_writes
def _edges_delete_for_nodes(state: EdgeState, node_rows) -> EdgeState:
    """Kill every edge touching one of ``node_rows`` (eviction cleanup)."""
    r = torch.as_tensor(node_rows, device=state.src.device).int()
    state.alive &= ~(torch.isin(state.src, r) | torch.isin(state.tgt, r))
    return state


# ---------------------------------------------------------------------------
# Lifecycle: decay, weak-edge prune and archive verdicts of every tenant as
# one run of device work with one packed readback (``state.py:
# _lifecycle_core`` / ``_lifecycle_sweep`` / ``make_lifecycle_sharded``),
# plain torch in place: XLA computes it outside any Pallas kernel, once per
# maintenance tick.
# ---------------------------------------------------------------------------

# Counters at the payload's tail: decayed arena rows, decayed edges, pruned
# edges, weak edges (past the cap too), the prune overflow flag.
LIFECYCLE_TAIL = 5

# Entries of one [tenants, rows] importance tile of the verdict bottom-k: a
# sweep of many tenants over a large arena takes its tenants in groups.
_VERDICT_TILE = 1 << 26


def _owed(passes: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """Each row's owed decay passes, gathered from the dense ``[Tc]`` table
    by its tenant id (0 for ids outside it, the free rows' -1 among them)."""
    tc = passes.shape[0]
    inb = (tid >= 0) & (tid < tc)
    return torch.where(inb, passes[torch.clamp(tid, 0, tc - 1).long()], 0)


@_writes
def _lifecycle_arena(arena: ArenaState, passes, verdict_tids, rate, floor,
                     now, w_sal, w_acc, w_rec, archive_k: int):
    """The arena half of the sweep, in place: the owed salience decay of
    every swept tenant's live rows (one pass: :func:`_decay_step`, the
    classic decay's bits; ``p > 1`` passes: the closed form ``floor + (s -
    floor) * (1 - rate) ** p``), then each verdict tenant's ``archive_k``
    live non-super rows of least importance on the decayed salience
    (ties to the lower row; a -1 tenant id pads and yields +inf). Returns
    ``(importance [Tv, k], rows [Tv, k] i64, decayed rows 0-d i32)``."""
    dev = arena.emb.device
    rate, floor = _f32(rate, dev), _f32(floor, dev)
    factor = 1.0 - rate
    p = _owed(passes, arena.tenant_id)
    d_mask = arena.alive & (p > 0)
    s = arena.salience
    closed = _fma(s - floor, torch.pow(factor, p.float()), floor)
    torch.where(d_mask, torch.where(p == 1, _decay_step(s, floor, factor),
                                    closed), s, out=arena.salience)
    imp = arena_importance(arena, now, w_sal, w_acc, w_rec)
    live = arena.alive & ~arena.is_super
    inf = _f32(float("inf"), dev)
    step = max(1, _VERDICT_TILE // imp.shape[0])
    neg, rows = [], []
    for t in verdict_tids.split(step):
        mask = (live[None, :] & (arena.tenant_id[None, :] == t[:, None])
                & (t[:, None] >= 0))
        n_t, r_t = stable_topk(-torch.where(mask, imp[None, :], inf), archive_k)
        neg.append(n_t)
        rows.append(r_t)
    return -torch.cat(neg), torch.cat(rows), d_mask.sum(dtype=torch.int32)


@_writes
def _lifecycle_edges(edges: EdgeState, passes, rate, threshold,
                     prune_cap: int):
    """The edge half, in place: the owed weight decay (``w * (1 - rate)``,
    ``(1 - rate) ** p`` for ``p > 1``), then the weak-edge prune on the
    decayed weights (:func:`_prune_compact`). Returns ``(pruned slots
    [prune_cap] i32, counters [4] i32)``: decayed edges, pruned edges, weak
    edges, overflow."""
    dev = edges.src.device
    factor = 1.0 - _f32(rate, dev)
    ep = _owed(passes, edges.tenant_id)
    e_mask = edges.alive & (ep > 0)
    w = edges.weight
    w_new = torch.where(e_mask, torch.where(
        ep == 1, w * factor, w * torch.pow(factor, ep.float())), w)
    weak = e_mask & (w_new < _f32(threshold, dev))
    ok, slots = _prune_compact(weak, prune_cap)
    edges.weight.copy_(w_new)
    edges.alive &= ~ok
    counts = torch.stack([e_mask.sum(dtype=torch.int32),
                          ok.sum(dtype=torch.int32),
                          weak.sum(dtype=torch.int32),
                          (weak & ~ok).any().int()])
    return slots, counts


def _lifecycle_payload(v_imps, v_rows, pruned_slots, counters) -> torch.Tensor:
    """The sweep's ONE flat f32 readback: ``[Tv * k]`` verdict importances
    | ``[Tv * k]`` verdict rows | ``[prune_cap]`` pruned slots |
    ``[LIFECYCLE_TAIL]`` counters, the int sections bit-cast."""
    return torch.cat([v_imps.float().reshape(-1), _bitcast(v_rows).reshape(-1),
                      _bitcast(pruned_slots), _bitcast(counters)])


def lifecycle_sweep(arena: ArenaState, edges: EdgeState, passes,
                    verdict_tids, rate, floor, threshold, now, w_sal, w_acc,
                    w_rec, prune_cap: int, archive_k: int):
    """Salience decay, edge decay and weak-edge prune, and each verdict
    tenant's bottom-``archive_k`` importance verdicts over the whole arena
    and edge pool, in place (``state.py:lifecycle_sweep``; the JAX donated
    and copy twins are one function here). ``passes [Tc]`` i32 is the owed
    passes by tenant id, ``verdict_tids [Tv]`` the verdict tenants (-1
    padded). Returns ``(arena, edges, payload)`` (:func:`_lifecycle_payload`)."""
    v_imps, v_rows, n_rows = _lifecycle_arena(
        arena, passes, verdict_tids, rate, floor, now, w_sal, w_acc, w_rec,
        archive_k)
    slots, counts = _lifecycle_edges(edges, passes, rate, threshold, prune_cap)
    return arena, edges, _lifecycle_payload(v_imps, v_rows, slots,
                                            torch.cat([n_rows[None], counts]))


def lifecycle_sweep_read(arena: ArenaState, edges: EdgeState, passes,
                         verdict_tids, rate, floor, threshold, now, w_sal,
                         w_acc, w_rec, prune_cap: int, archive_k: int
                         ) -> torch.Tensor:
    """Read-only twin: the payload of :func:`lifecycle_sweep` run on copies
    of the columns it writes; the states are untouched."""
    arena = replace(arena, salience=arena.salience.clone())
    edges = replace(edges, weight=edges.weight.clone(),
                    alive=edges.alive.clone())
    return lifecycle_sweep(arena, edges, passes, verdict_tids, rate, floor,
                           threshold, now, w_sal, w_acc, w_rec, prune_cap,
                           archive_k)[2]


def lifecycle_sweep_sharded(shards: List[ArenaState], edges: EdgeState,
                            passes, verdict_tids, rate, floor, threshold, now,
                            w_sal, w_acc, w_rec, prune_cap: int,
                            archive_k: int) -> torch.Tensor:
    """:func:`lifecycle_sweep` over the row-sharded arena
    (``state.py:make_lifecycle_sharded``), in place: each shard decays its
    rows and takes its local bottom-``archive_k`` (``min(archive_k, L)``),
    and ONE :func:`sharded_merge` over the negated importances joins them
    (global rows ``local + p * L``, ties to the lower shard, masked entries
    on the global sentinel); the edge arena, whole on the first shard's
    device, decays and prunes once. Returns the payload of the
    single-device sweep on that device."""
    local_n = shards[0].salience.shape[0]
    dev0 = edges.src.device
    k_l = min(archive_k, local_n)
    parts = [_lifecycle_arena(st, passes.to(st.emb.device),
                              verdict_tids.to(st.emb.device), rate, floor,
                              now, w_sal, w_acc, w_rec, k_l) for st in shards]
    neg, rows = sharded_merge([-imp for imp, _, _ in parts],
                              [r for _, r, _ in parts], local_n, archive_k,
                              sentinel=len(shards) * local_n - 1, device=dev0)
    n_rows = torch.stack([c.to(dev0) for _, _, c in parts]).sum(dtype=torch.int32)
    slots, counts = _lifecycle_edges(edges, passes, rate, threshold, prune_cap)
    return _lifecycle_payload(-neg, rows, slots, torch.cat([n_rows[None], counts]))


# ---------------------------------------------------------------------------
# Fused ingest: a conversation's (or a mega-batch's) whole mutation sequence
# as one run of device work with one packed readback
# (``state.py:_ingest_fused`` / ``_ingest_dedup_fused``, dense arena, with
# the int8 shadow and the online IVF tables; the PQ and paged arguments are
# not ported). The scan is the ingest kernel (ops.ingest_topk), the resolve
# the dedup kernel (ops.dedup_resolve); the rest is plain torch on the
# device, no step reads a device value back to the host, and the state is
# updated in place.
# ---------------------------------------------------------------------------


def _dedup_resolve(qf: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                   chain_gid: torch.Tensor, p_s: torch.Tensor,
                   p_r: torch.Tensor, dedup_gate: float, cap: int):
    """Duplicate resolution of a fact batch (``state.py:_dedup_resolve``):
    the intra-batch gram ``qf @ qf.T`` (f32, no TF32), then the resolve
    (``ops.dedup_resolve.dedup_resolve_gram``): each fact's best EARLIER
    valid fact in the gram (sentinel padding rows share one unit vector and
    never match; the first column on ties) blended with the pre-add probe
    ``(p_s, p_r)``, targets chained, each live fact's chain predecessor
    found. On a card that is the kernel's two launches over the gram, with
    no ``[B, B]`` mask. Returns ``(target [B] i32, dup [B] bool, chain_src
    [B] i32)``."""
    return dedup_resolve_gram(nt_dot(qf, qf), p_s, p_r, valid, rows,
                              chain_gid, dedup_gate, cap)


@_writes
def _gated_link_insert(edges: EdgeState, link_flat, link_pool: torch.Tensor,
                       pool_len: torch.Tensor, src_rows: torch.Tensor,
                       valid_q: torch.Tensor, now, tenant: int, link_gate,
                       link_scale, shard_modes):
    """Device-gated similarity-edge insert with prefix-sum slot compaction
    (``state.py:_gated_link_insert``): per shard mode the gate verdict (score
    > ``link_gate``, a valid source, not already inserted by an earlier
    mode), then every accepted edge of every mode packed into the head of
    the slot pool ``link_pool [P + 1]`` (last entry: the sentinel slot) by a
    cumulative sum, and one :func:`_edges_add`. An accepted edge past
    ``pool_len`` (a 0-d i32 tensor: the real slots at the pool's head)
    writes the sentinel slot and keeps its true position. Returns ``(edges,
    outs)``: per mode ``(scores, cands, pos)`` (``pos`` -1 where rejected),
    then the overflow flag, the accepted count and the pool slots used,
    each broadcast to ``[B, k]``."""
    pool_cap = link_pool.shape[0] - 1
    per_mode, prior = [], []
    for mi in range(len(shard_modes)):
        scores, cand = link_flat[2 * mi], link_flat[2 * mi + 1]
        live = (scores > link_gate) & valid_q[:, None]
        for p_cand, p_live in prior:
            # an (src, cand) pair an earlier mode already inserted must not
            # become a second live edge (every same-shard candidate is also
            # an any-shard one)
            dup = ((cand[:, :, None] == p_cand[:, None, :])
                   & p_live[:, None, :]).any(-1)
            live = live & ~dup
        prior.append((cand, live))
        per_mode.append((scores, cand, live))
    live_all = torch.cat([lv.reshape(-1) for _, _, lv in per_mode])
    pos_all = torch.cumsum(live_all.int(), 0, dtype=torch.int32) - 1
    room = torch.clamp(pool_len, max=pool_cap)
    ok = live_all & (pos_all < room)
    slots = link_pool[torch.where(ok, torch.clamp(pos_all, max=pool_cap - 1),
                                  pool_cap).long()]
    overflow = (live_all & ~ok).any()
    src_all = torch.cat([src_rows[:, None].expand(c.shape).reshape(-1)
                         for _, c, _ in per_mode])
    cand_all = torch.cat([c.reshape(-1) for _, c, _ in per_mode])
    w_all = torch.cat([(s * link_scale).reshape(-1) for s, _, _ in per_mode])
    _edges_add(edges, slots, src_all, cand_all, w_all,
               torch.ones_like(cand_all, dtype=torch.int32), now, tenant, ok)
    outs = []
    off = 0
    for scores, cand, live in per_mode:
        m = live.numel()
        pos_m = torch.where(live.reshape(-1), pos_all[off:off + m],
                            -1).reshape(live.shape)
        outs.extend((scores, cand, pos_m))
        off += m
    leaf = per_mode[0][2].shape
    accepted = live_all.sum(dtype=torch.int32)
    pool_used = torch.minimum(accepted, room)
    outs.extend(x.expand(leaf) for x in (overflow.int(), accepted, pool_used))
    return edges, tuple(outs)


# Leaves the online IVF update appends to a fused ingest's readback, in
# order: assign, member slot, overflow flag, occupancy, appends, shift ppm
# (``state.py:IVF_INGEST_TAIL``).
IVF_INGEST_TAIL = 6


def _ivf_online_assign(cent: torch.Tensor, qf: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """Each accepted fact's nearest centroid (``state.py:_ivf_online_assign``):
    the arg-max of its f32 scores, ties to the lowest id; a dead or padded
    fact goes to bucket C, one past the end. ``[B]`` i64."""
    assign = torch.argmax(nt_dot(qf, cent), dim=1)
    return torch.where(live, assign, cent.shape[0])


def _ivf_online_update(ivf, rows: torch.Tensor, qf: torch.Tensor,
                       live: torch.Tensor, eta_scale):
    """Online IVF upkeep inside a fused ingest (``state.py:
    _ivf_online_update``), in place on ``ivf = (cent [C, d] f32, members [C,
    M] i32, counts [C] i32)``: each live fact's cluster, its append slot
    (the cluster's occupancy plus its rank among the batch's earlier facts
    of that cluster; a slot past the cluster's capacity writes nothing and
    reports -1, so the host puts the row in the exact-scan extras), the
    member writes and the counts, then one mini-batch spherical k-means
    step, ``cent_c <- normalize((1 - eta_c) cent_c + eta_c mean_c)`` with
    ``eta_c = eta_scale * b_c / max(count_c + b_c, 1)``. The rank is a
    stable sort by cluster, the batch's prefix count of equal clusters
    without the ``[B, B]`` tile; the cluster sums are :func:`ops.ivf.
    segment_sum`, in row order. Returns ``(assign [B] (-1 dead), pos [B]
    (-1 overflowed or dead), tail)``, ``tail`` the overflow flag, the
    occupancy, the appends and the centroids' drift in parts per million
    of cosine, as 0-d i32."""
    cent, members, counts = ivf
    n_c, m_w = members.shape
    b = rows.shape[0]
    dev = qf.device
    a = _ivf_online_assign(cent, qf, live)
    assign = torch.where(live, a, -1)
    order = torch.sort(a, stable=True).indices
    sa = a[order]
    rank = torch.empty_like(a)
    rank[order] = (torch.arange(b, device=dev)
                   - torch.searchsorted(sa, sa, right=False))
    counts_pre = counts.clone()
    pos = torch.where(live, counts_pre[torch.where(live, a, 0)] + rank, -1)
    ok = live & (pos >= 0) & (pos < m_w)
    # An append slot is empty (-1) until written, so the row is its max; a
    # rejected fact writes -1, which changes nothing.
    members.view(-1).scatter_reduce_(
        0, torch.where(ok, a * m_w + pos, 0),
        torch.where(ok, rows.int(), -1), reduce="amax")
    counts.index_add_(0, torch.where(ok, a, 0), ok.int())
    # Overflowed facts still count toward the mean: they are cluster mass.
    sums = segment_sum(n_c + 1, a, torch.where(live[:, None], qf, 0.0))[:n_c]
    bc = segment_sum(n_c + 1, a, live.float())[:n_c]
    tot = counts_pre.float()
    eta = torch.clamp(eta_scale * bc / torch.clamp(tot + bc, min=1.0), 0.0, 1.0)
    mean = sums / torch.clamp(bc[:, None], min=1.0)
    prop = cent * (1.0 - eta[:, None]) + mean * eta[:, None]
    nrm = torch.linalg.vector_norm(prop, dim=1, keepdim=True)
    moved = (bc[:, None] > 0) & (nrm > 1e-9)
    new_cent = torch.where(moved, prop / torch.clamp(nrm, min=1e-9), cent)
    shift = torch.where(bc > 0, 1.0 - (new_cent * cent).sum(dim=1), 0.0)
    cent.copy_(new_cent)
    tail = ((live & ~ok).any().int(),
            torch.clamp(counts.sum(), max=n_c * m_w).int(),
            ok.sum().int(),
            torch.clamp(torch.round(shift.sum() * 1e6), 0, 2 ** 30).int())
    return assign.int(), torch.where(ok, pos, -1).int(), tail


def _ivf_tail(ivf, rows, emb, live, eta, leaf) -> tuple:
    """The online update of the ingest's written rows and its readback
    leaves broadcast to ``leaf`` (``()`` without tables)."""
    if ivf is None:
        return ()
    a_rb, p_rb, tail = _ivf_online_update(ivf, rows, normalize(emb.float()),
                                          live, eta)
    return (tuple(x[:, None].expand(leaf) for x in (a_rb, p_rb))
            + tuple(t.expand(leaf) for t in tail))


def ingest_fused(arena: ArenaState, edges: EdgeState, rows, emb, salience,
                 timestamp, type_id, shard_id, tenant_id, is_super, touch_rows,
                 touch_sal, chain_slots, chain_src, chain_tgt, chain_w,
                 link_pool, pool_len, now, tenant: int, link_gate, link_scale,
                 k: int, shard_modes: Tuple[int, ...] = (1, 0), shadow=None,
                 ivf=None, ivf_eta=1.0):
    """The per-conversation ingest sequence (``state.py:_ingest_fused``):
    node scatter, merge touch, the link scan of the new rows (the batch's
    rows excluded), the chain edges and the gated link insert, in place;
    with the int8 serving ``shadow`` (``(codes, scales)``) the written rows'
    codes too (:func:`_shadow_scatter`), and with the online IVF tables
    ``ivf`` (``(cent, members, counts)``) the rows' cluster appends and the
    centroid step (:func:`_ivf_online_update`, scale ``ivf_eta``), whose
    ``IVF_INGEST_TAIL`` leaves trail the outputs.
    Every argument but ``tenant`` (a host int) and the statics is device
    data: ``rows [B]`` sentinel-padded, ``emb [B, d]``, the ``[B]`` columns,
    ``touch_rows/touch_sal [M]``, the chain ``[C]`` columns (``chain_src``
    -1 on padding), ``link_pool [P + 1]``, ``pool_len`` and the 0-d scalars.
    Returns ``(arena, edges, outs)``, ``outs`` as :func:`_gated_link_insert`
    gives them."""
    valid_q = rows < arena.capacity        # sentinel padding makes no edges
    _arena_add(arena, rows, emb, salience, timestamp, type_id, shard_id,
               tenant_id, is_super)
    _shadow_scatter(shadow, arena, rows)
    _arena_merge_touch(arena, touch_rows, touch_sal, now)
    link_flat = arena_link_candidates_multi(arena, rows, rows, tenant, k,
                                            shard_modes)
    _edges_add(edges, chain_slots, chain_src, chain_tgt, chain_w,
               torch.ones_like(chain_src), now, tenant, chain_src >= 0)
    edges, outs = _gated_link_insert(edges, link_flat, link_pool, pool_len,
                                     rows, valid_q, now, tenant, link_gate,
                                     link_scale, shard_modes)
    outs = outs + _ivf_tail(ivf, rows, emb, valid_q, ivf_eta, outs[0].shape)
    return arena, edges, outs


def ingest_dedup_fused(arena: ArenaState, edges: EdgeState, rows, emb,
                       salience, timestamp, type_id, shard_id, tenant_id,
                       is_super, chain_gid, chain_slots, link_pool, pool_len,
                       now, tenant: int, dedup_gate: float, chain_w,
                       link_gate, link_scale, k: int,
                       shard_modes: Tuple[int, ...] = (1, 0), shadow=None,
                       ivf=None, ivf_eta=1.0):
    """:func:`ingest_fused` with the dedup probe inside
    (``state.py:_ingest_dedup_fused``): one ingest scan of the PRE-add arena
    gives each fact's probe top-1 (sentinel row excluded) and its link
    candidates (the batch's rows excluded, so the pre-add scan is the
    post-add one), the resolve decides duplicates against the probe and the
    intra-batch gram, duplicate facts scatter to the sentinel row while
    their targets take the merge touch, and chain edges link consecutive
    LIVE facts of each shard group ``chain_gid [B]`` (-1 padding) through
    ``chain_slots [B]``. ``dedup_gate`` is a host float (> 1 disables
    dedup). With the online IVF tables ``ivf`` the surviving facts append to
    their clusters (duplicates never do). Returns ``(arena, edges, outs)``:
    ``(dup, target, chain_src)`` broadcast to ``[B, k]``, then the outputs
    of :func:`_gated_link_insert`, then the ``IVF_INGEST_TAIL`` leaves
    when ``ivf`` is given."""
    cap = arena.capacity
    b = rows.shape[0]
    dev = arena.emb.device
    valid = rows < cap
    qf = normalize(emb.float())            # f32: the intra-batch gram
    qd = qf.to(arena.emb.dtype)            # arena dtype: the probe
    probe_excl = torch.arange(cap + 1, device=dev) == cap
    link_excl = probe_excl.index_fill(0, rows.long(), True)
    flat = _ingest_scan_core(arena, qd, shard_id, probe_excl, link_excl,
                             tenant, k, shard_modes)
    p_s, p_r = flat[0][:, 0], flat[1][:, 0]
    target, dup, chain_src = _dedup_resolve(qf, rows, valid, chain_gid, p_s,
                                            p_r, dedup_gate, cap)
    live_new = valid & ~dup
    add_rows = torch.where(live_new, rows, cap)
    _arena_add(arena, add_rows, emb, salience, timestamp, type_id, shard_id,
               tenant_id, is_super)
    _shadow_scatter(shadow, arena, add_rows)
    # The duplicates' scatter lands on the sentinel row (alive, their
    # tenant): its tenant goes back to -1, so that no scan of a tenant
    # lists it. (The JAX program leaves it there, where serving then lists
    # it and the decode drops it: k - 1 results; ROADMAP Queue 3.)
    arena.tenant_id[cap:].fill_(-1)
    _arena_merge_touch(arena, torch.where(dup, target, cap), salience, now)
    _edges_add(edges, chain_slots, chain_src, rows, chain_w.expand(b),
               torch.ones_like(rows), now, tenant, chain_src >= 0)
    edges, outs = _gated_link_insert(edges, flat[2:], link_pool, pool_len,
                                     rows, live_new, now, tenant, link_gate,
                                     link_scale, shard_modes)
    outs = outs + _ivf_tail(ivf, rows, emb, live_new, ivf_eta, (b, k))
    wide = tuple(x[:, None].expand(b, k) for x in (dup.int(), target, chain_src))
    return arena, edges, wide + outs


def _shadow_scatter(shadow, arena: ArenaState, rows) -> None:
    """Keep the int8 serving shadow fresh inside the fused ingest
    (``state.py:_shadow_scatter``): quantize exactly the rows the node
    scatter wrote, as the arena now stores them, and write their codes and
    scales in place. Quantizing the stored rows (not the batch) keeps a
    row that the padding scatters to more than once equal to
    ``quantize_rows`` of the arena. ``shadow`` is ``(codes [cap+1, d] i8,
    scales [cap+1] f32)`` or None (int8 serving off, or no shadow to
    maintain)."""
    if shadow is None:
        return
    codes, scales = shadow
    r = _rows(rows, codes.device)
    q_new, s_new = quantize_rows(arena.emb[r])
    codes[r] = q_new
    scales[r] = s_new


def pack_leaves(leaves) -> torch.Tensor:
    """Same-shape f32 and i32 leaves as one ``[L, ...]`` f32 tensor for ONE
    device-to-host copy (``lazzaro_tpu/utils/batching.py:fetch_packed``):
    int leaves are bit-cast, not converted; :func:`unpack_leaves` undoes
    it."""
    return torch.stack([x.contiguous() if x.dtype == torch.float32
                        else _bitcast(x) for x in leaves])


def unpack_leaves(host: np.ndarray, is_float) -> List[np.ndarray]:
    """The host leaves of a :func:`pack_leaves` array, int ones viewed back
    as i32 (``is_float[i]`` says which were floats)."""
    return [host[i] if f else host[i].view(np.int32)
            for i, f in enumerate(is_float)]


# ---------------------------------------------------------------------------
# Fused retrieval: the per-chat-turn serving sequence (super-node gate,
# main-arena ANN, CSR neighbor gather, neighbor and access boosts) as one
# run of device work with one packed readback. The arena scan is the
# two-tier kernel (ops.fused_topk); the rest is plain torch on the device,
# and no step reads a device value back to the host.
# ---------------------------------------------------------------------------

def _scalar(x, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``, made by a fill, not a host copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _csr_neighbor_rows(state: ArenaState, csr_indptr: torch.Tensor,
                       csr_nbr: torch.Tensor, acc_rows: torch.Tensor,
                       tenant_c: torch.Tensor, max_nbr: int) -> torch.Tensor:
    """CSR neighbor gather of the access-boosted rows, deduplicated per
    query (``state.py:_csr_neighbor_rows``): a neighbor counts once per
    query, never when it was itself retrieved, and only when it is a live
    row of the query's tenant; everything else becomes the sentinel row.
    ``[Q, cap_take * max_nbr]`` i32. The sentinel row's CSR slice is empty,
    so masked entries gather nothing."""
    cap = state.capacity
    dev = acc_rows.device
    acc = acc_rows.long()
    start = csr_indptr[acc]
    end = csr_indptr[acc + 1]
    idx = start[:, :, None] + torch.arange(max_nbr, device=dev,
                                           dtype=start.dtype)[None, None, :]
    ok = idx < end[:, :, None]
    gathered = csr_nbr[torch.clamp(idx, max=csr_nbr.shape[0] - 1).long()]
    nbr = torch.where(ok, gathered, -1)
    flat = nbr.reshape(nbr.shape[0], -1)
    m = flat.shape[1]
    safe = torch.clamp(flat, min=0).long()
    valid_n = ((flat >= 0) & state.alive[safe]
               & (state.tenant_id[safe] == tenant_c[:, None]))
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    dup = ((flat[:, :, None] == flat[:, None, :]) & earlier[None]).any(-1)
    in_res = (flat[:, :, None] == acc_rows[:, None, :]).any(-1)
    return torch.where(valid_n & ~dup & ~in_res, flat, cap).int()


def _gate_and_boost_rows(state: ArenaState, csr_indptr, csr_nbr, gate_s,
                         ann_s, ann_r, valid_c, tenant_c, gate_c, boost_c,
                         super_gate, cap_take: int, max_nbr: int, cap_c=None):
    """The tail after the top-k (``state.py:_gate_and_boost_rows``): the
    gate verdict on the device (where it fires the host serves the super
    node's children and pays classic boosts, so the device boosts nothing
    for that query), the access-boost rows (the first ``cap_take`` live ANN
    rows, or the query's own ``cap_c``) and their CSR neighbors."""
    cap = state.capacity
    fast = gate_c & (gate_s > super_gate)
    do_boost = boost_c & valid_c & ~fast
    take = (ann_s[:, :cap_take] > NEG_INF / 2) & do_boost[:, None]
    if cap_c is not None:
        take = take & (torch.arange(cap_take, device=ann_s.device)[None, :]
                       < cap_c[:, None])
    acc_rows = torch.where(take, ann_r[:, :cap_take], cap).int()
    nbr_rows = _csr_neighbor_rows(state, csr_indptr, csr_nbr, acc_rows,
                                  tenant_c, max_nbr)
    return fast, acc_rows, nbr_rows


def _search_fused_scan(state: ArenaState, csr_indptr, csr_nbr, q, q_valid,
                       tenant, gate_on, boost_on, super_gate, k: int,
                       cap_take: int, max_nbr: int, k_q=None, cap_q=None,
                       k_live=None, read_only: bool = False):
    """The compute phase (``state.py:_search_fused_scan``, ``sem=None``):
    the two-tier top-k kernel with the ragged tail (``k_q``/``cap_q`` make
    ``k`` and ``cap_take`` static ceilings), then the gate verdict and, for
    a batch that boosts, the boost rows. ``k_live`` (host int >= max k_q)
    lets the kernel stop its lists early; the result is the same. The read
    twin stops after the verdict: its boost rows would all be the
    sentinel."""
    qn = normalize(q.float()).to(state.emb.dtype)
    gate_s, gate_r, ann_s, ann_r = fused_topk(
        state.emb, state.alive, state.tenant_id, state.is_super, qn, tenant,
        k_q, k, sentinel=state.capacity, k_live=k_live)
    if read_only:
        return gate_s, gate_r, ann_s, ann_r, gate_on & (gate_s > super_gate)
    fast, acc_rows, nbr_rows = _gate_and_boost_rows(
        state, csr_indptr, csr_nbr, gate_s, ann_s, ann_r, q_valid, tenant,
        gate_on, boost_on, super_gate, cap_take, max_nbr, cap_c=cap_q)
    return gate_s, gate_r, ann_s, ann_r, fast, acc_rows, nbr_rows


@_writes
def _boost_scatter(state: ArenaState, acc_rows: torch.Tensor,
                   nbr_rows: torch.Tensor, now, acc_boost,
                   nbr_boost, zero_last: bool = True) -> ArenaState:
    """Scatter phase (``state.py:_boost_scatter``), in place: per-row
    access and neighbor counts (a row retrieved by two queries of the batch
    counts twice), salience raised by the count-weighted boosts in the JAX
    order of operations and capped at 1.0, ``access_count`` raised by the
    access count, ``last_accessed`` set to ``now`` on every touched row.
    Masked entries point at the sentinel row, whose counts are zeroed; a
    shard's scatter (``zero_last=False``) routes the rows it does not own
    to index ``n``, one past its rows, whose counts are dropped (XLA drops
    such out-of-range updates; here they land in a spare bucket)."""
    n = state.salience.shape[0]
    dev = state.salience.device
    size = n if zero_last else n + 1

    def counts(rows):
        flat = rows.reshape(-1).long()
        cnt = torch.zeros((size,), dtype=torch.int32, device=dev)
        cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        if zero_last:
            cnt[n - 1:].zero_()    # a fill: no host value to copy over
        return cnt[:n]

    acc_cnt, nbr_cnt = counts(acc_rows), counts(nbr_rows)
    sal = (state.salience + acc_cnt.float() * acc_boost
           + nbr_cnt.float() * nbr_boost)
    touched = (acc_cnt > 0) | (nbr_cnt > 0)
    torch.where(touched, torch.clamp(sal, max=1.0), state.salience,
                out=state.salience)
    state.access_count += acc_cnt
    torch.where(touched, now, state.last_accessed, out=state.last_accessed)
    return state


def _boost_row_counts(capacity: int, acc_rows: torch.Tensor,
                      nbr_rows: torch.Tensor):
    """Per-query counts of rows the boost scatter touches (sentinel entries
    excluded), ``state.py:_boost_row_counts``."""
    return (acc_rows != capacity).sum(-1), (nbr_rows != capacity).sum(-1)


def _bitcast(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int32).contiguous().view(torch.float32)


def _pack_retrieval(gate_s, gate_r, ann_s, ann_r, fast, dup=None, acc=None,
                    nbr=None) -> torch.Tensor:
    """The one ``[Q, 3 + 2k + 5]`` f32 readback array
    (``state.py:_pack_retrieval``): gate score, gate row, ANN scores, ANN
    rows, the fast bit, then the five counters of
    ``utils.batching.RETRIEVAL_COUNTERS``: live hits, the duplicates the
    IVF dedup dropped (``dup``; 0 on the dense paths), the two boost row
    counts, and the semantic verdict (always 0: no semantic cache).
    Int columns are bit-cast, not converted; the host undoes it with
    ``.view(np.int32)`` (``utils.batching.unpack_retrieval``)."""
    zeros = torch.zeros(gate_s.shape, dtype=torch.int32, device=gate_s.device)
    n_live = (ann_s > NEG_INF / 2).sum(-1)
    dup = zeros if dup is None else dup
    acc = zeros if acc is None else acc
    nbr = zeros if nbr is None else nbr
    return torch.cat([
        gate_s[:, None], _bitcast(gate_r)[:, None], ann_s, _bitcast(ann_r),
        fast.float()[:, None], _bitcast(n_live)[:, None],
        _bitcast(dup)[:, None], _bitcast(acc)[:, None],
        _bitcast(nbr)[:, None], _bitcast(zeros)[:, None]], dim=1)


def _sem_finish(state: ArenaState, res, now, acc_boost, nbr_boost, dup=None):
    """Serve tail (the ``sem=None`` branch of ``state.py:_sem_finish``):
    boost-row counters, the in-place boost scatter, the packed readback
    (``dup``: the IVF dedup's per-query count)."""
    gate_s, gate_r, ann_s, ann_r, fast, acc_rows, nbr_rows = res
    n_acc, n_nbr = _boost_row_counts(state.capacity, acc_rows, nbr_rows)
    dev = state.salience.device
    _boost_scatter(state, acc_rows, nbr_rows, _scalar(now, dev),
                   _scalar(acc_boost, dev), _scalar(nbr_boost, dev))
    return state, _pack_retrieval(gate_s, gate_r, ann_s, ann_r, fast, dup=dup,
                                  acc=n_acc, nbr=n_nbr)


def _sem_finish_read(res, dup=None):
    """Read tail (the ``sem=None`` branch of ``state.py:_sem_finish_read``):
    no scatter; the boost counters are 0."""
    return _pack_retrieval(*res[:5], dup=dup)


def search_fused(state: ArenaState, csr_indptr, csr_nbr, q, q_valid, tenant,
                 gate_on, boost_on, now, super_gate, acc_boost, nbr_boost,
                 k: int, cap_take: int, max_nbr: int):
    """One padded cross-tenant query batch: gate + ANN top-``k`` + neighbor
    gather + both boosts, applied in place. Returns ``(state, packed)``
    (``state.py:search_fused``; the donated and ``_copy`` twins of the JAX
    package are one function here)."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_scan(state, csr_indptr, csr_nbr, q, q_valid, tenant,
                             gate_on, boost_on, sg, k, cap_take, max_nbr)
    return _sem_finish(state, res, now, acc_boost, nbr_boost)


def search_fused_read(state: ArenaState, csr_indptr, csr_nbr, q, q_valid,
                      tenant, gate_on, super_gate, k: int, cap_take: int,
                      max_nbr: int) -> torch.Tensor:
    """Read-only twin of :func:`search_fused` (no query boosts): same
    result columns, the state untouched. Returns the packed array."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_scan(state, csr_indptr, csr_nbr, q, q_valid, tenant,
                             gate_on, None, sg, k, cap_take, max_nbr,
                             read_only=True)
    return _sem_finish_read(res)


def search_fused_ragged(state: ArenaState, csr_indptr, csr_nbr, q, q_valid,
                        tenant, gate_on, boost_on, k_q, cap_q, now,
                        super_gate, acc_boost, nbr_boost, k: int,
                        cap_take: int, max_nbr: int, k_live=None):
    """:func:`search_fused` with the per-query ``k_q``/``cap_q`` sidecars
    (``state.py:search_fused_ragged``): ``k`` and ``cap_take`` are the
    static ceilings. Returns ``(state, packed)``."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_scan(state, csr_indptr, csr_nbr, q, q_valid, tenant,
                             gate_on, boost_on, sg, k, cap_take, max_nbr,
                             k_q=k_q, cap_q=cap_q, k_live=k_live)
    return _sem_finish(state, res, now, acc_boost, nbr_boost)


def search_fused_ragged_read(state: ArenaState, csr_indptr, csr_nbr, q,
                             q_valid, tenant, gate_on, k_q, super_gate,
                             k: int, cap_take: int, max_nbr: int,
                             k_live=None) -> torch.Tensor:
    """Read-only ragged twin (``state.py:search_fused_ragged_read``)."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_scan(state, csr_indptr, csr_nbr, q, q_valid, tenant,
                             gate_on, None, sg, k, cap_take, max_nbr,
                             k_q=k_q, k_live=k_live, read_only=True)
    return _sem_finish_read(res)


# ---------------------------------------------------------------------------
# Quantized fused serving: the same one-dispatch chat-turn program, whose
# whole-arena scan reads the int8 shadow (K4's keyed form, half the bytes
# of a bf16 arena) for a coarse top-(k + slack) of each tier, then rescores
# the survivors exactly from the master arena before the unchanged gate,
# CSR gather and boost tail (``state.py:_quant_two_tier`` and the
# ``search_fused_quant*`` programs).
# ---------------------------------------------------------------------------


def _quant_two_tier(state: ArenaState, q8a: torch.Tensor,
                    scale_a: torch.Tensor, q: torch.Tensor,
                    tenant: torch.Tensor, k: int, slack: int):
    """The two-stage two-tier core (``state.py:_quant_two_tier``): one K4
    launch gives each query's coarse top-``(1 + slack)`` super rows and
    top-``(k + slack)`` non-super rows of its tenant over the shadow
    (``q8a`` codes, ``scale_a`` scales); the survivors are rescored exactly
    (the arena's rows and the query in the arena dtype, f32 products summed
    over d), a survivor whose coarse score was ``NEG_INF`` staying at
    ``NEG_INF``, and the exact top-``k`` and top-1 taken in coarse-position
    order on ties. Returns ``(gate_s [Q], gate_r [Q], ann_s [Q, k], ann_r
    [Q, k])``, rows i32: returned scores and the gate's verdict carry no
    quantization error."""
    n = state.salience.shape[0]
    k_fetch = min(k + slack, n)
    g_fetch = min(1 + slack, n)
    qn = normalize(q.float())
    cg_s, cg_r, ca_s, ca_r = int8_topk_keyed(
        q8a, scale_a, state.alive, state.tenant_id, state.is_super, qn,
        tenant, k_fetch, g_fetch)
    qd = qn.to(state.emb.dtype).float()
    ann_s, sel = stable_topk(_rescore(state, qd, ca_r, ca_s), k)
    ann_r = torch.gather(ca_r, 1, sel)
    g_s, g_sel = stable_topk(_rescore(state, qd, cg_r, cg_s), 1)
    g_r = torch.gather(cg_r, 1, g_sel)
    return g_s[:, 0], g_r[:, 0], ann_s, ann_r


def _rescore(state: ArenaState, qd: torch.Tensor, rows: torch.Tensor,
             coarse_s: torch.Tensor) -> torch.Tensor:
    """The exact scores of coarse survivors (the ``rescore`` of
    ``state.py:_quant_two_tier`` and ``_ivf_two_tier``): each query ``qd``
    (the arena dtype's values, as f32) against its rows ``[Q, kf]``, f32
    products summed over d; a survivor whose coarse score was ``NEG_INF``
    stays at ``NEG_INF``."""
    g = state.emb[rows.long()].float()                     # [Q, kf, d]
    ex = (g * qd[:, None, :]).sum(-1)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ex.device)
    return torch.where(coarse_s > NEG_INF / 2, ex, neg)


def _search_fused_quant_scan(state: ArenaState, q8a, scale_a, csr_indptr,
                             csr_nbr, q, q_valid, tenant, gate_on, boost_on,
                             super_gate, k: int, slack: int, cap_take: int,
                             max_nbr: int, k_q=None, cap_q=None,
                             read_only: bool = False):
    """The quantized compute phase (``state.py:_search_fused_quant_scan``,
    ``sem=None``): the coarse scan and exact rescore, the ragged tail
    (``k_q``/``cap_q`` make ``k`` and ``cap_take`` ceilings), then the gate
    verdict and, for a batch that boosts, the boost rows. The read twin
    stops after the verdict."""
    gate_s, gate_r, ann_s, ann_r = _quant_two_tier(state, q8a, scale_a, q,
                                                   tenant, k, slack)
    if k_q is not None:
        ann_s, ann_r = ragged_mask(ann_s, ann_r, k_q, state.capacity)
    if read_only:
        return gate_s, gate_r, ann_s, ann_r, gate_on & (gate_s > super_gate)
    fast, acc_rows, nbr_rows = _gate_and_boost_rows(
        state, csr_indptr, csr_nbr, gate_s, ann_s, ann_r, q_valid, tenant,
        gate_on, boost_on, super_gate, cap_take, max_nbr, cap_c=cap_q)
    return gate_s, gate_r, ann_s, ann_r, fast, acc_rows, nbr_rows


def search_fused_quant(state: ArenaState, q8a, scale_a, csr_indptr, csr_nbr,
                       q, q_valid, tenant, gate_on, boost_on, now, super_gate,
                       acc_boost, nbr_boost, k: int, slack: int,
                       cap_take: int, max_nbr: int):
    """:func:`search_fused` with the int8 coarse scan and exact rescore
    (``state.py:search_fused_quant``): one dispatch, one packed readback;
    the boosts write salience, access counts and freshness, never the
    embeddings, so the shadow stays valid. Returns ``(state, packed)``."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_quant_scan(state, q8a, scale_a, csr_indptr, csr_nbr,
                                   q, q_valid, tenant, gate_on, boost_on, sg,
                                   k, slack, cap_take, max_nbr)
    return _sem_finish(state, res, now, acc_boost, nbr_boost)


def search_fused_quant_read(state: ArenaState, q8a, scale_a, csr_indptr,
                            csr_nbr, q, q_valid, tenant, gate_on, super_gate,
                            k: int, slack: int, cap_take: int,
                            max_nbr: int) -> torch.Tensor:
    """Read-only twin of :func:`search_fused_quant`
    (``state.py:search_fused_quant_read``). Returns the packed array."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_quant_scan(state, q8a, scale_a, csr_indptr, csr_nbr,
                                   q, q_valid, tenant, gate_on, None, sg, k,
                                   slack, cap_take, max_nbr, read_only=True)
    return _sem_finish_read(res)


def search_fused_quant_ragged(state: ArenaState, q8a, scale_a, csr_indptr,
                              csr_nbr, q, q_valid, tenant, gate_on, boost_on,
                              k_q, cap_q, now, super_gate, acc_boost,
                              nbr_boost, k: int, slack: int, cap_take: int,
                              max_nbr: int):
    """:func:`search_fused_quant` with the per-query ``k_q``/``cap_q``
    sidecars (``state.py:search_fused_quant_ragged``): the coarse fetch and
    the rescore run to the ceiling ``k``. Returns ``(state, packed)``."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_quant_scan(state, q8a, scale_a, csr_indptr, csr_nbr,
                                   q, q_valid, tenant, gate_on, boost_on, sg,
                                   k, slack, cap_take, max_nbr, k_q=k_q,
                                   cap_q=cap_q)
    return _sem_finish(state, res, now, acc_boost, nbr_boost)


def search_fused_quant_ragged_read(state: ArenaState, q8a, scale_a,
                                   csr_indptr, csr_nbr, q, q_valid, tenant,
                                   gate_on, k_q, super_gate, k: int,
                                   slack: int, cap_take: int,
                                   max_nbr: int) -> torch.Tensor:
    """Read-only ragged twin (``state.py:search_fused_quant_ragged_read``)."""
    sg = _scalar(super_gate, state.emb.device)
    res = _search_fused_quant_scan(state, q8a, scale_a, csr_indptr, csr_nbr,
                                   q, q_valid, tenant, gate_on, None, sg, k,
                                   slack, cap_take, max_nbr, k_q=k_q,
                                   read_only=True)
    return _sem_finish_read(res)


# ---------------------------------------------------------------------------
# Fused IVF serving: the same one-dispatch chat-turn program, whose coarse
# stage is the centroid prefilter (the masked top-k kernel over the
# centroid table) and whose candidate scan is K5 over the probed clusters'
# member rows and the exact-scan extras (``state.py:_ivf_two_tier`` and the
# ``search_fused_ivf*`` programs). With the int8 shadow on, K5 scores the
# gathered codes and the survivors are rescored exactly from the master.
# ---------------------------------------------------------------------------


def _dedup_topk(scores: torch.Tensor, rows: torch.Tensor, sentinel: int,
                k: int):
    """Top-``k`` of a score-sorted over-fetched list keeping only the FIRST
    occurrence of each row (``state.py:_dedup_topk``): entries at or below
    ``NEG_INF / 2`` become the sentinel first, a repeat scores ``NEG_INF``,
    and ``n_dup`` counts the repeats of real rows. Returns ``(scores [Q,
    k], rows [Q, k] i32, n_dup [Q] i32)``."""
    r = torch.where(scores > NEG_INF / 2, rows, sentinel)
    m = r.shape[1]
    earlier = torch.ones((m, m), dtype=torch.bool, device=r.device).tril(-1)
    dup = ((r[:, :, None] == r[:, None, :]) & earlier[None]).any(-1)
    n_dup = (dup & (r != sentinel)).sum(-1).int()
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=scores.device)
    top_s, sel = stable_topk(torch.where(dup, neg, scores), k)
    top_r = torch.gather(r, 1, sel)
    return top_s, torch.where(top_s > NEG_INF / 2, top_r, sentinel).int(), n_dup


def _ivf_two_tier(state: ArenaState, shadow, centroids: torch.Tensor,
                  members: torch.Tensor, extras: torch.Tensor, q: torch.Tensor,
                  tenant: torch.Tensor, k: int, nprobe: int, slack: int,
                  nprobe_q=None, occ=None, n_extras=None):
    """The IVF two-tier core (``state.py:_ivf_two_tier``): the coarse stage
    (each query's ``nprobe`` nearest clusters), then one K5 launch over the
    L = nprobe * M + E candidates, with the tenant mask and, where
    ``nprobe_q`` is given, each query's own probe width (``occ`` and
    ``n_extras`` bound the tables' occupied slots): exact (the query in
    the arena dtype) for the top-(k + slack) non-super and top-1 super
    candidates, or with the int8 ``shadow`` a coarse top-(k + slack) and
    top-(1 + slack) rescored exactly from the master. Then the first
    occurrence of each row (:func:`_dedup_topk`). Returns ``(gate_s [Q],
    gate_r [Q], ann_s [Q, k], ann_r [Q, k], n_dup [Q])``, rows i32 and the
    sentinel (``state.capacity``) where invalid."""
    cap = state.capacity
    length = nprobe * members.shape[1] + extras.shape[0]
    k_fetch = min(k + slack, length)
    g_fetch = min(1 + slack, length)
    qn = normalize(q.float())
    cids = coarse_clusters(centroids, qn, nprobe)
    cols = (state.alive, state.tenant_id, state.is_super)
    qd = qn.to(state.emb.dtype).float()
    if shadow is None:
        ann_ex, _, ann_rows, g_s, _, g_r = ivf_topk(
            state.emb, members, extras, cids, qd, k_fetch, g=1, cols=cols,
            q_tenant=tenant, nprobe_q=nprobe_q, occ=occ, n_extras=n_extras)
        gate_s, gate_r0 = g_s[:, 0], g_r[:, 0]
    else:
        a_s0, _, a_r0, g_s0, _, g_r0 = ivf_topk(
            shadow, members, extras, cids, qn, k_fetch, g=g_fetch, cols=cols,
            q_tenant=tenant, nprobe_q=nprobe_q, occ=occ, n_extras=n_extras)
        ann_rows = torch.where(a_s0 > NEG_INF / 2, a_r0, cap)
        ann_ex = _rescore(state, qd, ann_rows, a_s0)
        g_rows = torch.where(g_s0 > NEG_INF / 2, g_r0, cap)
        g_s, g_sel = stable_topk(_rescore(state, qd, g_rows, g_s0), 1)
        gate_s = g_s[:, 0]
        gate_r0 = torch.gather(g_rows, 1, g_sel)[:, 0]
    ann_s, ann_r, n_dup = _dedup_topk(ann_ex, ann_rows, cap, k)
    gate_r = torch.where(gate_s > NEG_INF / 2, gate_r0, cap).int()
    return gate_s, gate_r, ann_s, ann_r, n_dup


def _search_fused_ivf_scan(state: ArenaState, shadow, centroids, members,
                           extras, csr_indptr, csr_nbr, q, q_valid, tenant,
                           gate_on, boost_on, super_gate, k: int, nprobe: int,
                           slack: int, cap_take: int, max_nbr: int, k_q=None,
                           cap_q=None, nprobe_q=None, read_only: bool = False,
                           occ=None, n_extras=None):
    """The IVF compute phase (``state.py:_search_fused_ivf_scan``,
    ``sem=None``): the two-tier core, the ragged tail (``k_q`` / ``cap_q``
    / ``nprobe_q`` make ``k``, ``cap_take`` and ``nprobe`` ceilings), then
    the gate verdict and, for a batch that boosts, the boost rows; the
    dedup count last. The read twin stops after the verdict."""
    gate_s, gate_r, ann_s, ann_r, n_dup = _ivf_two_tier(
        state, shadow, centroids, members, extras, q, tenant, k, nprobe,
        slack, nprobe_q=nprobe_q, occ=occ, n_extras=n_extras)
    if k_q is not None:
        ann_s, ann_r = ragged_mask(ann_s, ann_r, k_q, state.capacity)
    if read_only:
        return (gate_s, gate_r, ann_s, ann_r, gate_on & (gate_s > super_gate)), n_dup
    fast, acc_rows, nbr_rows = _gate_and_boost_rows(
        state, csr_indptr, csr_nbr, gate_s, ann_s, ann_r, q_valid, tenant,
        gate_on, boost_on, super_gate, cap_take, max_nbr, cap_c=cap_q)
    return (gate_s, gate_r, ann_s, ann_r, fast, acc_rows, nbr_rows), n_dup


def search_fused_ivf(state: ArenaState, shadow, centroids, members, extras,
                     csr_indptr, csr_nbr, q, q_valid, tenant, gate_on,
                     boost_on, now, super_gate, acc_boost, nbr_boost, k: int,
                     nprobe: int, slack: int, cap_take: int, max_nbr: int,
                     occ=None, n_extras=None):
    """:func:`search_fused` with the IVF coarse stage and candidate scan
    (``state.py:search_fused_ivf``): ``shadow`` None or the int8 shadow's
    ``(codes, scales)``, ``centroids [C, d]`` f32, ``members [C, M]`` and
    ``extras [E]`` i32 (the tables are read, never written; the boosts
    write salience, access counts and freshness), and the tables'
    occupancy ``occ [C]`` and ``n_extras`` (K5's contract; None walks every
    slot). One dispatch, one packed readback whose ``dedup`` counter is the
    IVF dedup's. Returns ``(state, packed)``."""
    sg = _scalar(super_gate, state.emb.device)
    res, n_dup = _search_fused_ivf_scan(
        state, shadow, centroids, members, extras, csr_indptr, csr_nbr, q,
        q_valid, tenant, gate_on, boost_on, sg, k, nprobe, slack, cap_take,
        max_nbr, occ=occ, n_extras=n_extras)
    return _sem_finish(state, res, now, acc_boost, nbr_boost, dup=n_dup)


def search_fused_ivf_read(state: ArenaState, shadow, centroids, members,
                          extras, csr_indptr, csr_nbr, q, q_valid, tenant,
                          gate_on, super_gate, k: int, nprobe: int, slack: int,
                          cap_take: int, max_nbr: int, occ=None,
                          n_extras=None) -> torch.Tensor:
    """Read-only twin of :func:`search_fused_ivf`
    (``state.py:search_fused_ivf_read``). Returns the packed array."""
    sg = _scalar(super_gate, state.emb.device)
    res, n_dup = _search_fused_ivf_scan(
        state, shadow, centroids, members, extras, csr_indptr, csr_nbr, q,
        q_valid, tenant, gate_on, None, sg, k, nprobe, slack, cap_take,
        max_nbr, read_only=True, occ=occ, n_extras=n_extras)
    return _sem_finish_read(res, dup=n_dup)


def search_fused_ivf_ragged(state: ArenaState, shadow, centroids, members,
                            extras, csr_indptr, csr_nbr, q, q_valid, tenant,
                            gate_on, boost_on, k_q, cap_q, nprobe_q, now,
                            super_gate, acc_boost, nbr_boost, k: int,
                            nprobe: int, slack: int, cap_take: int,
                            max_nbr: int, occ=None, n_extras=None):
    """:func:`search_fused_ivf` with the per-query ``k_q`` / ``cap_q`` /
    ``nprobe_q`` sidecars (``state.py:search_fused_ivf_ragged``): the scan
    visits the ceiling ``nprobe`` clusters and each query masks the members
    of clusters ranked at or past its own width. Returns ``(state,
    packed)``."""
    sg = _scalar(super_gate, state.emb.device)
    res, n_dup = _search_fused_ivf_scan(
        state, shadow, centroids, members, extras, csr_indptr, csr_nbr, q,
        q_valid, tenant, gate_on, boost_on, sg, k, nprobe, slack, cap_take,
        max_nbr, k_q=k_q, cap_q=cap_q, nprobe_q=nprobe_q, occ=occ,
        n_extras=n_extras)
    return _sem_finish(state, res, now, acc_boost, nbr_boost, dup=n_dup)


def search_fused_ivf_ragged_read(state: ArenaState, shadow, centroids,
                                 members, extras, csr_indptr, csr_nbr, q,
                                 q_valid, tenant, gate_on, k_q, nprobe_q,
                                 super_gate, k: int, nprobe: int, slack: int,
                                 cap_take: int, max_nbr: int, occ=None,
                                 n_extras=None) -> torch.Tensor:
    """Read-only ragged twin (``state.py:search_fused_ivf_ragged_read``)."""
    sg = _scalar(super_gate, state.emb.device)
    res, n_dup = _search_fused_ivf_scan(
        state, shadow, centroids, members, extras, csr_indptr, csr_nbr, q,
        q_valid, tenant, gate_on, None, sg, k, nprobe, slack, cap_take,
        max_nbr, k_q=k_q, nprobe_q=nprobe_q, read_only=True, occ=occ,
        n_extras=n_extras)
    return _sem_finish_read(res, dup=n_dup)


# ---------------------------------------------------------------------------
# Row-sharded arena (MemoryIndex(mesh=...)): host routing and the fused
# serving program over the shards, ``state.py:make_fused_sharded`` in exact
# mode. The shards' scans launch on their devices; the merges and the
# replicated arithmetic run on the first shard's device, the owner shards
# gather CSR windows and scatter boosts for their own rows only.
# ---------------------------------------------------------------------------


def init_shards(capacity: int, dim: int, dtype, devices) -> List[ArenaState]:
    """An empty arena of ``capacity + 1`` rows split over ``devices``: shard
    ``p`` holds ``L = (capacity + 1) / n`` rows on ``devices[p]``, no scratch
    row of its own (the global sentinel is the last shard's last row)."""
    n = len(devices)
    if (capacity + 1) % n:
        raise ValueError(f"{capacity + 1} rows do not split over {n} shards")
    local_n = (capacity + 1) // n
    return [init_arena(local_n - 1, dim, dtype, dev) for dev in devices]


def shards_from_numpy(cols: Dict[str, np.ndarray], devices) -> List[ArenaState]:
    """Global numpy columns split by owner onto ``devices``."""
    n = len(devices)
    total = cols["salience"].shape[0]
    if total % n:
        raise ValueError(f"{total} rows do not split over {n} shards")
    local_n = total // n
    return [ArenaState(**{f: _tensor(cols[f][p * local_n:(p + 1) * local_n],
                                     dev) for f in ARENA_FIELDS})
            for p, dev in enumerate(devices)]


def grow_shards(shards: List[ArenaState], new_capacity: int,
                devices) -> List[ArenaState]:
    """:func:`grow_arena` for a row-sharded arena: the rows per shard change,
    so the live rows (all but the old sentinel) split anew over the
    devices, each keeping its global row number (rare)."""
    old_cap = len(shards) * shards[0].salience.shape[0] - 1
    assert new_capacity > old_cap
    fresh = init_shards(new_capacity, shards[0].dim, shards[0].emb.dtype,
                        devices)
    local_n = fresh[0].salience.shape[0]
    dev0 = shards[0].emb.device
    for name in ARENA_FIELDS:
        whole = torch.cat([getattr(st, name).to(dev0) for st in shards])
        for p, st in enumerate(fresh):
            lo, hi = p * local_n, min((p + 1) * local_n, old_cap)
            if lo < hi:
                getattr(st, name)[:hi - lo] = whole[lo:hi].to(st.emb.device)
    return fresh


def route_rows(rows: np.ndarray, local_n: int):
    """Split global ``rows`` by owner shard: ``[(p, sel, local_rows)]`` for
    every shard that owns one (``sel`` indexes ``rows``), in shard order."""
    rows = np.asarray(rows, np.int64)
    owner = rows // local_n
    out = []
    for p in np.unique(owner).tolist():
        sel = np.nonzero(owner == p)[0]
        out.append((int(p), sel, rows[sel] - p * local_n))
    return out


def _fused_scan_sharded(shards, q, tenant, k: int, k_q, k_live=None):
    """The shard-local two-tier scans and the two merges
    (``make_fused_sharded._scan_merge``): the ANN top-``min(k, n * k_l)``
    with the ``k_q`` tail and the gate top-1, masked entries on the global
    sentinel. The shards of each device are one grouped launch
    (``ops.fused_topk.fused_topk_grouped``, scan and merges in one); runs on
    several devices meet in the merge kernel. Returns ``(gate_s [Q], gate_r
    [Q], ann_s, ann_r)`` with global rows on the first shard's device."""
    n = len(shards)
    local_n = shards[0].salience.shape[0]
    sent = n * local_n - 1
    k_l = max(1, min(k, local_n))
    k_out = min(k, n * k_l)
    dev0 = shards[0].emb.device
    qn = normalize(q.float()).to(shards[0].emb.dtype)
    groups = shard_groups([st.emb.device for st in shards])
    if len(groups) == 1:
        return fused_topk_grouped(
            [(st.emb, st.alive, st.tenant_id, st.is_super) for st in shards],
            qn, tenant, k_q, k_out, sent, k_live)
    parts = []
    for dev, ids in groups:
        parts.append(fused_topk_grouped(
            [(shards[p].emb, shards[p].alive, shards[p].tenant_id,
              shards[p].is_super) for p in ids],
            qn.to(dev, non_blocking=True), tenant.to(dev, non_blocking=True),
            None, min(k_out, len(ids) * k_l), sent,
            None if k_live is None else min(int(k_live), k_out), ids))
    ann_s, ann_r = sharded_merge([x[2] for x in parts], [x[3] for x in parts], 0,
                                 k_out, k_q=k_q, sentinel=sent, device=dev0)
    gate_s, gate_r = sharded_merge([x[0][:, None] for x in parts],
                                   [x[1][:, None] for x in parts], 0, 1,
                                   sentinel=sent, device=dev0)
    return gate_s[:, 0], gate_r[:, 0], ann_s, ann_r


def _boost_tail_sharded(shards, csr, ann_s, ann_r, fast, q_valid, tenant,
                        boost_on, cap_q, now, acc_boost, nbr_boost,
                        cap_take: int, max_nbr: int):
    """The gate/CSR/boost tail against the row-sharded arena
    (``make_fused_sharded._boost_tail``): the owner shard gathers each
    accessed row's CSR window from its own slice (``-1`` elsewhere; the
    element-wise max on the first device keeps exactly the owner's window,
    the ``pmax``), the dedup and in-result masks are computed once on the
    merged ids, and each shard scatters the boosts of the rows it owns.
    Returns ``(n_acc [Q], n_nbr [Q])``, the ``psum`` a sum over shards."""
    n = len(shards)
    local_n = shards[0].salience.shape[0]
    sent = n * local_n - 1
    dev0 = ann_s.device
    do_boost = boost_on & q_valid & ~fast
    take = (ann_s[:, :cap_take] > NEG_INF / 2) & do_boost[:, None]
    if cap_q is not None:
        take = take & (torch.arange(cap_take, device=dev0)[None, :]
                       < cap_q[:, None])
    acc_rows = torch.where(take, ann_r[:, :cap_take], sent)     # global rows
    acc_idx, windows = [], None
    for p, (st, (indptr, nbr)) in enumerate(zip(shards, csr)):
        dev = st.emb.device
        acc_p = acc_rows.to(dev, non_blocking=True)
        loc = acc_p - p * local_n
        mine = (loc >= 0) & (loc < local_n) & (acc_p != sent)
        safe = torch.clamp(loc, 0, local_n - 1).long()
        start = torch.where(mine, indptr[safe], 0)
        end = torch.where(mine, indptr[safe + 1], 0)
        idx = start[:, :, None] + torch.arange(max_nbr, device=dev,
                                               dtype=start.dtype)[None, None, :]
        ok = idx < end[:, :, None]
        win = torch.where(ok, nbr[torch.clamp(idx, max=nbr.shape[0] - 1).long()],
                          -1).to(dev0, non_blocking=True)
        windows = win if windows is None else torch.maximum(windows, win)
        acc_idx.append(torch.where(mine, loc, local_n))
    flat = windows.reshape(windows.shape[0], -1)                 # [Q, M]
    m = flat.shape[1]
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev0).tril(-1)
    dup = ((flat[:, :, None] == flat[:, None, :]) & earlier[None]).any(-1)
    in_res = (flat[:, :, None] == acc_rows[:, None, :]).any(-1)
    keep = ~dup & ~in_res
    n_acc = (acc_rows != sent).sum(-1).int()
    n_nbr = torch.zeros_like(n_acc)
    for p, st in enumerate(shards):
        dev = st.emb.device
        flat_p = flat.to(dev, non_blocking=True)
        nloc = flat_p - p * local_n
        nmine = (nloc >= 0) & (nloc < local_n) & (flat_p >= 0)
        nsafe = torch.clamp(nloc, 0, local_n - 1).long()
        nvalid = (nmine & st.alive[nsafe]
                  & (st.tenant_id[nsafe]
                     == tenant.to(dev, non_blocking=True)[:, None]))
        nbr_idx = torch.where(nvalid & keep.to(dev, non_blocking=True), nloc,
                              local_n)
        _boost_scatter(st, acc_idx[p], nbr_idx, _scalar(now, dev),
                       _scalar(acc_boost, dev), _scalar(nbr_boost, dev),
                       zero_last=False)
        n_nbr += (nbr_idx != local_n).sum(-1).int().to(dev0, non_blocking=True)
    return n_acc, n_nbr


def search_fused_sharded(shards, csr_shards, q, q_valid, tenant, gate_on,
                         boost_on, k_q, cap_q, now, super_gate, acc_boost,
                         nbr_boost, k: int, cap_take: int, max_nbr: int,
                         k_live=None) -> torch.Tensor:
    """One padded cross-tenant query batch against the row-sharded arena
    (``state.py:make_fused_sharded(mode="exact", ragged=True).serve``): per
    shard one launch of the two-tier kernel over its rows at ``k_l = min(k,
    L)``, the ANN and gate merges, the gate verdict, and the boosts applied
    in place by their owner shards. ``shards`` is the list of shard states,
    ``csr_shards`` each shard's ``(indptr [L + 1], nbr [E])`` with global
    neighbor rows (``core.index.split_csr``); the batch columns live on the
    first shard's device. ``k_live`` (host int >= max k_q) lets the scans
    stop their lists early. Returns the packed ``[Q, 3 + 2k + 5]`` array
    on the first shard's device, as :func:`search_fused_ragged` does."""
    dev0 = shards[0].emb.device
    gate_s, gate_r, ann_s, ann_r = _fused_scan_sharded(shards, q, tenant, k,
                                                       k_q, k_live)
    fast = gate_on & (gate_s > _scalar(super_gate, dev0))
    n_acc, n_nbr = _boost_tail_sharded(
        shards, csr_shards, ann_s, ann_r, fast, q_valid, tenant, boost_on,
        cap_q, now, acc_boost, nbr_boost, min(cap_take, ann_s.shape[1]),
        max_nbr)
    return _pack_retrieval(gate_s, gate_r, ann_s, ann_r, fast, acc=n_acc,
                           nbr=n_nbr)


def search_fused_sharded_read(shards, csr_shards, q, q_valid, tenant,
                              gate_on, k_q, super_gate, k: int,
                              cap_take: int, max_nbr: int,
                              k_live=None) -> torch.Tensor:
    """Read-only twin of :func:`search_fused_sharded` (``make_fused_sharded
    .read``): the scans, the merges and the verdict, no boosts; the boost
    counters are 0. Returns the packed array."""
    dev0 = shards[0].emb.device
    gate_s, gate_r, ann_s, ann_r = _fused_scan_sharded(shards, q, tenant, k,
                                                       k_q, k_live)
    fast = gate_on & (gate_s > _scalar(super_gate, dev0))
    return _pack_retrieval(gate_s, gate_r, ann_s, ann_r, fast)
