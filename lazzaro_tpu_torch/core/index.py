"""MemoryIndex: host bookkeeping around the device arena, in torch.

Counterpart of the dense single-device subset of ``lazzaro_tpu/core/index.py``:
string id <-> row maps, free lists, capacity growth and sentinel padding on
the host; every numeric column on the device (``core.state``). Search runs
the masked top-k kernel on a CUDA arena. Mutations update the index's own
tensors in place under one lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.utils.batching import (decode_topk, empty_results,
                                              next_pow2, pad_to_pow2)
from lazzaro_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported arena dtype {dtype!r}")
    return _DTYPES[name]


class _EdgeSlotMap(dict):
    """``(qsrc, qtgt) -> slot`` edge map with a ``by_slot`` reverse index, so
    decoding the compacted pruned-slot list is O(pruned)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.by_slot: Dict[int, Tuple[str, str]] = {
            slot: key for key, slot in self.items()}

    def __setitem__(self, key, slot) -> None:
        old = super().get(key)
        if old is not None:
            self.by_slot.pop(old, None)
        super().__setitem__(key, slot)
        self.by_slot[slot] = key

    def __delitem__(self, key) -> None:
        slot = dict.pop(self, key)
        self.by_slot.pop(slot, None)

    def pop(self, key, *default):
        if key in self:
            slot = dict.pop(self, key)
            self.by_slot.pop(slot, None)
            return slot
        if default:
            return default[0]
        raise KeyError(key)

    def clear(self) -> None:
        super().clear()
        self.by_slot.clear()


class MemoryIndex:
    """Single-device dense arena index. ``device`` defaults to CUDA and
    raises without a GPU; pass ``device="cpu"`` for the plain versions."""

    def __init__(self, dim: int, capacity: int = 1024, edge_capacity: int = 8192,
                 dtype=torch.float32, epoch: Optional[float] = None,
                 device=None):
        self.device = resolve_device(device)
        self.dim = dim
        self.dtype = torch_dtype(dtype)
        self._lock = threading.RLock()
        # Timestamps are stored relative to this epoch so f32 keeps
        # sub-second precision.
        self.epoch = float(epoch if epoch is not None else time.time())
        capacity = self._round_capacity(capacity)
        edge_capacity = self._round_capacity(edge_capacity, block=False)
        self.state = S.init_arena(capacity, dim, self.dtype, self.device)
        self.edge_state = S.init_edges(edge_capacity, self.device)
        self._free_rows: List[int] = list(range(capacity - 1, -1, -1))
        self._free_edge_slots: List[int] = list(range(edge_capacity - 1, -1, -1))
        self.id_to_row: Dict[str, int] = {}
        self.row_to_id: Dict[int, str] = {}
        self.edge_slots: _EdgeSlotMap = _EdgeSlotMap()
        self._tenants: Dict[str, int] = {}
        self._shards: Dict[str, int] = {}
        self.tenant_nodes: Dict[str, set] = {}
        self._prune_cap_hwm = 0

    @classmethod
    def from_numpy(cls, arena: Dict[str, np.ndarray],
                   edges: Dict[str, np.ndarray], meta: Dict, device=None
                   ) -> "MemoryIndex":
        """Build an index from another index's state as numpy arrays: every
        ``ArenaState``/``EdgeState`` column, and ``meta`` with ``id_to_row``,
        ``tenants``, ``shards``, ``edge_slots``, ``free_rows``,
        ``free_edge_slots`` and optionally ``epoch`` (the JAX index's
        ``_tenants``, ``_shards``, ``_free_rows``, ... under these names)."""
        emb = arena["emb"]
        idx = cls(emb.shape[1], capacity=8, edge_capacity=8,
                  dtype=emb.dtype.name, epoch=meta.get("epoch"), device=device)
        idx.state = S.arena_from_numpy(arena, idx.device)
        idx.edge_state = S.edges_from_numpy(edges, idx.device)
        idx.id_to_row = {k: int(v) for k, v in meta["id_to_row"].items()}
        idx.row_to_id = {r: k for k, r in idx.id_to_row.items()}
        idx._tenants = dict(meta["tenants"])
        idx._shards = dict(meta["shards"])
        idx.edge_slots = _EdgeSlotMap(
            {tuple(k): int(v) for k, v in meta["edge_slots"].items()})
        idx._free_rows = [int(r) for r in meta["free_rows"]]
        idx._free_edge_slots = [int(s) for s in meta["free_edge_slots"]]
        tenant_col = arena["tenant_id"]
        names = {tid: name for name, tid in idx._tenants.items()}
        idx.tenant_nodes = {}
        for qid, row in idx.id_to_row.items():
            name = names.get(int(tenant_col[row]))
            if name is not None:
                idx.tenant_nodes.setdefault(name, set()).add(qid)
        return idx

    # ------------------------------------------------------------ capacity
    def _round_capacity(self, capacity: int, block: bool = True) -> int:
        """capacity + 1 rounds up to a TOPK_BLOCK multiple once it reaches a
        block (node arena only), the JAX package's row layout."""
        total = capacity + 1
        if block and total >= S.TOPK_BLOCK:
            total = -(-total // S.TOPK_BLOCK) * S.TOPK_BLOCK
        return total - 1

    def _grown_capacity(self, old_capacity: int, block: bool = True) -> int:
        return self._round_capacity((old_capacity + 1) * 2 - 1, block=block)

    # ------------------------------------------------------------------ ids
    def tenant_id(self, name: str) -> int:
        if name not in self._tenants:
            self._tenants[name] = len(self._tenants)
        return self._tenants[name]

    def shard_id(self, name: str) -> int:
        if name not in self._shards:
            self._shards[name] = len(self._shards)
        return self._shards[name]

    @property
    def capacity(self) -> int:
        return self.state.capacity

    def __len__(self) -> int:
        return len(self.id_to_row)

    def stats(self) -> Dict[str, object]:
        return {
            "rows": len(self.id_to_row),
            "capacity": self.state.capacity,
            "edge_capacity": self.edge_state.capacity,
            "edges": len(self.edge_slots),
            "dim": self.dim,
            "dtype": str(self.dtype).replace("torch.", ""),
            "tenants": len(self._tenants),
            "device": str(self.device),
        }

    # ---------------------------------------------------------------- nodes
    def _alloc_rows(self, n: int) -> List[int]:
        while len(self._free_rows) < n:
            old_cap = self.state.capacity
            new_cap = self._grown_capacity(old_cap)
            self.state = S.grow_arena(self.state, new_cap)
            self._free_rows = list(range(new_cap - 1, old_cap - 1, -1)) + self._free_rows
        return [self._free_rows.pop() for _ in range(n)]

    def add(self, ids: Sequence[str], embeddings: np.ndarray,
            saliences: Sequence[float], timestamps: Sequence[float],
            types: Sequence[str], shard_keys: Sequence[str],
            tenant: str, is_super: Optional[Sequence[bool]] = None) -> List[int]:
        """Batch insert; returns arena rows. Re-adding an existing id updates
        its row in place."""
        n = len(ids)
        if n == 0:
            return []
        if is_super is None:
            is_super = [False] * n
        with self._lock:
            rows: List[int] = []
            fresh = self._alloc_rows(sum(1 for i in ids if i not in self.id_to_row))
            fi = 0
            for node_id in ids:
                if node_id in self.id_to_row:
                    rows.append(self.id_to_row[node_id])
                else:
                    r = fresh[fi]
                    fi += 1
                    self.id_to_row[node_id] = r
                    self.row_to_id[r] = node_id
                    rows.append(r)

            padded = S.pad_rows(np.asarray(rows, np.int32), self.state.capacity)
            b = len(padded)

            def pad(vals, fill=0.0, dt=np.float32):
                out = np.full((b,), fill, dt)
                out[:n] = vals
                return out

            emb = np.zeros((b, self.dim), np.float32)
            emb[:n] = np.asarray(embeddings, np.float32).reshape(n, self.dim)
            emb[n:, 0] = 1.0   # sentinel rows get a unit vector (normalizable)
            tid = self.tenant_id(tenant)
            self.tenant_nodes.setdefault(tenant, set()).update(ids)
            S._arena_add(
                self.state, torch.from_numpy(padded), torch.from_numpy(emb),
                pad([float(s) for s in saliences]),
                pad([float(t) - self.epoch for t in timestamps]),
                pad([S.TYPE_IDS.get(t, 0) for t in types], 0, np.int32),
                pad([self.shard_id(k or "default") for k in shard_keys], -1, np.int32),
                pad([tid] * n, -1, np.int32),
                pad([bool(x) for x in is_super], False, bool))
            return rows

    def delete(self, ids: Iterable[str]) -> None:
        ids = list(ids)
        with self._lock:
            for members in self.tenant_nodes.values():
                members.difference_update(ids)
            rows = [self.id_to_row.pop(i) for i in ids if i in self.id_to_row]
            if not rows:
                return
            for r in rows:
                self.row_to_id.pop(r, None)
            padded = S.pad_rows(np.asarray(rows, np.int32), self.state.capacity)
            S._arena_delete(self.state, padded)
            S._edges_delete_for_nodes(self.edge_state, padded)
            self._free_rows.extend(rows)
            dead = [k for k in self.edge_slots
                    if k[0] not in self.id_to_row or k[1] not in self.id_to_row]
            for k in dead:
                self._free_edge_slots.append(self.edge_slots.pop(k))

    def search(self, query: np.ndarray, tenant: str, k: int = 10,
               super_filter: int = 0, exact: bool = False
               ) -> Tuple[List[str], List[float]]:
        """Masked cosine top-k; returns (ids, scores) with dead and padded
        hits dropped. Single-query view of :meth:`search_batch`."""
        return self.search_batch(np.asarray(query, np.float32)[None, :],
                                 tenant, k, super_filter, exact=exact)[0]

    def search_batch(self, queries: np.ndarray, tenant: str, k: int = 10,
                     super_filter: int = 0, exact: bool = False
                     ) -> List[Tuple[List[str], List[float]]]:
        """Multi-query masked top-k: one kernel launch for the whole batch,
        padded to a power of two as the JAX index pads it. Every search of
        this slice is exact (the master arena), so ``exact`` changes
        nothing."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        nq = queries.shape[0]
        if nq == 0 or not self.id_to_row:
            return empty_results(nq)
        tid = self._tenants.get(tenant)
        if tid is None:
            return empty_results(nq)
        q_pad = torch.from_numpy(pad_to_pow2(queries)).to(self.device)
        with self._lock:
            k_eff = min(k, self.state.capacity)
            scores, rows = S.arena_search(self.state, q_pad, tid, k_eff,
                                          super_filter)
        return decode_topk(scores[:nq].cpu().numpy(), rows[:nq].cpu().numpy(),
                           self.row_to_id, S.NEG_INF)

    def best_earlier_match(self, embeddings: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Intra-batch duplicate scan on the index's device: per row, the
        index and cosine of the most similar earlier row."""
        cols, sims = S.best_earlier_match(
            torch.from_numpy(np.asarray(embeddings, np.float32)).to(self.device))
        return cols.cpu().numpy(), sims.cpu().numpy()

    # ------------------------------------------------------- numeric sweeps
    def _now(self, now: Optional[float]) -> float:
        return (now if now is not None else time.time()) - self.epoch

    def _padded_rows(self, ids: Sequence[str]) -> Optional[np.ndarray]:
        rows = [self.id_to_row[i] for i in ids if i in self.id_to_row]
        if not rows:
            return None
        return S.pad_rows(np.asarray(rows, np.int32), self.state.capacity)

    def update_access(self, ids: Sequence[str], boost: float = 0.05,
                      now: Optional[float] = None) -> None:
        with self._lock:
            padded = self._padded_rows(ids)
            if padded is not None:
                S._arena_update_access(self.state, padded, self._now(now), boost)

    def boost(self, ids: Sequence[str], boost: float = 0.02,
              now: Optional[float] = None) -> None:
        """Neighbor boost: salience bump + freshness, no access increment."""
        with self._lock:
            padded = self._padded_rows(ids)
            if padded is not None:
                S._arena_boost(self.state, padded, self._now(now), boost)

    def apply_boosts(self, entries: Dict[str, Tuple[int, int, float]],
                     acc_boost: float, nbr_boost: float) -> None:
        """Flush deferred (access_count, neighbor_count, latest_now) boost
        counters in one scatter."""
        with self._lock:
            rows, accs, nbrs, nows = [], [], [], []
            for qid, (acc, nbr, now) in entries.items():
                r = self.id_to_row.get(qid)
                if r is None:
                    continue
                rows.append(r)
                accs.append(int(acc))
                nbrs.append(int(nbr))
                nows.append(float(now) - self.epoch)
            if not rows:
                return
            padded = S.pad_rows(np.asarray(rows, np.int32), self.state.capacity)
            b = len(padded)
            acc_arr = np.zeros((b,), np.int32)
            acc_arr[:len(accs)] = accs
            nbr_arr = np.zeros((b,), np.int32)
            nbr_arr[:len(nbrs)] = nbrs
            now_arr = np.full((b,), S.NEG_INF, np.float32)   # pad: max no-op
            now_arr[:len(nows)] = nows
            S._arena_apply_boosts(self.state, padded, acc_arr, nbr_arr, now_arr,
                                  acc_boost, nbr_boost)

    def merge_touch(self, ids: Sequence[str], candidate_saliences: Sequence[float],
                    now: Optional[float] = None) -> None:
        """Dedup merge: salience = max(old, candidate), access + 1, refresh."""
        with self._lock:
            rows, sals = [], []
            for i, s in zip(ids, candidate_saliences):
                if i in self.id_to_row:
                    rows.append(self.id_to_row[i])
                    sals.append(float(s))
            if not rows:
                return
            padded = S.pad_rows(np.asarray(rows, np.int32), self.state.capacity)
            sal = np.zeros((len(padded),), np.float32)
            sal[:len(sals)] = sals
            S._arena_merge_touch(self.state, padded, sal, self._now(now))

    def decay(self, tenant: str, rate: float, salience_floor: float = 0.2) -> None:
        """Per-tenant decay tick: arena salience and edge weights."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return
        with self._lock:
            S._decay_fused(self.state, self.edge_state, tid, rate, salience_floor)

    def evict_candidates(self, tenant: str, k: int, now: Optional[float] = None,
                         weights: Tuple[float, float, float] = (0.5, 0.3, 0.2)
                         ) -> List[Tuple[str, float]]:
        """k least-important (id, importance) pairs for a tenant."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return []
        with self._lock:
            k_bucket = min(self.state.capacity,
                           max(8, 1 << (max(1, k - 1)).bit_length()))
            imps, rows = S.arena_evict_candidates(
                self.state, tid, self._now(now), *weights, k_bucket)
        out = []
        for imp, r in zip(imps.cpu().numpy(), rows.cpu().numpy()):
            if not np.isfinite(imp):
                continue
            node_id = self.row_to_id.get(int(r))
            if node_id is not None:
                out.append((node_id, float(imp)))
        return out[:k]

    def _prune_cap(self) -> int:
        """Compaction bucket of the prune: pow2 of the live edge count,
        floored at 256, grows only, capped at the pool size."""
        cap = min(self.edge_state.capacity,
                  max(256, next_pow2(max(1, len(self.edge_slots))),
                      self._prune_cap_hwm))
        self._prune_cap_hwm = cap
        return cap

    def _reclaim_pruned_slots(self, pruned_slots: np.ndarray
                              ) -> List[Tuple[str, str]]:
        removed = []
        by_slot = self.edge_slots.by_slot
        for slot in pruned_slots.tolist():
            if slot < 0:
                break                      # the compacted prefix ends here
            key = by_slot.get(int(slot))
            if key is None:
                continue
            removed.append(key)
            self._free_edge_slots.append(self.edge_slots.pop(key))
        return removed

    # ---------------------------------------------------------------- links
    def link_candidates_multi(self, new_ids: Sequence[str], tenant: str,
                              k: int = 3, shard_modes: Sequence[int] = (1, 0)
                              ) -> Dict[int, Dict[str, List[Tuple[str, float]]]]:
        """Per new node and shard mode, its top-k (existing_id, cosine)
        candidates among the tenant's other rows; every mode masks one score
        matrix per query chunk."""
        rows = [self.id_to_row[i] for i in new_ids if i in self.id_to_row]
        tid = self._tenants.get(tenant)
        if not rows or tid is None:
            return {sm: {} for sm in shard_modes}
        all_rows = np.asarray(rows, np.int32)
        with self._lock:
            padded = S.pad_rows(all_rows, self.state.capacity)
            flat = [t.cpu().numpy() for t in S.arena_link_candidates_multi(
                self.state, padded, padded, tid, min(k, self.state.capacity),
                tuple(shard_modes))]
        result: Dict[int, Dict[str, List[Tuple[str, float]]]] = {}
        for i, sm in enumerate(shard_modes):
            scores, cand = flat[2 * i], flat[2 * i + 1]
            out: Dict[str, List[Tuple[str, float]]] = {}
            for bi, node_row in enumerate(all_rows.tolist()):
                pairs = []
                for s, c in zip(scores[bi], cand[bi]):
                    if s <= S.NEG_INF / 2:
                        continue
                    cid = self.row_to_id.get(int(c))
                    if cid is not None:
                        pairs.append((cid, float(s)))
                out[self.row_to_id[node_row]] = pairs
            result[sm] = out
        return result

    def link_candidates(self, new_ids: Sequence[str], tenant: str, k: int = 3,
                        shard_mode: int = 0) -> Dict[str, List[Tuple[str, float]]]:
        """Single-mode view of :meth:`link_candidates_multi`."""
        return self.link_candidates_multi(new_ids, tenant, k,
                                          (shard_mode,))[shard_mode]

    # ---------------------------------------------------------------- reads
    def mean_embedding(self, ids: Sequence[str]) -> np.ndarray:
        padded = self._padded_rows(ids)
        if padded is None:
            return np.zeros((self.dim,), np.float32)
        with self._lock:
            return S.arena_mean_embedding(self.state, padded).cpu().numpy()

    def get_embedding(self, node_id: str) -> Optional[np.ndarray]:
        r = self.id_to_row.get(node_id)
        if r is None:
            return None
        return self.state.emb[r].float().cpu().numpy()

    def pull_numeric(self) -> Dict[str, np.ndarray]:
        """Bulk readback of the mutable numeric columns."""
        st = self.state
        return {"salience": st.salience.cpu().numpy(),
                "last_accessed": st.last_accessed.cpu().numpy() + self.epoch,
                "access_count": st.access_count.cpu().numpy()}

    def pull_numeric_rows(self, rows: Sequence[int]) -> Dict[str, np.ndarray]:
        """``pull_numeric`` for the given rows only."""
        st = self.state
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return {"salience": st.salience[r].cpu().numpy(),
                "last_accessed": st.last_accessed[r].cpu().numpy() + self.epoch,
                "access_count": st.access_count[r].cpu().numpy()}

    def edge_weights_for(self, keys: Sequence[Tuple[str, str]]
                         ) -> Dict[Tuple[str, str], Tuple[float, int]]:
        """(weight, co) of the given edge keys."""
        present = [(k, self.edge_slots[k]) for k in keys if k in self.edge_slots]
        if not present:
            return {}
        slots = torch.as_tensor([s for _, s in present], device=self.device)
        w = self.edge_state.weight[slots].cpu().numpy()
        co = self.edge_state.co[slots].cpu().numpy()
        return {k: (float(w[i]), int(co[i])) for i, (k, _) in enumerate(present)}

    def edge_weights(self) -> Dict[Tuple[str, str], Tuple[float, int]]:
        """(weight, co) of every edge."""
        w = self.edge_state.weight.cpu().numpy()
        co = self.edge_state.co.cpu().numpy()
        return {k: (float(w[s]), int(co[s])) for k, s in self.edge_slots.items()}

    # ---------------------------------------------------------------- edges
    def _alloc_edge_slots(self, n: int) -> List[int]:
        while len(self._free_edge_slots) < n:
            old = self.edge_state.capacity
            new = self._grown_capacity(old, block=False)
            self.edge_state = S.grow_edges(self.edge_state, new)
            self._free_edge_slots = list(range(new - 1, old - 1, -1)) + self._free_edge_slots
        return [self._free_edge_slots.pop() for _ in range(n)]

    def add_edges(self, triples: Sequence[Tuple[str, str, float]], tenant: str,
                  reinforce: float = 0.1, now: Optional[float] = None) -> None:
        """(src_id, tgt_id, weight) batch. Existing edges are reinforced
        (+reinforce capped at 1, co + 1); new ones inserted. A key repeated
        within the batch inserts once, then reinforces."""
        now = self._now(now)
        with self._lock:
            new, existing = [], []
            pending = set()
            for src, tgt, w in triples:
                if src not in self.id_to_row or tgt not in self.id_to_row:
                    continue
                key = (src, tgt)
                if key in self.edge_slots:
                    existing.append(self.edge_slots[key])
                elif key in pending:
                    existing.append(key)        # slot resolved after the insert
                else:
                    pending.add(key)
                    new.append((key, w))
            if new:
                slots = self._alloc_edge_slots(len(new))
                for (key, _), slot in zip(new, slots):
                    self.edge_slots[key] = slot
                padded = S.pad_rows(np.asarray(slots, np.int32),
                                    self.edge_state.capacity)
                b = len(padded)
                src_r = np.full((b,), -1, np.int32)
                tgt_r = np.full((b,), -1, np.int32)
                w = np.zeros((b,), np.float32)
                live = np.zeros((b,), bool)
                for i, ((s_id, t_id), wt) in enumerate(new):
                    src_r[i] = self.id_to_row[s_id]
                    tgt_r[i] = self.id_to_row[t_id]
                    w[i] = wt
                    live[i] = True
                S._edges_add(self.edge_state, padded, src_r, tgt_r, w,
                             np.ones((b,), np.int32), now,
                             self.tenant_id(tenant), live)
            if existing:
                slots = [self.edge_slots[s] if isinstance(s, tuple) else s
                         for s in existing]
                padded = S.pad_rows(np.asarray(slots, np.int32),
                                    self.edge_state.capacity)
                S._edges_reinforce(self.edge_state, padded, reinforce, now)

    def prune_edges(self, tenant: str, threshold: float) -> List[Tuple[str, str]]:
        """Drop the tenant's edges under ``threshold``; returns their keys."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return []
        with self._lock:
            _, slots = S._edges_prune(self.edge_state, tid, threshold,
                                      self._prune_cap())
            return self._reclaim_pruned_slots(slots.cpu().numpy())
