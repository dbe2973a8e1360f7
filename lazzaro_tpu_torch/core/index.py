"""MemoryIndex: host bookkeeping around the device arena, in torch.

Counterpart of the dense subset of ``lazzaro_tpu/core/index.py``: string
id <-> row maps, free lists, capacity growth and sentinel padding on the
host; every numeric column on the device (``core.state``). Classic search
runs the masked top-k kernel on a CUDA arena; fused serving
(:meth:`MemoryIndex.search_fused_requests`) runs a whole request batch as
one launch of the two-tier kernel plus plain torch on the device, and reads
back one packed array. Mutations update the index's own tensors in place
under one lock.

``MemoryIndex(mesh=...)`` row-shards the arena over the mesh's ``data`` axis
(``parallel.mesh``), as the JAX index does with GSPMD: one ``ArenaState``
per shard on its device, holding the global rows ``[p * L, (p + 1) * L)``.
Writes are split by owner on the host and run the single-device ops on the
owning shards with local rows; searches run each shard's scan kernel and
merge the candidates on the first device (``ops.topk.make_sharded_topk``,
``core.state.search_fused_sharded``). The edge arena stays whole on the
first device.
"""

from __future__ import annotations

import math
import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.core import state as S
from lazzaro_tpu_torch.ops import graphops
from lazzaro_tpu_torch.ops.int8_topk import int8_topk
from lazzaro_tpu_torch.ops.ivf import (assignment_staleness, build_ivf,
                                       ivf_search, online_counts, pack_extras,
                                       packed_len)
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.ops.sharded_merge import sharded_merge
from lazzaro_tpu_torch.reliability.errors import ArenaPoisoned
from lazzaro_tpu_torch.reliability.guard import (check_not_poisoned,
                                                 run_guarded)
from lazzaro_tpu_torch.ops.topk import make_sharded_topk
from lazzaro_tpu_torch.serve.scheduler import RetrievalRequest, RetrievalResult
from lazzaro_tpu_torch.utils.batching import (bucket_size, decode_topk,
                                              empty_results, next_pow2,
                                              pad_to_bucket, pad_to_pow2,
                                              unpack_retrieval)
from lazzaro_tpu_torch.utils.device import resolve_device
from lazzaro_tpu_torch.utils.telemetry import (default_registry,
                                               record_device_counters)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported arena dtype {dtype!r}")
    return _DTYPES[name]


def build_host_csr(edge_keys, id_to_row: Dict[str, int], n: int,
                   min_pad: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of the edge graph over ``n`` arena rows from host bookkeeping
    alone (``lazzaro_tpu/core/index.py:build_host_csr``): ``(indptr [n+1]
    i32, nbr [E_pad] i32)``, both directions of every ``(src_id, tgt_id)``
    key, neighbors in stable source order, ``nbr`` -1-padded to a power of
    two never below ``min_pad``."""
    src_l, dst_l = [], []
    for qsrc, qtgt in edge_keys:
        s = id_to_row.get(qsrc)
        t = id_to_row.get(qtgt)
        if s is None or t is None:
            continue
        src_l.append(s)
        dst_l.append(t)
    if src_l:
        a = np.asarray(src_l, np.int64)
        b = np.asarray(dst_l, np.int64)
        src = np.concatenate([a, b])
        dst = np.concatenate([b, a])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
    else:
        src = dst = np.zeros((0,), np.int64)
    indptr = np.zeros((n + 1,), np.int32)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    nbr = np.full((max(8, int(min_pad), next_pow2(len(dst))),), -1, np.int32)
    nbr[:len(dst)] = dst
    return indptr, nbr


def split_csr(indptr: np.ndarray, nbr: np.ndarray, n_shards: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-shard a global CSR (``lazzaro_tpu/core/index.py:split_csr``):
    shard ``p`` gets the neighbor lists of its own rows ``[p * L, (p + 1) *
    L)`` with offsets rebased to its slice; neighbor ids stay global.
    Returns ``(indptr_sh [n, L + 1] i32, nbr_sh [n, E_max] i32)``, every
    shard's neighbor array padded to one power-of-two bucket."""
    n_rows = indptr.shape[0] - 1
    assert n_rows % n_shards == 0
    L = n_rows // n_shards
    indptr_sh = np.zeros((n_shards, L + 1), np.int32)
    parts = []
    for p in range(n_shards):
        lo, hi = indptr[p * L], indptr[(p + 1) * L]
        indptr_sh[p] = indptr[p * L:(p + 1) * L + 1] - lo
        parts.append(np.asarray(nbr[lo:hi], np.int32))
    e_max = max(8, next_pow2(max(len(x) for x in parts)))
    nbr_sh = np.full((n_shards, e_max), -1, np.int32)
    for p, x in enumerate(parts):
        nbr_sh[p, :len(x)] = x
    return indptr_sh, nbr_sh


def link_pool_size(worst: int, hint: float) -> int:
    """Edge-slot pool of the compacting fused ingest
    (``lazzaro_tpu/core/index.py:link_pool_size``): ``ceil(hint * worst)``
    real slots instead of the worst case, floored at one slot so that the
    overflow path, not an empty gather, handles a zero hint."""
    h = float(hint)
    if h >= 1.0 or worst <= 0:
        return worst
    return min(worst, max(1, int(np.ceil(max(0.0, h) * worst))))


def link_pool_dev(pool: Sequence[int], padded_len: int, ecap: int) -> np.ndarray:
    """The slot pool as the fused ingest takes it on the device
    (``lazzaro_tpu/core/index.py:link_pool_dev``; uploaded with the batch):
    real slots first, sentinel (``ecap``) padding up to ``padded_len``, and
    one trailing sentinel entry every rejected candidate is routed
    through."""
    arr = np.full((padded_len + 1,), ecap, np.int32)
    arr[:len(pool)] = pool
    return arr


_CONSOLIDATION_MESH = ("MemoryIndex(mesh=...).merge_candidates: the all-pairs "
                       "merge scan under a mesh is not ported yet (ROADMAP "
                       "Queue 1 item 21)")

_INT8_MESH = ("MemoryIndex(mesh=..., int8_serving=True): the int8 serving "
              "shadow under a mesh (make_sharded_int8_topk and the fused "
              "program's sharded_quant mode) is not ported yet (ROADMAP Queue "
              "1 item 21)")

_FUSED_INGEST_MESH = ("MemoryIndex(mesh=...): the fused ingest under a mesh is "
                      "not ported yet (ROADMAP Queue 1 item 21, sharded fused "
                      "ingest); use the classic ingest")


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


class HostStage:
    """Host arrays to the device in one copy: :meth:`upload` packs them into
    one byte buffer, copies it asynchronously and returns a device view of
    each array (no further copy), so serving never waits on the device here.
    On a GPU the buffer is pinned and reused across uploads (a fused
    dispatch's inputs); it is written again only once the copy that last
    read it has run (a CUDA event, polled, never waited on), and otherwise a
    fresh pinned buffer takes its place."""

    ALIGN = 16

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None
        self._done = None
        self.allocations = 0

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.empty((nbytes,), dtype=torch.uint8)
        buf = self._buf
        if (buf is None or buf.numel() < nbytes
                or (self._done is not None and not self._done.query())):
            buf = torch.empty((next_pow2(max(nbytes, 4096)),),
                              dtype=torch.uint8, pin_memory=True)
            self._buf = buf
            self.allocations += 1
        return buf

    def upload(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        arrays, offs, total = _layout(arrays)
        buf = self._host_buffer(total)
        _pack(buf[:total].numpy(), arrays, offs)
        if self.device.type == "cuda":
            dev = buf[:total].to(self.device, non_blocking=True)
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
        else:
            dev = buf[:total]
        return _views(dev, arrays, offs)


def _layout(arrays: Sequence[np.ndarray]):
    """The arrays made contiguous, their byte offsets in one buffer
    (``HostStage.ALIGN``-aligned) and its size."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // HostStage.ALIGN) * HostStage.ALIGN
    return arrays, offs, total


def _pack(host: np.ndarray, arrays, offs) -> None:
    for a, off in zip(arrays, offs):
        host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)


def _views(dev: torch.Tensor, arrays, offs) -> List[torch.Tensor]:
    return [dev[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
            for a, off in zip(arrays, offs)]


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


def upload_once(arrays: Sequence[np.ndarray], device: torch.device
                ) -> List[torch.Tensor]:
    """``arrays`` on ``device`` through one host-to-device copy of one
    pageable buffer that packs them (a tenant's reload moves its rows this
    way, not through ``HostStage``'s kept pinned buffer); returns a device
    view of each."""
    arrays, offs, total = _layout(arrays)
    host = np.empty((max(total, 1),), np.uint8)
    _pack(host, arrays, offs)
    return _views(torch.from_numpy(host).to(device), arrays, offs)


class MemoryIndex:
    """Dense arena index. ``device`` defaults to CUDA and raises without a
    GPU; pass ``device="cpu"`` for the plain versions. With ``mesh`` (a
    ``parallel.mesh.Mesh``) the arena is row-sharded over its devices, which
    replace ``device`` (passing both raises unless ``device`` is the mesh's
    first device)."""

    _MESH_SEARCHERS = 16           # make_sharded_topk closures kept, per k

    def __init__(self, dim: int, capacity: int = 1024, edge_capacity: int = 8192,
                 dtype=torch.float32, epoch: Optional[float] = None,
                 device=None, telemetry=None, serve_ragged: bool = True,
                 serve_k_max: int = 128, serve_pad_granularity: int = 8,
                 mesh=None, int8_serving: bool = False, coarse_slack: int = 8,
                 ivf_nprobe: int = 0, ivf_online: bool = True,
                 ivf_member_cap_factor: int = 4, ivf_online_eta: float = 1.0,
                 dispatch_retry_max: int = 2,
                 dispatch_retry_backoff_s: float = 0.005):
        if mesh is not None and int8_serving:
            raise NotImplementedError(_INT8_MESH)
        self.mesh = mesh
        self.shard_axis = mesh.axis_names[0] if mesh is not None else None
        self._n_parts = mesh.size if mesh is not None else 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices[0]
            want = torch.device(device) if device is not None else None
            if want is not None and (want.type != self.device.type or (
                    want.index is not None and want != self.device)):
                raise ValueError(f"MemoryIndex: device {device} is not the "
                                 f"mesh's first device {self.device}")
        self._mesh_topk: "OrderedDict[int, object]" = OrderedDict()
        self.telemetry = telemetry if telemetry is not None \
            else default_registry()
        # Ragged serving: per-request k and cap ride as device columns and
        # the kernel computes to the serve_k_max ceiling; batches pad to
        # linear serve_pad_granularity buckets.
        self.serve_ragged = bool(serve_ragged)
        self.serve_k_max = max(1, int(serve_k_max))
        self.serve_pad_granularity = max(1, int(serve_pad_granularity))
        # Device CSR of the edge graph for the fused neighbor gather, rebuilt
        # from host bookkeeping after an edge or row change (_csr_dirty).
        self._csr_cache = None             # (rows, indptr_dev, nbr_dev)
        self._stage = HostStage(self.device)   # a fused dispatch's upload
        self._csr_dirty = True
        self._csr_pad_hwm = 0
        self.csr_builds = 0
        self.csr_build_s = 0.0
        self.dim = dim
        self.dtype = torch_dtype(dtype)
        self._lock = threading.RLock()
        # Timestamps are stored relative to this epoch so f32 keeps
        # sub-second precision.
        self.epoch = float(epoch if epoch is not None else time.time())
        capacity = self._round_capacity(capacity)
        edge_capacity = self._round_capacity(edge_capacity, block=False)
        self.state: Optional[S.ArenaState] = None
        self.shards: List[S.ArenaState] = []
        if mesh is None:
            self.state = S.init_arena(capacity, dim, self.dtype, self.device)
        else:
            self.shards = S.init_shards(capacity, dim, self.dtype, mesh.devices)
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
        self.lifecycle_dispatch_count = 0
        # Rows holding a super node, from host bookkeeping (``add`` and
        # ``ingest_batch`` flags, ``delete``); the frozen tuple changes only
        # with the set.
        self._super_rows: set = set()
        self._super_rows_frozen: tuple = ()
        # Fused ingest: dispatches (one per batch; tests and the smoke count
        # them), batches whose accepted links overflowed the hinted pool, and
        # the batch upload's own staging buffer.
        self.ingest_dispatch_count = 0
        self.link_pool_overflows = 0
        self._ingest_stage = HostStage(self.device)
        # Int8 serving (ops/quant.py): the shadow (codes [cap+1, d] i8,
        # scales [cap+1] f32) that quantized serving scans, rebuilt lazily
        # from the arena only after a write that did not maintain it (add,
        # growth, an ingest without the shadow); metadata writes leave the
        # vectors alone and the mask is read fresh at every search. The
        # fused programs fetch k + coarse_slack coarse candidates before
        # the exact rescore.
        self.int8_serving = bool(int8_serving)
        self.coarse_slack = max(0, int(coarse_slack))
        self._int8_shadow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._int8_dirty = True
        # IVF serving (ops/ivf.py, ``lazzaro_tpu/core/index.py:460-502``):
        # ivf_nprobe > 0 serves searches through the centroid prefilter and
        # K5's member scan once ``ivf_maintenance`` has published a build.
        # Rows written after a build serve exactly from the fresh residual
        # (or, with online IVF, append to their clusters inside the fused
        # ingest); delete un-routes freed member slots, so a reused slot
        # joins the fresh residual. The (build, fresh rows) pair is one
        # tuple; ``_ivf_routed`` / ``_ivf_in_residual`` / ``_ivf_stale`` are
        # the writer's bookkeeping. One device only: a mesh warns and
        # serves the exact sharded path, as the JAX index does.
        if ivf_nprobe and mesh is not None:
            warnings.warn(
                "ivf_serving is single-device only (the mesh path searches "
                "the exact sharded arena); the flag is ignored under a mesh",
                stacklevel=3)
        self.ivf_nprobe = int(ivf_nprobe) if mesh is None else 0
        self._ivf_pack: Optional[tuple] = None   # (IvfIndex, fresh rows tuple)
        self._ivf_routed: Optional[np.ndarray] = None
        self._ivf_in_residual: Optional[np.ndarray] = None
        self._ivf_stale = 0
        self._ivf_res_cache = None
        self._ivf_serve_cache = None
        self._ivf_occ_cache = None         # (sealed members, their occupancy)
        self._ivf_res_host = None          # (residual tensor, its host copy)
        # Rows added or deleted while a build runs outside the state lock
        # (ivf_maintenance); None when no build is running.
        self._ivf_touched: Optional[set] = None
        # Online IVF: the live (cent [C, d] f32, members [C, M] i32, counts
        # [C] i32) that both fused ingests update in place in their one
        # dispatch, and serving reads.
        self.ivf_online = bool(ivf_online) and self.ivf_nprobe > 0
        self.ivf_member_cap_factor = max(1, int(ivf_member_cap_factor))
        self.ivf_online_eta = float(ivf_online_eta)
        self._ivf_dev: Optional[Tuple[torch.Tensor, ...]] = None
        # The state dispatch guard (reliability.guard): retries of a program
        # that failed before its first write, and the poisoned flag of one
        # that failed after it.
        self.dispatch_retry_max = max(0, int(dispatch_retry_max))
        self.dispatch_retry_backoff_s = float(dispatch_retry_backoff_s)
        self._poisoned = False

    @classmethod
    def from_numpy(cls, arena: Dict[str, np.ndarray],
                   edges: Dict[str, np.ndarray], meta: Dict, device=None,
                   mesh=None, **kwargs) -> "MemoryIndex":
        """Build an index from another index's state as numpy arrays: every
        ``ArenaState``/``EdgeState`` column, and ``meta`` with ``id_to_row``,
        ``tenants``, ``shards``, ``edge_slots``, ``free_rows``,
        ``free_edge_slots`` and optionally ``epoch`` (the JAX index's
        ``_tenants``, ``_shards``, ``_free_rows``, ... under these names).
        With ``mesh`` each column is split by owner shard (the row count
        must divide by the mesh size). ``kwargs`` go to the constructor
        (the serving settings)."""
        emb = arena["emb"]
        idx = cls(emb.shape[1], capacity=8, edge_capacity=8,
                  dtype=emb.dtype.name, epoch=meta.get("epoch"), device=device,
                  mesh=mesh, **kwargs)
        if mesh is None:
            idx.state = S.arena_from_numpy(arena, idx.device)
        else:
            idx.shards = S.shards_from_numpy(arena, mesh.devices)
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

    # ---------------------------------------------------------------- guard
    @property
    def poisoned(self) -> bool:
        """True once a state program failed after its first in-place write:
        the device state is torn. Reload the last checkpoint and replay the
        ingest journal."""
        return self._poisoned

    def _guarded(self, call, states, mode: str):
        """Run one state program through ``reliability.guard.run_guarded``
        (``lazzaro_tpu/core/index.py:_guarded``): a failure before its first
        write is retried, an allocation failure raises ``DeviceOom``, a torn
        state poisons the index and raises ``ArenaPoisoned``."""
        check_not_poisoned(self._poisoned)
        try:
            return run_guarded(call, states, telemetry=self.telemetry,
                               mode=mode, retries=self.dispatch_retry_max,
                               backoff_s=self.dispatch_retry_backoff_s)
        except ArenaPoisoned:
            self._poisoned = True
            raise

    def _arena_states(self):
        return (self.state,) if self.mesh is None else (self.shards,)

    # ------------------------------------------------------------- int8
    def _int8_shadow_for(self, st: S.ArenaState):
        """The int8 shadow of ``st``, (re)built from that one arena snapshot
        when no maintained one matches it
        (``lazzaro_tpu/core/index.py:_int8_shadow_for``). Called under the
        state lock."""
        shadow = self._int8_shadow
        if (not self._int8_dirty and shadow is not None
                and shadow[0].shape[0] == st.salience.shape[0]):
            return shadow
        shadow = quantize_rows(st.emb)
        self._int8_shadow = shadow
        if self.state is st:
            self._int8_dirty = False
        return shadow

    def _ingest_shadow_arg(self):
        """The shadow the fused ingest maintains in place, or None when there
        is nothing valid to maintain (int8 off, shadow absent or stale, or
        the arena grew since it was built): the ingest then marks it
        dirty."""
        shadow = self._int8_shadow
        if (not self.int8_serving or self._int8_dirty or shadow is None
                or shadow[0].shape[0] != self.state.salience.shape[0]):
            return None
        return shadow

    # ------------------------------------------------------------------ ivf
    @property
    def _ivf(self):
        pack = self._ivf_pack
        return pack[0] if pack is not None else None

    @_ivf.setter
    def _ivf(self, v) -> None:
        """Publish a build (or drop it with None) with its routed bitmaps
        and online tables, every per-build cache cleared
        (``lazzaro_tpu/core/index.py:_ivf``)."""
        self._ivf_res_cache = None
        self._ivf_serve_cache = None
        self._ivf_occ_cache = None
        self._ivf_stale = 0
        if v is None:
            self._ivf_routed = self._ivf_in_residual = None
            self._ivf_pack = None
            self._ivf_dev = None
            return
        self._ivf_routed, self._ivf_in_residual = self._routed_bitmaps(v)
        self._ivf_pack = (v, ())
        self._publish_online_tables(v)

    def _publish_online_tables(self, ivf) -> None:
        """Seed the live online tables from a build: copies of its centroids
        and members, and each cluster's occupancy as its append cursor."""
        if not self.ivf_online:
            self._ivf_dev = None
            return
        self._ivf_dev = (ivf.centroids.float().clone(),
                         ivf.members.int().clone(), online_counts(ivf.members))

    def _routed_bitmaps(self, ivf) -> Tuple[np.ndarray, np.ndarray]:
        """``(routed, in_sealed_residual)`` bool bitmaps over the arena's
        rows for a build."""
        n = self.state.salience.shape[0]
        routed = np.zeros((n,), bool)
        m = ivf.members.cpu().numpy().ravel()
        routed[m[(m >= 0) & (m < n)]] = True
        r = self._residual_host(ivf)
        in_res = np.zeros((n,), bool)
        in_res[r[(r >= 0) & (r < n)]] = True
        routed |= in_res
        return routed, in_res

    def _residual_host(self, ivf) -> np.ndarray:
        """The build's residual on the host, copied once per residual
        buffer (at publish time), so that serving never waits on a copy."""
        cached = self._ivf_res_host
        if cached is None or cached[0] is not ivf.residual:
            cached = (ivf.residual, ivf.residual.cpu().numpy())
            self._ivf_res_host = cached
        return cached[1]

    @property
    def _ivf_fresh(self) -> List[int]:
        pack = self._ivf_pack
        return list(pack[1]) if pack is not None else []

    def _ivf_online_arg(self):
        """The live online tables the fused ingest updates in place, or None
        (online IVF off, or no build yet). Called under the state lock."""
        return self._ivf_dev if self.ivf_online else None

    def _routed_grown(self) -> Optional[np.ndarray]:
        """The routed bitmap, extended to the arena's rows once it grew."""
        routed = self._ivf_routed
        n = self.state.salience.shape[0]
        if routed is not None and len(routed) < n:
            grown = np.zeros((n,), bool)
            grown[:len(routed)] = routed
            self._ivf_routed = routed = grown
        return routed

    def _ivf_note_added(self, rows: Sequence[int]) -> None:
        """Rows just written join the fresh residual, each once
        (``lazzaro_tpu/core/index.py:_ivf_note_added``)."""
        self._ivf_touch(rows)
        pack = self._ivf_pack
        if not self.ivf_nprobe or pack is None:
            return
        ivf, fresh = pack
        routed = self._routed_grown()
        appended = []
        for r in rows:
            if routed is None or not routed[r]:
                appended.append(r)
                if routed is not None:
                    routed[r] = True
        if appended:
            self._ivf_pack = (ivf, fresh + tuple(appended))

    def _ivf_note_online(self, rows: Sequence[int], live: Sequence[bool],
                         ivf_host) -> None:
        """Host bookkeeping of the online update a fused ingest ran
        (``lazzaro_tpu/core/index.py:_ivf_note_online``): appended rows are
        routed, rows whose cluster was full (slot -1) go to the exact-scan
        extras (``ivf.member_overflows``); the counters of the readback's
        IVF leaves go to telemetry."""
        self._ivf_touch([r for r, lv in zip(rows, live) if lv])
        pos_w = ivf_host[1]
        appended, spilled = [], []
        for i, (r, lv) in enumerate(zip(rows, live)):
            if lv:
                (appended if int(pos_w[i, 0]) >= 0 else spilled).append(r)
        if appended:
            routed = self._routed_grown()
            if routed is not None:
                routed[appended] = True
        tel = self.telemetry
        if spilled:
            tel.bump("ivf.member_overflows", len(spilled))
            self._ivf_note_added(spilled)
        dev = self._ivf_dev
        if dev is not None:
            slots = int(dev[1].shape[0]) * int(dev[1].shape[1])
            tel.gauge("ivf.member_pool_occupancy",
                      float(ivf_host[3][0, 0]) / max(slots, 1))
        tel.bump("ivf.appends", int(ivf_host[4][0, 0]))
        tel.bump("ivf.centroid_shift_ppm", int(ivf_host[5][0, 0]))

    def _ivf_note_deleted(self, rows: Sequence[int]) -> None:
        """Un-route freed rows (``lazzaro_tpu/core/index.py:delete``): a
        fresh-residual row leaves the fresh tuple, a sealed-residual row
        stays (the residual scans the slot's current vector), a member row
        is un-routed and counts toward the re-seed trigger."""
        self._ivf_touch(rows)
        routed = self._ivf_routed
        if routed is None:
            return
        pack = self._ivf_pack
        fresh_set = set(pack[1]) if pack is not None else set()
        in_res = self._ivf_in_residual
        dropped = set()
        for r in rows:
            if r >= len(routed) or not routed[r]:
                continue
            if r in fresh_set:
                routed[r] = False
                dropped.add(r)
            elif in_res is not None and r < len(in_res) and in_res[r]:
                pass
            else:
                routed[r] = False
                self._ivf_stale += 1
        if dropped:
            self._ivf_pack = (pack[0], tuple(x for x in pack[1]
                                             if x not in dropped))

    def _ivf_touch(self, rows: Sequence[int]) -> None:
        """Record rows written or freed while a build runs."""
        touched = self._ivf_touched
        if touched is not None:
            touched.update(int(r) for r in rows)

    # Below this many live rows an exact scan is cheap and a k-means build
    # pure overhead.
    _IVF_MIN_ROWS = 4096

    def ivf_maintenance(self, iters: int = 8) -> bool:
        """Build or re-seed the coarse index (``lazzaro_tpu/core/index.py:
        ivf_maintenance``); True if a (re)build ran. The only place the
        k-means runs: the consolidation's maintenance calls it, never a
        serving query. Without online IVF it rebuilds once the fresh rows
        and the deleted member slots pass a quarter of the build. With
        online IVF the ingests keep the assignments, so it re-seeds only
        when the ideal cluster count (sqrt of the live rows) drifted 2x
        from the live table's, or churn passed that quarter; otherwise it
        compacts the tables' holes (:meth:`ivf_member_repack`).

        The build runs outside the state lock, so serving and ingests go on
        meanwhile: it clusters the rows alive when it starts, and the rows
        added or freed while it ran are replayed onto it as it is published
        (freed member rows un-routed, added rows in the fresh residual), as
        the JAX index builds from an immutable snapshot."""
        if not self.ivf_nprobe:
            return False
        n_alive = len(self.id_to_row)
        if n_alive < self._IVF_MIN_ROWS:
            return False
        pack = self._ivf_pack
        if pack is not None:
            churn = len(pack[1]) + self._ivf_stale
            if self.ivf_online and self._ivf_dev is not None:
                cur_c = max(1, int(self._ivf_dev[0].shape[0]))
                want_raw = max(4, int(np.sqrt(n_alive)))
                count_changed = want_raw >= 2 * cur_c or 4 * want_raw <= cur_c
                if not count_changed and churn <= pack[0].built_rows // 4:
                    self.ivf_member_repack()
                    return False
            elif churn <= pack[0].built_rows // 4:
                return False
        with self._lock:
            if self._ivf_touched is not None:
                return False                    # a build is running
            st = self.state
            mask = st.alive.cpu().numpy().copy()   # not a view of the column
            self._ivf_touched = set()
        try:
            ivf = build_ivf(st.emb, mask, iters=iters,
                            member_cap_factor=self.ivf_member_cap_factor)
        except BaseException:
            with self._lock:
                self._ivf_touched = None
            raise
        with self._lock:
            touched = sorted(self._ivf_touched)
            self._ivf_touched = None
            self._ivf = ivf
            alive = self.state.alive.cpu().numpy()
            self._ivf_note_deleted(touched)
            self._ivf_note_added([r for r in touched if alive[r]])
        return True

    def ivf_member_repack(self, hole_frac: float = 0.25) -> bool:
        """Compact the holes out of the live member tables
        (``lazzaro_tpu/core/index.py:ivf_member_repack``): slots of deleted
        rows move behind each cluster's live rows and the append cursors
        reset to the live counts, once holes pass ``hole_frac`` of the
        occupied slots. True if it ran (``ivf.member_repacks``,
        ``ivf.member_holes_reclaimed``)."""
        with self._lock:
            dev = self._ivf_dev
            if dev is None:
                return False
            members = dev[1].cpu().numpy()
            counts = dev[2].cpu().numpy()
            alive = self.state.alive.cpu().numpy()
            idx = np.arange(members.shape[1])[None, :]
            occ = idx < counts[:, None]
            row_ok = np.take(alive, np.clip(members, 0, len(alive) - 1))
            live = (members >= 0) & occ & row_ok
            n_occ = int(occ.sum())
            holes = n_occ - int(live.sum())
            if holes <= 0 or holes < hole_frac * max(1, n_occ):
                return False
            order = np.argsort(~live, axis=1, kind="stable")
            packed = np.take_along_axis(members, order, axis=1)
            new_counts = live.sum(axis=1).astype(counts.dtype)
            packed[idx >= new_counts[:, None]] = -1
            self._ivf_dev = (dev[0], torch.from_numpy(packed).to(self.device),
                             torch.from_numpy(new_counts).to(self.device))
        self.telemetry.bump("ivf.member_repacks")
        self.telemetry.bump("ivf.member_holes_reclaimed", holes)
        return True

    def ivf_staleness_probe(self) -> Optional[float]:
        """The fraction of live member slots whose row now picks another
        centroid (``lazzaro_tpu/core/index.py:ivf_staleness_probe``; the
        ``ivf.assignment_staleness`` gauge), or None without live tables.
        O(N * C): a diagnostic."""
        with self._lock:
            dev = self._ivf_dev
            if dev is None:
                return None
            st = self.state
            frac = assignment_staleness(st.emb, st.alive.cpu().numpy(),
                                        dev[0], dev[1])
        self.telemetry.gauge("ivf.assignment_staleness", frac)
        return frac

    def _ivf_residual_dev(self, ivf, fresh) -> Tuple[torch.Tensor, int]:
        """The sealed residual and the fresh rows as one padded device array
        (the classic search's extras) and its packed length (K5's
        ``n_extras``), uploaded again only when the build, the fresh tuple
        or the residual buffer changed (identity keys,
        ``lazzaro_tpu/core/index.py:_ivf_residual_dev``)."""
        cache = self._ivf_res_cache
        if (cache is not None and cache[0] is ivf and cache[1] is fresh
                and cache[2] is ivf.residual):
            return cache[3]
        host = pack_extras(self._residual_host(ivf), fresh, ())
        dev, = HostStage(self.device).upload([host])
        self._ivf_res_cache = (ivf, fresh, ivf.residual, (dev, packed_len(host)))
        return self._ivf_res_cache[3]

    def _ivf_extras_dev(self, ivf, fresh) -> Tuple[torch.Tensor, int]:
        """Fused serving's exact-scan extras: the sealed residual, the fresh
        rows and every super row (``ops.ivf.pack_extras``), and their packed
        length, cached on the same identities plus the super tuple's."""
        supers = self._super_rows_frozen
        cache = self._ivf_serve_cache
        if (cache is not None and cache[0] is ivf and cache[1] is fresh
                and cache[2] is ivf.residual and cache[3] is supers):
            return cache[4]
        n = self.state.salience.shape[0]
        host = pack_extras(self._residual_host(ivf), fresh,
                           [r for r in supers if r < n])
        dev, = HostStage(self.device).upload([host])
        self._ivf_serve_cache = (ivf, fresh, ivf.residual, supers,
                                 (dev, packed_len(host)))
        return self._ivf_serve_cache[4]

    def _ivf_live_tables(self, ivf):
        """``(centroids, members, occ)`` the scans read: the live online
        tables with their append cursors, else the sealed build's with its
        ``online_counts``, computed once per member table (K5's occupancy:
        both tables are dense prefixes, -1 from ``occ`` on)."""
        dev = self._ivf_dev
        if self.ivf_online and dev is not None:
            return dev
        cache = self._ivf_occ_cache
        if cache is None or cache[0] is not ivf.members:
            cache = (ivf.members, online_counts(ivf.members))
            self._ivf_occ_cache = cache
        return ivf.centroids, ivf.members, cache[1]

    def _ivf_fused_pack(self, k_kernel: int):
        """``(centroids, members, extras, nprobe, occ, n_extras)`` for fused
        IVF serving, or None to serve the dense fused path: IVF off, no
        build published, or fewer candidates than the kernel's k
        (``lazzaro_tpu/core/index.py:_ivf_fused_pack``)."""
        if not self.ivf_nprobe or self.mesh is not None:
            return None
        pack = self._ivf_pack
        if pack is None:
            return None
        ivf, fresh = pack
        extras, n_extras = self._ivf_extras_dev(ivf, fresh)
        cent, members, occ = self._ivf_live_tables(ivf)
        nprobe = min(self.ivf_nprobe, int(cent.shape[0]))
        if nprobe * members.shape[1] + extras.shape[0] < k_kernel:
            return None
        return cent, members, extras, nprobe, occ, n_extras

    def _ivf_search(self, q_pad: torch.Tensor, tid: int, k_eff: int,
                    super_filter: int):
        """The classic IVF search (``lazzaro_tpu/core/index.py:_ivf_search``):
        the coarse stage and K5's classic form over the members and the
        residual with the tenant mask, ``k + coarse_slack`` fetched (the
        decode drops repeats and trims); host ``(scores, rows)`` from one
        copy, or None to fall through to the exact scan (no build yet, the
        super-node filter, or fewer candidates than k). Called under the
        state lock."""
        pack = self._ivf_pack
        if pack is None or super_filter == 1:
            return None
        ivf, fresh = pack
        st = self.state
        residual, n_res = self._ivf_residual_dev(ivf, fresh)
        cent, members, occ = self._ivf_live_tables(ivf)
        n_cand = (min(self.ivf_nprobe, ivf.n_clusters) * members.shape[1]
                  + residual.shape[0])
        if n_cand < k_eff:
            return None
        k_fetch = min(k_eff + self.coarse_slack, n_cand)
        scores, rows = ivf_search(cent, members, residual, st.emb,
                                  S.arena_mask(st, tid, super_filter),
                                  S.normalize(q_pad.float()), k_fetch,
                                  nprobe=self.ivf_nprobe, occ=occ,
                                  n_extras=n_res)
        host = torch.cat([scores, rows.contiguous().view(torch.float32)],
                         dim=1).cpu().numpy()
        return host[:, :k_fetch], host[:, k_fetch:].view(np.int32)

    # ------------------------------------------------------------ capacity
    def _round_capacity(self, capacity: int, block: bool = True) -> int:
        """capacity + 1 rounds up to a TOPK_BLOCK multiple once it reaches a
        block (node arena only), and under a mesh to a multiple of
        ``lcm(that, n_shards)`` so the rows split evenly
        (``lazzaro_tpu/core/index.py:_round_capacity``), the JAX package's
        row layout."""
        total = capacity + 1
        multiple = S.TOPK_BLOCK if block and total >= S.TOPK_BLOCK else 1
        if self._n_parts > 1:
            multiple = math.lcm(multiple, self._n_parts)
        return -(-total // multiple) * multiple - 1

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
        if self.mesh is None:
            return self.state.capacity
        return self._n_parts * self._local_n - 1

    @property
    def _local_n(self) -> int:
        """Rows per shard under a mesh."""
        return self.shards[0].salience.shape[0]

    def _routes(self, rows):
        """``(shard state, sel, local rows)`` for each shard owning one of
        the global ``rows`` (``state.route_rows``); no other shard is
        touched, and no padding crosses a shard."""
        return [(self.shards[p], sel, loc)
                for p, sel, loc in S.route_rows(rows, self._local_n)]

    def _gather(self, name: str, rows) -> torch.Tensor:
        """Column ``name`` at the global ``rows``, gathered from their owner
        shards onto the first device, in the order given."""
        rows = np.asarray(rows, np.int64)
        col = getattr(self.shards[0], name)
        out = torch.empty((len(rows),) + tuple(col.shape[1:]), dtype=col.dtype,
                          device=self.device)
        for st, sel, loc in self._routes(rows):
            src = getattr(st, name)
            out[torch.from_numpy(sel).to(self.device)] = src[
                torch.from_numpy(loc).to(src.device)].to(self.device)
        return out

    def _column(self, name: str) -> torch.Tensor:
        """The whole column ``name`` over every shard, on the first device."""
        if self.mesh is None:
            return getattr(self.state, name)
        return torch.cat([getattr(st, name).to(self.device)
                          for st in self.shards])

    def __len__(self) -> int:
        return len(self.id_to_row)

    def stats(self) -> Dict[str, object]:
        return {
            "rows": len(self.id_to_row),
            "capacity": self.capacity,
            "edge_capacity": self.edge_state.capacity,
            "edges": len(self.edge_slots),
            "dim": self.dim,
            "dtype": str(self.dtype).replace("torch.", ""),
            "tenants": len(self._tenants),
            "device": str(self.device),
            "mesh": (f"{self._n_parts}x {self.shard_axis}"
                     if self.mesh is not None else None),
            "ivf": (f"nprobe={self.ivf_nprobe}, "
                    f"{'built' if self._ivf is not None else 'pending'}"
                    + (", online" if self.ivf_online
                       and self._ivf_dev is not None else "")
                    if self.ivf_nprobe else None),
        }

    # ---------------------------------------------------------------- nodes
    def _alloc_rows(self, n: int) -> List[int]:
        while len(self._free_rows) < n:
            old_cap = self.capacity
            new_cap = self._grown_capacity(old_cap)
            self._int8_dirty = True          # the shadow no longer fits
            if self.mesh is None:
                self.state = S.grow_arena(self.state, new_cap)
            else:                    # L changes: the rows split anew
                self.shards = S.grow_shards(self.shards, new_cap,
                                            self.mesh.devices)
            self._free_rows = list(range(new_cap - 1, old_cap - 1, -1)) + self._free_rows
        return [self._free_rows.pop() for _ in range(n)]

    def _assign_rows(self, ids: Sequence[str]) -> List[int]:
        """The rows of ``ids``: an existing id keeps its row, a new one takes
        a free row (the arena grows if it must)."""
        fresh = iter(self._alloc_rows(sum(1 for i in ids if i not in self.id_to_row)))
        rows: List[int] = []
        for node_id in ids:
            r = self.id_to_row.get(node_id)
            if r is None:
                r = next(fresh)
                self.id_to_row[node_id] = r
                self.row_to_id[r] = node_id
            rows.append(r)
        return rows

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
            rows = self._assign_rows(ids)
            tid = self.tenant_id(tenant)
            self.tenant_nodes.setdefault(tenant, set()).update(ids)
            self._note_super(rows, [bool(x) for x in is_super])
            if self.mesh is not None:
                self._guarded(lambda: self._add_sharded(
                    rows, embeddings, saliences, timestamps, types,
                    shard_keys, tid, is_super), (self.shards,), "arena")
                return rows
            padded = S.pad_rows(np.asarray(rows, np.int32), self.capacity)
            b = len(padded)

            def pad(vals, fill=0.0, dt=np.float32):
                out = np.full((b,), fill, dt)
                out[:n] = vals
                return out

            cols = upload_once([
                padded, np.asarray(embeddings, np.float32).reshape(n, self.dim),
                pad(np.asarray(saliences, np.float32)),
                pad(np.asarray(timestamps, np.float64) - self.epoch),
                pad([S.TYPE_IDS.get(t, 0) for t in types], 0, np.int32),
                pad([self.shard_id(k or "default") for k in shard_keys], -1,
                    np.int32),
                pad(np.full((n,), tid, np.int32), -1, np.int32),
                pad(np.asarray(is_super, bool), False, bool)], self.device)
            emb = torch.zeros((b, self.dim), dtype=torch.float32,
                              device=self.device)
            emb[:n] = cols[1]
            emb[n:, 0] = 1.0   # sentinel rows get a unit vector (normalizable)
            self._guarded(lambda: S._arena_add(self.state, cols[0], emb,
                                               *cols[2:]),
                          (self.state,), "arena")
            self._int8_dirty = True              # embedding rows written
            self._ivf_note_added(rows)
            return rows

    def _note_super(self, rows: Sequence[int], flags: Sequence[bool]) -> None:
        """Track the rows that hold a super node
        (``lazzaro_tpu/core/index.py:_note_super``)."""
        changed = False
        for r, f in zip(rows, flags):
            if f:
                if r not in self._super_rows:
                    self._super_rows.add(r)
                    changed = True
            elif r in self._super_rows:
                self._super_rows.discard(r)
                changed = True
        if changed:
            self._super_rows_frozen = tuple(sorted(self._super_rows))

    def restore_access(self, ids: Sequence[str], access_counts: Sequence[int],
                       last_accessed: Sequence[float]) -> None:
        """Put persisted access history back onto freshly added rows
        (``add`` zeroes it), as a reload needs."""
        with self._lock:
            found = [self.id_to_row.get(i) for i in ids]
            ok = [j for j, r in enumerate(found) if r is not None]
            if not ok:
                return
            rows = [found[j] for j in ok]
            acs = np.asarray(access_counts, np.int64)[ok].astype(np.int32)
            las = (np.asarray(last_accessed, np.float64)[ok]
                   - self.epoch).astype(np.float32)
            if self.mesh is not None:
                def run():
                    for st, sel, loc in self._routes(rows):
                        S._arena_restore_access(st, loc, acs[sel], las[sel])
                self._guarded(run, (self.shards,), "arena")
                return
            padded = S.pad_rows(np.asarray(rows, np.int32), self.capacity)
            b = len(padded)
            ac_arr = np.zeros((b,), np.int32)
            ac_arr[:len(acs)] = acs
            la_arr = np.zeros((b,), np.float32)
            la_arr[:len(las)] = las
            cols = upload_once([padded, ac_arr, la_arr], self.device)
            self._guarded(lambda: S._arena_restore_access(self.state, *cols),
                          (self.state,), "arena")

    def _add_sharded(self, rows, embeddings, saliences, timestamps, types,
                     shard_keys, tid, is_super) -> None:
        """:meth:`add`'s arena write under a mesh: each owner shard writes
        its own rows, unpadded."""
        n = len(rows)
        emb = np.asarray(embeddings, np.float32).reshape(n, self.dim)
        cols = (np.asarray([float(s) for s in saliences], np.float32),
                np.asarray([float(t) - self.epoch for t in timestamps],
                           np.float32),
                np.asarray([S.TYPE_IDS.get(t, 0) for t in types], np.int32),
                np.asarray([self.shard_id(k or "default") for k in shard_keys],
                           np.int32),
                np.full((n,), tid, np.int32),
                np.asarray([bool(x) for x in is_super], bool))
        for st, sel, loc in self._routes(rows):
            S._arena_add(st, loc, emb[sel], *(c[sel] for c in cols))

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
            padded = S.pad_rows(np.asarray(rows, np.int32), self.capacity)

            def run():
                if self.mesh is None:
                    S._arena_delete(self.state, padded)
                else:
                    for st, _, loc in self._routes(rows):
                        S._arena_delete(st, loc)
                S._edges_delete_for_nodes(self.edge_state, padded)

            self._guarded(run, (*self._arena_states(), self.edge_state),
                          "arena")
            self._free_rows.extend(rows)
            if self._super_rows:
                self._note_super(rows, [False] * len(rows))
            self._ivf_note_deleted(rows)
            # One pass over the keys (~0.6 s at 1.16M edges, a small part
            # of a tenant's reload), freeing dead slots in the map's order.
            id_to_row = self.id_to_row
            dead = [k for k in self.edge_slots
                    if k[0] not in id_to_row or k[1] not in id_to_row]
            for k in dead:
                self._free_edge_slots.append(self.edge_slots.pop(k))
            self._csr_dirty = True

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
        padded to a power of two as the JAX index pads it. With a published
        IVF build (``ivf_nprobe > 0``) the classic IVF search serves it
        (:meth:`_ivf_search`, K5's classic form). With int8 serving on, the
        scan reads the int8 shadow (K4's additive form,
        ``ops.int8_topk.int8_topk``, as ``quantized_topk``); ``exact=True``
        keeps it on the master arena, as consolidation's dedup and merge
        gates need (their thresholds sit inside the int8 error band)."""
        check_not_poisoned(self._poisoned)
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
            k_eff = min(k, self.capacity)
            got = (self._ivf_search(q_pad, tid, k_eff, super_filter)
                   if self.mesh is None and self.ivf_nprobe and not exact
                   else None)
            if got is not None:
                # k + slack fetched: the decode drops repeats, then trims
                return decode_topk(got[0][:nq], got[1][:nq], self.row_to_id,
                                   S.NEG_INF, limit=k_eff)
            if self.mesh is None and self.int8_serving and not exact:
                # one arena snapshot feeds the shadow and the mask
                st = self.state
                q8, qscale = self._int8_shadow_for(st)
                scores, rows = int8_topk(
                    q8, qscale, S.arena_mask(st, tid, super_filter),
                    S.normalize(q_pad.float()), k_eff)
            elif self.mesh is None:
                scores, rows = S.arena_search(self.state, q_pad, tid, k_eff,
                                              super_filter)
            else:
                # Each shard's scan on its rows, one merge, one readback.
                scores, rows = self._mesh_searcher(k_eff)(
                    [st.emb for st in self.shards],
                    [S.arena_mask(st, tid, super_filter) for st in self.shards],
                    S.normalize(q_pad.float()))
                packed = torch.cat([scores, rows.view(torch.float32)], dim=1)
        if self.mesh is None:
            return decode_topk(scores[:nq].cpu().numpy(),
                               rows[:nq].cpu().numpy(), self.row_to_id,
                               S.NEG_INF)
        host = packed.cpu().numpy()
        return decode_topk(host[:nq, :k_eff], host[:nq, k_eff:].view(np.int32),
                           self.row_to_id, S.NEG_INF)

    def _mesh_searcher(self, k: int):
        """``ops.topk.make_sharded_topk`` over the mesh, one per k, the
        least recently used dropped past ``_MESH_SEARCHERS``
        (``lazzaro_tpu/core/index.py:_mesh_searcher``)."""
        fn = self._mesh_topk.get(k)
        if fn is None:
            fn = make_sharded_topk(self.mesh, self.shard_axis, k=k)
            self._mesh_topk[k] = fn
            if len(self._mesh_topk) > self._MESH_SEARCHERS:
                self._mesh_topk.popitem(last=False)
        self._mesh_topk.move_to_end(k)
        return fn

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
        return S.pad_rows(np.asarray(rows, np.int32), self.capacity)

    def _write_rows(self, op, ids: Sequence[str], *args) -> None:
        """``op(state, rows, *args)`` on the rows of ``ids``: sentinel-padded
        on one device, per owner shard under a mesh."""
        if self.mesh is None:
            padded = self._padded_rows(ids)
            if padded is not None:
                self._guarded(lambda: op(self.state, padded, *args),
                              (self.state,), "arena")
            return
        rows = [self.id_to_row[i] for i in ids if i in self.id_to_row]

        def run():
            for st, _, loc in self._routes(rows):
                op(st, loc, *args)

        self._guarded(run, (self.shards,), "arena")

    def update_access(self, ids: Sequence[str], boost: float = 0.05,
                      now: Optional[float] = None) -> None:
        with self._lock:
            self._write_rows(S._arena_update_access, ids, self._now(now), boost)

    def boost(self, ids: Sequence[str], boost: float = 0.02,
              now: Optional[float] = None) -> None:
        """Neighbor boost: salience bump + freshness, no access increment."""
        with self._lock:
            self._write_rows(S._arena_boost, ids, self._now(now), boost)

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
            if self.mesh is not None:
                cols = (np.asarray(accs, np.int32), np.asarray(nbrs, np.int32),
                        np.asarray(nows, np.float32))
                def run():
                    for st, sel, loc in self._routes(rows):
                        S._arena_apply_boosts(st, loc, *(c[sel] for c in cols),
                                              acc_boost, nbr_boost)
                self._guarded(run, (self.shards,), "arena")
                return
            padded = S.pad_rows(np.asarray(rows, np.int32), self.capacity)
            b = len(padded)
            acc_arr = np.zeros((b,), np.int32)
            acc_arr[:len(accs)] = accs
            nbr_arr = np.zeros((b,), np.int32)
            nbr_arr[:len(nbrs)] = nbrs
            now_arr = np.full((b,), S.NEG_INF, np.float32)   # pad: max no-op
            now_arr[:len(nows)] = nows
            self._guarded(lambda: S._arena_apply_boosts(
                self.state, padded, acc_arr, nbr_arr, now_arr, acc_boost,
                nbr_boost), (self.state,), "arena")

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
            if self.mesh is not None:
                sal = np.asarray(sals, np.float32)

                def run():
                    for st, sel, loc in self._routes(rows):
                        S._arena_merge_touch(st, loc, sal[sel], self._now(now))

                self._guarded(run, (self.shards,), "arena")
                return
            padded = S.pad_rows(np.asarray(rows, np.int32), self.capacity)
            sal = np.zeros((len(padded),), np.float32)
            sal[:len(sals)] = sals
            self._guarded(lambda: S._arena_merge_touch(
                self.state, padded, sal, self._now(now)), (self.state,),
                "arena")

    def decay(self, tenant: str, rate: float, salience_floor: float = 0.2) -> None:
        """Per-tenant decay tick: arena salience and edge weights."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return
        def run():
            if self.mesh is None:
                S._decay_fused(self.state, self.edge_state, tid, rate,
                               salience_floor)
                return
            for st in self.shards:
                S._arena_decay(st, tid, rate, salience_floor)
            S._edges_decay(self.edge_state, tid, rate)

        with self._lock:
            self._guarded(run, (*self._arena_states(), self.edge_state),
                          "decay")

    def evict_candidates(self, tenant: str, k: int, now: Optional[float] = None,
                         weights: Tuple[float, float, float] = (0.5, 0.3, 0.2)
                         ) -> List[Tuple[str, float]]:
        """k least-important (id, importance) pairs for a tenant."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return []
        with self._lock:
            k_bucket = min(self.capacity,
                           max(8, 1 << (max(1, k - 1)).bit_length()))
            if self.mesh is None:
                imps, rows = S.arena_evict_candidates(
                    self.state, tid, self._now(now), *weights, k_bucket)
            else:
                # Each shard's bottom-k, merged on -importance (ties to the
                # lower global row, as one top-k over the arena).
                k_l = min(k_bucket, self._local_n)
                parts = [S.arena_evict_candidates(st, tid, self._now(now),
                                                  *weights, k_l)
                         for st in self.shards]
                neg, rows = sharded_merge([-imp[None] for imp, _ in parts],
                                          [r[None] for _, r in parts],
                                          self._local_n, k_bucket,
                                          device=self.device)
                imps, rows = -neg[0], rows[0]
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
        """Decode a compacted pruned-slot vector (ascending, -1 padded)
        through the ``by_slot`` reverse index: O(pruned) host cleanup."""
        removed = []
        by_slot = self.edge_slots.by_slot
        end = np.flatnonzero(pruned_slots < 0)     # the compacted prefix ends
        for slot in pruned_slots[:end[0] if len(end) else None].tolist():
            key = by_slot.get(int(slot))
            if key is None:
                continue
            removed.append(key)
            self._free_edge_slots.append(self.edge_slots.pop(key))
        if removed:
            self._csr_dirty = True
        return removed

    # ------------------------------------------------------------ lifecycle
    def _lifecycle_dispatch(self, fn, *args, **kwargs):
        """The device program every lifecycle sweep goes through, under the
        guard: tests and the smoke wrap it to count dispatches (one call,
        one dispatch, on one device or a mesh)."""
        self.lifecycle_dispatch_count += 1
        return self._guarded(lambda: fn(*args, **kwargs),
                             (*self._arena_states(), self.edge_state),
                             "lifecycle")

    def lifecycle_sweep(self, passes: Dict[str, int], *, rate: float,
                        salience_floor: float, prune_threshold: float,
                        weights: Tuple[float, float, float] = (0.5, 0.3, 0.2),
                        archive_k: int = 8,
                        now: Optional[float] = None) -> Dict[str, object]:
        """Decay, prune and archive verdicts for ALL tenants in ONE dispatch
        and ONE packed readback (``lazzaro_tpu/core/index.py:
        lifecycle_sweep``). ``passes`` maps tenant name -> owed decay passes
        (0 or missing: skip); one pass per tenant is bit-equal to the
        classic per-tenant loop (``decay``, ``prune_edges``,
        ``evict_candidates``), more take the closed form. Returns::

            {"verdicts": {tenant: [(node_id, importance, row), ...]},
             "removed_edges": [(qsrc, qtgt), ...],
             "decayed_rows": n, "decayed_edges": n, "pruned_edges": n,
             "prune_total": n, "prune_overflow": 0/1, "dispatches": 1}

        Verdicts are each tenant's bottom-``archive_k`` live non-super rows
        by importance; removed edges are already reclaimed from the host
        mirror."""
        check_not_poisoned(self._poisoned)
        swept = {t: int(p) for t, p in passes.items()
                 if int(p) > 0 and t in self._tenants}
        if not swept:
            return {"verdicts": {}, "removed_edges": [], "decayed_rows": 0,
                    "decayed_edges": 0, "pruned_edges": 0, "prune_total": 0,
                    "prune_overflow": 0, "dispatches": 0}
        now_rel = self._now(now)
        # dense owed-pass table by tenant id, pow2-bucketed as the JAX one
        tc = max(8, next_pow2(max(self._tenants.values()) + 1))
        passes_arr = np.zeros((tc,), np.int32)
        for t, p in swept.items():
            passes_arr[self._tenants[t]] = p
        v_list = sorted(self._tenants[t] for t in swept)
        v_tids = S.pad_rows(np.asarray(v_list, np.int32), -1)
        k_bucket = min(self.capacity, max(8, next_pow2(max(1, archive_k))))
        with self._lock:
            prune_cap = self._prune_cap()
            args = (*upload_once([passes_arr, v_tids], self.device), rate,
                    salience_floor, prune_threshold, now_rel, *weights)
            if self.mesh is None:
                _, _, payload = self._lifecycle_dispatch(
                    S.lifecycle_sweep, self.state, self.edge_state, *args,
                    prune_cap=prune_cap, archive_k=k_bucket)
            else:
                payload = self._lifecycle_dispatch(
                    S.lifecycle_sweep_sharded, self.shards, self.edge_state,
                    *args, prune_cap=prune_cap, archive_k=k_bucket)
            host = self._readback(payload)      # the ONE packed readback
            tv, off = len(v_tids), len(v_tids) * k_bucket
            v_imps = host[:off].reshape(tv, k_bucket)
            v_rows = host[off:2 * off].view(np.int32).reshape(tv, k_bucket)
            tail = host[2 * off + prune_cap:].view(np.int32)
            removed = self._reclaim_pruned_slots(
                host[2 * off:2 * off + prune_cap].view(np.int32))
        by_tid = {tid: name for name, tid in self._tenants.items()}
        verdicts: Dict[str, List[Tuple[str, float, int]]] = {}
        for vi, tid in enumerate(v_list):
            out = []
            for imp, r in zip(v_imps[vi], v_rows[vi]):
                if not np.isfinite(imp):
                    continue
                node_id = self.row_to_id.get(int(r))
                if node_id is not None:
                    out.append((node_id, float(imp), int(r)))
            verdicts[by_tid[tid]] = out[:archive_k]
        self.telemetry.bump("lifecycle.decayed_rows", int(tail[0]))
        self.telemetry.bump("lifecycle.decayed_edges", int(tail[1]))
        self.telemetry.bump("lifecycle.pruned_edges", int(tail[2]))
        if tail[4]:
            self.telemetry.bump("lifecycle.prune_overflow")
        return {"verdicts": verdicts, "removed_edges": removed,
                "decayed_rows": int(tail[0]), "decayed_edges": int(tail[1]),
                "pruned_edges": int(tail[2]), "prune_total": int(tail[3]),
                "prune_overflow": int(tail[4]), "dispatches": 1}

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
            k_eff = min(k, self.capacity)
            if self.mesh is None:
                padded = S.pad_rows(all_rows, self.capacity)
                flat = S.unpack_leaves(self._readback(S.pack_leaves(
                    S.arena_link_candidates_multi(
                        self.state, padded, padded, tid, k_eff,
                        tuple(shard_modes)))), [True, False] * len(shard_modes))
            else:
                flat = self._link_sharded(all_rows, tid, k_eff,
                                          tuple(shard_modes))
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

    def _link_sharded(self, rows: np.ndarray, tid: int, k: int,
                      shard_modes: Tuple[int, ...]) -> List[np.ndarray]:
        """The link scan under a mesh: the new rows' embeddings and shard
        ids gathered from their owners, each shard's scan of its rows (the
        new rows it owns excluded), one merge per shard mode, one readback.
        Returns the flat ``(scores, rows)`` list of the single-device
        scan."""
        q_emb = self._gather("emb", rows)
        q_shard = self._gather("shard_id", rows)
        excl = {p: loc for p, _, loc in S.route_rows(rows, self._local_n)}
        k_l = min(k, self._local_n)
        parts = []
        for p, st in enumerate(self.shards):
            dev = st.emb.device
            parts.append(S.arena_link_scan(
                st, q_emb.to(dev), q_shard.to(dev),
                excl.get(p, np.zeros((0,), np.int64)), tid, k_l, shard_modes))
        merged = []
        for i in range(len(shard_modes)):
            merged.extend(sharded_merge([x[2 * i] for x in parts],
                                        [x[2 * i + 1] for x in parts],
                                        self._local_n, k, device=self.device))
        return S.unpack_leaves(self._readback(S.pack_leaves(merged)),
                               [True, False] * len(shard_modes))

    def link_candidates(self, new_ids: Sequence[str], tenant: str, k: int = 3,
                        shard_mode: int = 0) -> Dict[str, List[Tuple[str, float]]]:
        """Single-mode view of :meth:`link_candidates_multi`."""
        return self.link_candidates_multi(new_ids, tenant, k,
                                          (shard_mode,))[shard_mode]

    # -------------------------------------------------------- consolidation
    def merge_candidates(self, tenant: str, threshold: float = 0.95
                         ) -> List[Tuple[str, str, float]]:
        """All-pairs near-duplicates of the tenant's live non-super rows
        (``lazzaro_tpu/core/index.py:merge_candidates``): ``(keep_id,
        merge_id, sim)`` triples, each row's up to 4 best later rows above
        ``threshold``. One launch of the pairwise kernel
        (``ops.graphops.pairwise_merge_candidates``) and one packed
        device-to-host copy; only the rows with a hit are decoded."""
        if self.mesh is not None:
            raise NotImplementedError(_CONSOLIDATION_MESH)
        tid = self._tenants.get(tenant)
        if tid is None:
            return []
        with self._lock:
            st = self.state
            mask = st.alive & (st.tenant_id == tid) & ~st.is_super
            top_s, top_j = graphops.pairwise_merge_candidates(
                st.emb, mask, threshold, k=4)
            host = self._readback(torch.cat([top_s, top_j.view(torch.float32)],
                                            dim=1))
        k = top_s.shape[1]
        top_s, top_j = host[:, :k], host[:, k:].view(np.int32)
        out = []
        for i in np.nonzero((top_j >= 0).any(axis=1))[0].tolist():
            a = self.row_to_id.get(i)
            if a is None:
                continue
            for s, j in zip(top_s[i], top_j[i]):
                if j < 0:
                    continue
                b = self.row_to_id.get(int(j))
                if b is not None:
                    out.append((a, b, float(s)))
        return out

    def components(self) -> List[List[str]]:
        """Connected components of the edge arena by label propagation
        (``lazzaro_tpu/core/index.py:components``): the ids of each, keyed
        by the component's root row."""
        alive = self._column("alive").to(self.device)
        es = self.edge_state
        labels = graphops.connected_components(
            es.src, es.tgt, es.alive, alive, alive.shape[0]).cpu().numpy()
        groups: Dict[int, List[str]] = {}
        for row, node_id in self.row_to_id.items():
            lbl = int(labels[row])
            if lbl >= 0:
                groups.setdefault(lbl, []).append(node_id)
        return list(groups.values())

    # ---------------------------------------------------------------- reads
    def mean_embedding(self, ids: Sequence[str]) -> np.ndarray:
        padded = self._padded_rows(ids)
        if padded is None:
            return np.zeros((self.dim,), np.float32)
        with self._lock:
            if self.mesh is None:
                return S.arena_mean_embedding(self.state, padded).cpu().numpy()
            # The owners' rows, zero rows for the padding: the sum of the
            # single-device function over the same [B, d] block.
            live = padded < self.capacity
            embs = torch.zeros((len(padded), self.dim), dtype=torch.float32,
                               device=self.device)
            embs[torch.from_numpy(np.nonzero(live)[0]).to(self.device)] = \
                self._gather("emb", padded[live]).float()
            return S.normalize(embs.sum(0) / max(int(live.sum()), 1)
                               ).cpu().numpy()

    def embeddings_of_rows(self, rows: Sequence[int]) -> np.ndarray:
        """The arena's vectors at ``rows`` as f32, in one gather."""
        if self.mesh is not None:
            return self._gather("emb", rows).float().cpu().numpy()
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self.state.emb[r].float().cpu().numpy()

    def get_embedding(self, node_id: str) -> Optional[np.ndarray]:
        r = self.id_to_row.get(node_id)
        if r is None:
            return None
        if self.mesh is not None:
            return self._gather("emb", [r])[0].float().cpu().numpy()
        return self.state.emb[r].float().cpu().numpy()

    def pull_numeric(self) -> Dict[str, np.ndarray]:
        """Bulk readback of the mutable numeric columns."""
        return {"salience": self._column("salience").cpu().numpy(),
                "last_accessed": (self._column("last_accessed").cpu().numpy()
                                  + self.epoch),
                "access_count": self._column("access_count").cpu().numpy()}

    def pull_numeric_rows(self, rows: Sequence[int]) -> Dict[str, np.ndarray]:
        """``pull_numeric`` for the given rows only."""
        if self.mesh is not None:
            cols = {name: self._gather(name, rows).cpu().numpy() for name in
                    ("salience", "last_accessed", "access_count")}
            cols["last_accessed"] = cols["last_accessed"] + self.epoch
            return cols
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
                self._csr_dirty = True
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
                tid = self.tenant_id(tenant)
                self._guarded(lambda: S._edges_add(
                    self.edge_state, padded, src_r, tgt_r, w,
                    np.ones((b,), np.int32), now, tid, live),
                    (self.edge_state,), "edges")
            if existing:
                slots = [self.edge_slots[s] if isinstance(s, tuple) else s
                         for s in existing]
                padded_r = S.pad_rows(np.asarray(slots, np.int32),
                                      self.edge_state.capacity)
                self._guarded(lambda: S._edges_reinforce(
                    self.edge_state, padded_r, reinforce, now),
                    (self.edge_state,), "edges")

    def prune_edges(self, tenant: str, threshold: float) -> List[Tuple[str, str]]:
        """Drop the tenant's edges under ``threshold``; returns their keys."""
        tid = self._tenants.get(tenant)
        if tid is None:
            return []
        with self._lock:
            prune_cap = self._prune_cap()
            _, slots = self._guarded(lambda: S._edges_prune(
                self.edge_state, tid, threshold, prune_cap),
                (self.edge_state,), "edges")
            return self._reclaim_pruned_slots(slots.cpu().numpy())

    # --------------------------------------------------------- fused ingest
    def _ingest_dispatch(self, fn, *args, **kwargs):
        """The device program every fused ingest goes through: tests and the
        smoke wrap it to count dispatches per batch (one call, one
        dispatch; a retry of the guard is another)."""
        self.ingest_dispatch_count += 1
        return fn(*args, **kwargs)

    @staticmethod
    def _pad_cols(b: int, cols) -> List[np.ndarray]:
        """``[b]`` host columns from ``(values, fill, dtype)`` triples, each
        padded with its ``fill``."""
        arrays = []
        for vals, fill, dt in cols:
            out = np.full((b,), fill, dt)
            out[:len(vals)] = vals
            arrays.append(out)
        return arrays

    def _decode_links(self, host, ids, n, k_eff, shard_modes, pool, link_scale,
                      skip):
        """Per mode, each fact's full candidate list and the edges the
        device inserted, from the per-mode ``(scores, cands, pos)`` leaves
        (``lazzaro_tpu/core/index.py:ingest_batch`` /
        ``commit_ingest_dedup``): accepted keys are registered in
        ``edge_slots``, an accepted edge past the real pool is queued for
        the host retry, a slot the host does not register is reclaimed.
        ``skip[i]`` leaves fact ``i`` out (a device-merged duplicate).
        Returns ``(candidates, created, reclaim, overflowed, consumed)``."""
        pool_real = len(pool)
        candidates: Dict[int, Dict[str, List[Tuple[str, float]]]] = {}
        created: Dict[int, List[Tuple[str, str, float]]] = {}
        reclaim: List[int] = []
        overflowed: List[Tuple[str, str, float]] = []
        consumed = 0
        for mi, sm in enumerate(shard_modes):
            sc, cd, ps = host[3 * mi], host[3 * mi + 1], host[3 * mi + 2]
            out_m: Dict[str, List[Tuple[str, float]]] = {}
            made: List[Tuple[str, str, float]] = []
            for bi in range(n):
                nid = ids[bi]
                pairs = []
                for j in range(k_eff):
                    p = int(ps[bi, j])
                    s = float(sc[bi, j])
                    cid = (self.row_to_id.get(int(cd[bi, j]))
                           if s > S.NEG_INF / 2 else None)
                    if cid is not None and not skip[bi]:
                        pairs.append((cid, s))
                    if p < 0:
                        continue               # rejected: no slot consumed
                    w = min(1.0, max(0.0, s * link_scale))
                    if p >= pool_real:
                        # accepted but past the hinted pool (never written):
                        # the host retry below inserts it
                        if cid is not None and not skip[bi] \
                                and (nid, cid) not in self.edge_slots:
                            overflowed.append((nid, cid, w))
                            made.append((nid, cid, w))
                        continue
                    consumed = max(consumed, p + 1)
                    key = (nid, cid)
                    if cid is not None and not skip[bi] \
                            and key not in self.edge_slots:
                        self.edge_slots[key] = pool[p]
                        made.append((nid, cid, w))
                    else:
                        # written by the device but not registered by the
                        # host (defensive): reclaimed, not cleared, until
                        # the next write lands on it
                        reclaim.append(pool[p])
                if not skip[bi]:
                    out_m[nid] = pairs
            candidates[sm] = out_m
            created[sm] = made
        return candidates, created, reclaim, overflowed, consumed

    def _finish_links(self, pool, consumed, reclaim, overflowed, tenant, now):
        """The compaction win (the untouched pool suffix comes back whole)
        and, for the rare batch that beat the hinted pool, one
        :meth:`add_edges` of exactly the overflowed edges."""
        self._free_edge_slots.extend(pool[consumed:])
        self._free_edge_slots.extend(reclaim)
        self._csr_dirty = True
        if overflowed:
            self.link_pool_overflows += 1
            self.telemetry.bump("ingest.link_pool_overflows")
            self.add_edges(overflowed, tenant, now=now)

    def _run_ingest(self, kind: str, fn, up, **kwargs):
        """One fused ingest dispatch and its one packed readback; records
        ``ingest.dispatch_ms`` and ``ingest.dispatches``. With online IVF
        tables the dispatch also updates them in place and the readback
        ends in their ``IVF_INGEST_TAIL`` leaves. Returns ``(host leaves,
        whether the tables were maintained)``."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"lz.ingest.{kind}"):
            shadow = self._ingest_shadow_arg()
            ivf = self._ivf_online_arg()
            _, _, outs = self._guarded(
                lambda: self._ingest_dispatch(fn, self.state, self.edge_state,
                                              *up, shadow=shadow, ivf=ivf,
                                              ivf_eta=self.ivf_online_eta,
                                              **kwargs),
                (self.state, self.edge_state), "ingest")
            if shadow is None:
                self._int8_dirty = True      # rows written, shadow not kept
            n_modes = len(kwargs["shard_modes"])
            wide = 3 if kind == "dedup_fused" else 0
            is_float = ([False] * wide + [True, False, False] * n_modes
                        + [False] * 3
                        + [False] * (S.IVF_INGEST_TAIL if ivf is not None else 0))
            host = S.unpack_leaves(self._readback(S.pack_leaves(outs)),
                                   is_float)
        self.telemetry.record("ingest.dispatch_ms",
                              (time.perf_counter() - t0) * 1e3,
                              labels={"kind": kind})
        self.telemetry.bump("ingest.dispatches", labels={"kind": kind})
        return host, ivf is not None

    def ingest_batch(self, ids: Sequence[str], embeddings: np.ndarray,
                     saliences: Sequence[float], timestamps: Sequence[float],
                     types: Sequence[str], shard_keys: Sequence[str],
                     tenant: str, is_super: Optional[Sequence[bool]] = None,
                     merge_ids: Sequence[str] = (),
                     merge_saliences: Sequence[float] = (),
                     chain_pairs: Sequence[Tuple[str, str]] = (),
                     chain_weight: float = 0.5, link_k: int = 3,
                     link_gate: float = 0.5, link_scale: float = 0.8,
                     shard_modes: Sequence[int] = (1, 0),
                     now: Optional[float] = None,
                     link_accept_hint: float = 1.0):
        """Fused conversation ingest (``lazzaro_tpu/core/index.py:
        ingest_batch``): insert ``ids``, merge-touch ``merge_ids``, link-scan
        every new row per shard mode and insert the chain edges plus every
        gate-passing similarity edge, as ONE dispatch
        (``state.ingest_fused``) and ONE packed readback. Edge slots come
        from a pool of ``link_pool_size(modes * B * k, link_accept_hint)``
        slots that the device compacts accepted links into; the overflowed
        edges of a batch that beats the hint are re-inserted by one
        :meth:`add_edges` (``link_pool_overflows`` counts such batches).
        Returns ``(rows, candidates, created)``: the rows of ``ids``, per
        mode ``{id: [(cand_id, score), ...]}`` (ungated, as
        :meth:`link_candidates_multi` gives them) and per mode the
        ``(src_id, tgt_id, weight)`` edges the device inserted, registered
        in ``edge_slots``."""
        if self.mesh is not None:
            raise NotImplementedError(_FUSED_INGEST_MESH)
        check_not_poisoned(self._poisoned)
        n = len(ids)
        shard_modes = tuple(shard_modes)
        if n == 0:
            if merge_ids:
                self.merge_touch(merge_ids, merge_saliences, now)
            return [], {sm: {} for sm in shard_modes}, {sm: [] for sm in shard_modes}
        if is_super is None:
            is_super = [False] * n
        with self._lock:
            rows = self._assign_rows(ids)
            tid = self.tenant_id(tenant)
            self.tenant_nodes.setdefault(tenant, set()).update(ids)
            self._note_super(rows, [bool(x) for x in is_super])
            t_rows, t_sals = [], []
            for mid, msal in zip(merge_ids, merge_saliences):
                r = self.id_to_row.get(mid)
                if r is not None:
                    t_rows.append(r)
                    t_sals.append(float(msal))
            # One slot allocation up front (chains + the link pool): growth,
            # if any, happens before sentinel indices are baked in below.
            k_eff = min(link_k, self.capacity)
            n_modes = len(shard_modes)
            chain_keys = [(a, b) for a, b in chain_pairs
                          if a in self.id_to_row and b in self.id_to_row]
            pool_need = link_pool_size(n_modes * n * k_eff, link_accept_hint)
            slots = self._alloc_edge_slots(len(chain_keys) + pool_need)
            chain_list, pool = slots[:len(chain_keys)], slots[len(chain_keys):]
            cap, ecap = self.capacity, self.edge_state.capacity
            padded = S.pad_rows(np.asarray(rows, np.int32), cap)
            b = len(padded)
            emb = np.zeros((b, self.dim), np.float32)
            emb[:n] = np.asarray(embeddings, np.float32).reshape(n, self.dim)
            emb[n:, 0] = 1.0   # sentinel rows get a unit vector (normalizable)
            touch = S.pad_rows(np.asarray(t_rows, np.int32), cap)
            c_slots = S.pad_rows(np.asarray(chain_list, np.int32), ecap)
            cb = len(c_slots)
            cols = self._pad_cols(b, [
                ([float(x) for x in saliences], 0.0, np.float32),
                ([float(t) - self.epoch for t in timestamps], 0.0, np.float32),
                ([S.TYPE_IDS.get(t, 0) for t in types], 0, np.int32),
                ([self.shard_id(sk or "default") for sk in shard_keys], -1,
                 np.int32),
                ([tid] * n, -1, np.int32),
                ([bool(x) for x in is_super], False, bool)])
            chain = self._pad_cols(cb, [
                ([self.id_to_row[a] for a, _ in chain_keys], -1, np.int32),
                ([self.id_to_row[t] for _, t in chain_keys], -1, np.int32),
                ([chain_weight] * len(chain_keys), 0.0, np.float32)])
            touch_sal = np.zeros((len(touch),), np.float32)
            touch_sal[:len(t_sals)] = t_sals
            dev = self._ingest_stage.upload(
                [padded, emb, *cols, touch, touch_sal, c_slots, *chain,
                 link_pool_dev(pool, n_modes * b * k_eff, ecap)])
            now_rel = (now if now is not None else time.time()) - self.epoch
            scal = [S._scalar(x, self.device)
                    for x in (now_rel, link_gate, link_scale)]
            pool_len = torch.full((), len(pool), dtype=torch.int32,
                                  device=self.device)
            host, ivf_fresh = self._run_ingest(
                "fused", S.ingest_fused,
                [*dev, pool_len, scal[0], tid, scal[1], scal[2]],
                k=k_eff, shard_modes=shard_modes)
            ctr = host[3 * n_modes:]
            self.telemetry.bump("ingest.links_accepted", int(ctr[1][0, 0]))
            self.telemetry.bump("ingest.pool_slots_used", int(ctr[2][0, 0]))
            if ivf_fresh:
                self._ivf_note_online(rows, [True] * n, ctr[3:])
            else:
                self._ivf_note_added(rows)
            candidates, created, reclaim, overflowed, consumed = \
                self._decode_links(host, list(ids), n, k_eff, shard_modes,
                                   pool, link_scale, [False] * n)
            for key, slot in zip(chain_keys, chain_list):
                if key in self.edge_slots:     # defensive: should not happen
                    reclaim.append(slot)
                else:
                    self.edge_slots[key] = slot
            self._finish_links(pool, consumed, reclaim, overflowed, tenant, now)
        return rows, candidates, created

    def ingest_batch_dedup(self, embeddings: np.ndarray,
                           saliences: Sequence[float],
                           timestamps: Sequence[float], types: Sequence[str],
                           shard_keys: Sequence[str], tenant: str,
                           dedup_gate: float, chain_weight: float = 0.5,
                           link_k: int = 3, link_gate: float = 0.5,
                           link_scale: float = 0.8,
                           shard_modes: Sequence[int] = (1, 0),
                           now: Optional[float] = None,
                           link_accept_hint: float = 1.0) -> Optional[dict]:
        """Single-round-trip ingest (``lazzaro_tpu/core/index.py:
        ingest_batch_dedup``): the dedup probe against the pre-add arena
        and the intra-batch gram run INSIDE the fused dispatch
        (``state.ingest_dedup_fused``); duplicates never become nodes (the
        device merges them into their targets) and chain edges link
        consecutive live facts of each shard key. ONE dispatch and ONE
        packed readback. Node ids are named by the caller after the
        readback (the id counter advances as on the classic path, which
        names only surviving facts): this returns a pending dict that
        :meth:`commit_ingest_dedup` finishes, or None for no facts."""
        if self.mesh is not None:
            raise NotImplementedError(_FUSED_INGEST_MESH)
        check_not_poisoned(self._poisoned)
        n = len(saliences)
        shard_modes = tuple(shard_modes)
        if n == 0:
            return None
        with self._lock:
            rows = self._alloc_rows(n)
            tid = self.tenant_id(tenant)
            k_eff = min(link_k, self.capacity)
            n_modes = len(shard_modes)
            pool_need = link_pool_size(n_modes * n * k_eff, link_accept_hint)
            slots = self._alloc_edge_slots(n + pool_need)
            chain_list, pool = slots[:n], slots[n:]
            cap, ecap = self.capacity, self.edge_state.capacity
            padded = S.pad_rows(np.asarray(rows, np.int32), cap)
            b = len(padded)
            emb = np.zeros((b, self.dim), np.float32)
            emb[:n] = np.asarray(embeddings, np.float32).reshape(n, self.dim)
            emb[n:, 0] = 1.0   # sentinel rows get a unit vector (normalizable)
            # densified chain group per fact: consecutive live facts of one
            # shard key chain on the device (a duplicate bridges its
            # neighbours)
            gid_of: Dict[str, int] = {}
            gids = [gid_of.setdefault(sk or "default", len(gid_of))
                    for sk in shard_keys]
            cols = self._pad_cols(b, [
                ([float(x) for x in saliences], 0.0, np.float32),
                ([float(t) - self.epoch for t in timestamps], 0.0, np.float32),
                ([S.TYPE_IDS.get(t, 0) for t in types], 0, np.int32),
                ([self.shard_id(sk or "default") for sk in shard_keys], -1,
                 np.int32),
                ([tid] * n, -1, np.int32),
                ([False] * n, False, bool),
                (gids, -1, np.int32),
                (chain_list, ecap, np.int32)])
            dev = self._ingest_stage.upload(
                [padded, emb, *cols,
                 link_pool_dev(pool, n_modes * b * k_eff, ecap)])
            now_abs = now if now is not None else time.time()
            now_d, chain_w, gate_d, scale_d = (
                S._scalar(x, self.device) for x in
                (now_abs - self.epoch, chain_weight, link_gate, link_scale))
            pool_len = torch.full((), len(pool), dtype=torch.int32,
                                  device=self.device)
            try:
                host, ivf_fresh = self._run_ingest(
                    "dedup_fused", S.ingest_dedup_fused,
                    [*dev, pool_len, now_d, tid, float(dedup_gate), chain_w,
                     gate_d, scale_d], k=k_eff, shard_modes=shard_modes)
            except ArenaPoisoned:
                raise
            except Exception:
                # Nothing was written: the rows and slots go back where the
                # allocation took them from, so a retry of the same facts
                # lands exactly where this batch would have.
                self._free_rows.extend(reversed(rows))
                self._free_edge_slots.extend(reversed(slots))
                raise
        ctr = host[3 + 3 * n_modes:]
        dup = host[0][:n, 0] > 0
        self.telemetry.bump("ingest.dedup_hits", int(dup.sum()))
        self.telemetry.bump("ingest.links_accepted", int(ctr[1][0, 0]))
        self.telemetry.bump("ingest.pool_slots_used", int(ctr[2][0, 0]))
        return {"rows": rows, "n": n, "k_eff": k_eff,
                "shard_modes": shard_modes, "link_scale": link_scale,
                "tenant": tenant, "now": now_abs, "dup": dup,
                "target_rows": host[1][:n, 0], "chain_src": host[2][:n, 0],
                "chain_slots": chain_list, "link_pool": pool,
                "link_host": host[3:],
                "ivf_host": ctr[3:] if ivf_fresh else None}

    def commit_ingest_dedup(self, pending: dict, ids: Sequence[Optional[str]]
                            ) -> Tuple[Dict, Dict, List, List]:
        """Host bookkeeping of :meth:`ingest_batch_dedup`
        (``lazzaro_tpu/core/index.py:commit_ingest_dedup``): register the
        surviving facts' ids (``ids[i]`` names fact ``i``; ignored, may be
        None, for a duplicate), free the duplicates' rows, keep or reclaim
        edge slots by the device's verdicts. Returns ``(candidates,
        created, merges, chains)``: per mode ``{id: [(cand_id, score),
        ...]}``, per mode the inserted ``(src_id, tgt_id, weight)`` links,
        ``[(fact_index, target_id)]`` for the merged duplicates and the
        ``(src_id, tgt_id)`` chain edges the device inserted."""
        n, rows, dup = pending["n"], pending["rows"], pending["dup"]
        tenant = pending["tenant"]
        with self._lock:
            reclaim: List[int] = []
            for i in range(n):
                if dup[i]:
                    self._free_rows.append(rows[i])   # never became alive
                    continue
                self.id_to_row[ids[i]] = rows[i]
                self.row_to_id[rows[i]] = ids[i]
            self.tenant_nodes.setdefault(tenant, set()).update(
                ids[i] for i in range(n) if not dup[i])
            merges = [(i, self.row_to_id.get(int(pending["target_rows"][i])))
                      for i in range(n) if dup[i]]
            chains: List[Tuple[str, str]] = []
            chain_src = pending["chain_src"]
            for i, slot in enumerate(pending["chain_slots"]):
                src_id = (self.row_to_id.get(int(chain_src[i]))
                          if chain_src[i] >= 0 else None)
                key = (src_id, ids[i]) if src_id and not dup[i] else None
                if key is not None and key not in self.edge_slots:
                    self.edge_slots[key] = slot
                    chains.append(key)
                else:
                    reclaim.append(slot)
            pool = pending["link_pool"]
            candidates, created, more, overflowed, consumed = self._decode_links(
                pending["link_host"], ids, n, pending["k_eff"],
                pending["shard_modes"], pool, pending["link_scale"], dup)
            if pending.get("ivf_host") is not None:
                # in-dispatch appends are routed; full clusters spill to the
                # exact-scan extras
                self._ivf_note_online(rows, [not d for d in dup],
                                      pending["ivf_host"])
            else:
                self._ivf_note_added([rows[i] for i in range(n) if not dup[i]])
            self._finish_links(pool, consumed, reclaim + more, overflowed,
                               tenant, pending["now"])
        return candidates, created, merges, chains

    def warmup_ingest(self, geometries=(256,), *, dedup_gate: float = 0.95,
                      link_k: int = 3, shard_modes=(1, 0),
                      link_accept_hint: float = 1.0) -> Dict[int, float]:
        """Build the ingest kernels and run the fused dedup ingest once per
        padded batch size (``lazzaro_tpu/core/index.py:warmup_ingest``): a
        throwaway batch of a throwaway tenant through
        :meth:`ingest_batch_dedup` + :meth:`commit_ingest_dedup`, then
        deleted. Telemetry is muted meanwhile; the wall time lands in
        ``kernel.warmup_ms{path="ingest",batch}``. Returns ``{padded_batch:
        ms}``; a size that would grow the arena is skipped."""
        out: Dict[int, float] = {}
        tel = self.telemetry
        rng = np.random.default_rng(0)
        buckets = sorted({len(S.pad_rows(np.zeros((g,), np.int32), self.capacity))
                          for g in geometries if g > 0})
        for g in buckets:
            if len(self._free_rows) < g:
                continue                    # would grow the arena
            t0 = time.perf_counter()
            prev = tel.enabled
            tel.enabled = False
            try:
                emb = rng.standard_normal((g, self.dim)).astype(np.float32)
                pending = self.ingest_batch_dedup(
                    emb, [0.5] * g, [self.epoch] * g, ["semantic"] * g,
                    ["~warmup"] * g, tenant="~warmup-ingest",
                    dedup_gate=float(dedup_gate), link_k=link_k,
                    shard_modes=tuple(shard_modes),
                    link_accept_hint=link_accept_hint)
                ids = []
                if pending is not None:
                    dup = pending["dup"]
                    ids = [None if dup[i] else f"~warm:{g}:{i}"
                           for i in range(g)]
                    self.commit_ingest_dedup(pending, ids)
                self.delete([i for i in ids if i])
            finally:
                tel.enabled = prev
            ms = (time.perf_counter() - t0) * 1e3
            tel.record("kernel.warmup_ms", ms,
                       labels={"path": "ingest", "batch": str(g)})
            out[g] = ms
        return out

    # ------------------------------------------------- fused retrieval path
    def _csr_for(self, st: Optional[S.ArenaState] = None):
        """Device CSR of the edge graph (``indptr [rows+1]``, ``nbr
        [E_pad]``, i32) for the fused neighbor gather, built from host
        bookkeeping (no device readback) and uploaded again only after an
        edge or row change. The dirty flag is cleared before the build, so
        a writer racing past marks it again. ``csr_builds`` counts the
        builds, ``csr_build_s`` is the last one's host seconds. Under a
        mesh it returns each shard's ``(indptr, nbr)`` slice
        (:func:`split_csr`) on the shard's device, one upload per device."""
        n = st.salience.shape[0] if st is not None else self.capacity + 1
        cache = self._csr_cache
        if cache is not None and not self._csr_dirty and cache[0] == n:
            return cache[1]
        self._csr_dirty = False
        t0 = time.perf_counter()
        indptr, nbr = build_host_csr(list(self.edge_slots.keys()),
                                     self.id_to_row, n,
                                     min_pad=self._csr_pad_hwm)
        self.csr_builds += 1
        self.csr_build_s = time.perf_counter() - t0
        self._csr_pad_hwm = nbr.shape[0]
        if self.mesh is None:
            out = tuple(HostStage(self.device).upload([indptr, nbr]))
        else:
            indptr_sh, nbr_sh = split_csr(indptr, nbr, self._n_parts)
            by_dev: Dict[torch.device, List[int]] = {}
            for p, d in enumerate(self.mesh.devices):
                by_dev.setdefault(d, []).append(p)
            out = [None] * self._n_parts
            for d, ps in by_dev.items():
                ip, nb = HostStage(d).upload([indptr_sh[ps], nbr_sh[ps]])
                for j, p in enumerate(ps):
                    out[p] = (ip[j], nb[j])
        self._csr_cache = (n, out)
        return out

    def _readback(self, packed: torch.Tensor) -> np.ndarray:
        """The one device-to-host copy of a fused dispatch."""
        return packed.cpu().numpy()

    def search_fused_requests(self, reqs, *, cap_take: int, max_nbr: int,
                              super_gate: float, acc_boost: float,
                              nbr_boost: float,
                              now: Optional[float] = None) -> List:
        """Serve a batch of :class:`RetrievalRequest` with one launch of the
        two-tier kernel and one packed readback
        (``lazzaro_tpu/core/index.py:search_fused_requests`` with the memory
        planner off, which is ``_search_fused_once`` in exact mode): gate,
        ANN top-k, CSR neighbor gather and, for every request that asked,
        both boosts applied in place under the state lock. A batch where no
        request boosts takes the read twin. With a published IVF build (one
        device) the program is the IVF one (``ivf`` mode,
        ``state.search_fused_ivf*``): the centroid prefilter and K5 over the
        probed clusters' members and the extras, each request's own
        ``nprobe`` as data, composed with int8 serving when it is on;
        without a build the dense program serves. With int8 serving on and
        no build the program is the quantized one (``quant`` mode,
        ``state.search_fused_quant*``): K4's keyed coarse scan of the
        shadow, the exact rescore, the same tail. Every host decision is
        made from host arrays, so the only wait on the device is the
        readback. A boosting dispatch runs under the guard."""
        check_not_poisoned(self._poisoned)
        nq = len(reqs)
        results = [RetrievalResult() for _ in range(nq)]
        if nq == 0 or not self.id_to_row:
            return results
        cap = self.capacity
        dim = self.dim
        ragged = self.serve_ragged
        if ragged:
            # the static ceiling: every request's own k rides as data
            k_bucket = int(min(max(self.serve_k_max, cap_take, 1), cap))
        else:
            k_eff = max(cap_take, max(min(int(r.k), cap) for r in reqs), 1)
            k_bucket = min(next_pow2(k_eff), cap)
        q = np.zeros((nq, dim), np.float32)
        valid = np.zeros((nq,), bool)
        tenants = np.full((nq,), -1, np.int32)
        gate_on = np.zeros((nq,), bool)
        boost_on = np.zeros((nq,), bool)
        k_arr = np.zeros((nq,), np.int32)
        cap_arr = np.zeros((nq,), np.int32)
        for i, r in enumerate(reqs):
            v = np.asarray(r.query, np.float32).reshape(-1)
            tid = self._tenants.get(r.tenant)
            if v.size != dim or tid is None:
                continue
            q[i] = v
            valid[i] = True
            tenants[i] = tid
            gate_on[i] = bool(r.gate_enabled)
            boost_on[i] = bool(r.boost)
            if ragged:
                # k_q >= cap_take, so the boosted prefix is always live
                k_arr[i] = min(max(int(r.k), cap_take, 1), k_bucket)
                cap_arr[i] = min(int(r.cap_take or cap_take), cap_take,
                                 k_bucket)
        if not valid.any():
            return results
        qp = (pad_to_bucket(q, self.serve_pad_granularity) if ragged
              else pad_to_pow2(q))
        pad_n = qp.shape[0]
        tel = self.telemetry
        tel.bump("serve.live_requests", nq)
        tel.bump("serve.padded_slots", pad_n)
        tel.gauge("serve.batch_occupancy", nq / pad_n)
        tel.record("serve.k_bucket", k_bucket)

        def padb(arr, fill=False, dt=bool):
            out = np.full((pad_n,), fill, dt)
            out[:nq] = arr
            return out

        t0 = time.perf_counter()
        with self._lock:
            ivf_tabs = self._ivf_fused_pack(k_bucket)
        mode = ("sharded_exact" if self.mesh is not None
                else "ivf" if ivf_tabs is not None
                else "quant" if self.int8_serving else "exact")
        extra = {}
        if ivf_tabs is not None:
            # the per-request probe width: the build's nprobe by default,
            # clamped to [1, nprobe]; 0 for padding
            ceil_np = ivf_tabs[3]
            np_arr = np.zeros((nq,), np.int32)
            for i, r in enumerate(reqs):
                rn = r.nprobe
                np_arr[i] = min(max(int(rn), 1), ceil_np) if rn else ceil_np
            np_arr[~valid] = 0
            extra = {"ivf_tabs": ivf_tabs, "np_arr": np_arr}
        dispatch = (self._dispatch_one if self.mesh is None
                    else self._dispatch_sharded)
        with torch.profiler.record_function(f"lz.serve.{mode}"):
            with self._lock:
                packed = dispatch(qp, padb, valid, tenants, gate_on, boost_on,
                                  k_arr, cap_arr, k_bucket,
                                  min(cap_take, k_bucket), max_nbr,
                                  super_gate, acc_boost, nbr_boost, now,
                                  **extra)
            host = self._readback(packed)
        tel.record("serve.dispatch_ms", (time.perf_counter() - t0) * 1e3,
                   labels={"mode": mode})
        tel.bump("serve.dispatches", labels={"mode": mode})
        with tel.span("serve.decode_ms"):
            gate_s, gate_r, ann_s, ann_r, fast, counters = unpack_retrieval(
                host[:nq], k_bucket)
            out = self._demux_fused(reqs, results, valid, boost_on, gate_s,
                                    gate_r, ann_s, ann_r, fast, cap,
                                    lengths=(counters[:, 0] if ragged
                                             else None))
        record_device_counters(tel, counters, fast, gate_on[:nq], valid[:nq],
                               np.asarray([min(int(r.k), cap) for r in reqs]))
        return out

    def _dispatch_sharded(self, qp, padb, valid, tenants, gate_on, boost_on,
                          k_arr, cap_arr, k_bucket, cap_take, max_nbr,
                          super_gate, acc_boost, nbr_boost, now):
        """The fused dispatch under a mesh (``state.search_fused_sharded``,
        the counterpart of ``lazzaro_tpu/core/index.py:
        _dispatch_fused_sharded`` in exact mode): one upload to the first
        device, each shard's two-tier scan, the merges, the owner-local
        boosts; returns the packed array. It is always ragged: a static
        batch gives every query the bucket's k and cap, which masks
        nothing. Called under the state lock."""
        csr = self._csr_for()
        fill_k = 0
        if not self.serve_ragged:
            fill_k = k_bucket
            k_arr = np.full_like(k_arr, k_bucket)
            cap_arr = np.full_like(cap_arr, cap_take)
        boost = bool(boost_on.any())
        cols = {"q": qp, "valid": padb(valid),
                "tenant": padb(tenants, -1, np.int32), "gate": padb(gate_on),
                "k_q": padb(k_arr, fill_k, np.int32)}
        if boost:
            cols["boost"] = padb(boost_on)
            cols["cap_q"] = padb(cap_arr, 0, np.int32)
        up = dict(zip(cols, self._stage.upload(list(cols.values()))))
        statics = dict(k=k_bucket, cap_take=cap_take, max_nbr=max_nbr,
                       k_live=int(k_arr.max()))
        if boost:
            now_rel = (now if now is not None else time.time()) - self.epoch
            return S.search_fused_sharded(
                self.shards, csr, up["q"], up["valid"], up["tenant"],
                up["gate"], up["boost"], up["k_q"], up["cap_q"], now_rel,
                super_gate, acc_boost, nbr_boost, **statics)
        return S.search_fused_sharded_read(
            self.shards, csr, up["q"], up["valid"], up["tenant"], up["gate"],
            up["k_q"], super_gate, **statics)

    def _dispatch_one(self, qp, padb, valid, tenants, gate_on, boost_on,
                      k_arr, cap_arr, k_bucket, cap_take, max_nbr,
                      super_gate, acc_boost, nbr_boost, now, ivf_tabs=None,
                      np_arr=None):
        """The single-device fused dispatch: one upload, one two-tier launch
        (or, with ``ivf_tabs``, the coarse stage and one K5 launch) and the
        tail; returns the packed array. Called under the state lock."""
        ragged = self.serve_ragged
        boost = bool(boost_on.any())
        st = self.state
        indptr, nbr = self._csr_for(st)
        quant = ()
        if self.int8_serving:
            quant = self._int8_shadow_for(st)
        cols = {"q": qp, "valid": padb(valid),
                "tenant": padb(tenants, -1, np.int32), "gate": padb(gate_on)}
        if ragged:
            cols["k_q"] = padb(k_arr, 0, np.int32)
            if ivf_tabs is not None:
                cols["np_q"] = padb(np_arr, 0, np.int32)
        if boost:
            cols["boost"] = padb(boost_on)
            if ragged:
                cols["cap_q"] = padb(cap_arr, 0, np.int32)
        up = dict(zip(cols, self._stage.upload(list(cols.values()))))
        if ivf_tabs is not None:
            return self._dispatch_ivf(st, quant or None, ivf_tabs, indptr, nbr,
                                      up, boost, k_bucket, cap_take, max_nbr,
                                      super_gate, acc_boost, nbr_boost, now)
        args = (*quant, indptr, nbr, up["q"], up["valid"], up["tenant"],
                up["gate"])
        statics = dict(k=k_bucket, cap_take=cap_take, max_nbr=max_nbr)
        if quant:
            statics["slack"] = self.coarse_slack
            fused, fused_r = S.search_fused_quant_ragged, S.search_fused_quant
            read, read_r = (S.search_fused_quant_ragged_read,
                            S.search_fused_quant_read)
        else:
            fused, fused_r = S.search_fused_ragged, S.search_fused
            read, read_r = S.search_fused_ragged_read, S.search_fused_read
            if ragged:
                statics["k_live"] = int(k_arr.max())
        if boost:
            now_rel = (now if now is not None else time.time()) - self.epoch
            scalars = (now_rel, super_gate, acc_boost, nbr_boost)

            def call():
                if ragged:
                    return fused(st, *args, up["boost"], up["k_q"],
                                 up["cap_q"], *scalars, **statics)[1]
                return fused_r(st, *args, up["boost"], *scalars, **statics)[1]

            return self._guarded(call, (st,),
                                 "serve_quant" if quant else "serve_exact")
        if ragged:
            return read(st, *args, up["k_q"], super_gate, **statics)
        return read_r(st, *args, super_gate, **statics)

    def _dispatch_ivf(self, st, shadow, ivf_tabs, indptr, nbr, up, boost,
                      k_bucket, cap_take, max_nbr, super_gate, acc_boost,
                      nbr_boost, now):
        """The fused IVF dispatch (``ivf`` mode of ``lazzaro_tpu/core/
        index.py:_search_fused_once``): ``state.search_fused_ivf*`` over the
        live tables and the extras, with the int8 ``shadow`` when int8
        serving is on; the ragged forms take the per-query ``nprobe_q``."""
        cent, members, extras, nprobe, occ, n_extras = ivf_tabs
        ragged = self.serve_ragged
        pre = (shadow, cent, members, extras, indptr, nbr, up["q"],
               up["valid"], up["tenant"], up["gate"])
        statics = dict(k=k_bucket, nprobe=nprobe, slack=self.coarse_slack,
                       cap_take=cap_take, max_nbr=max_nbr, occ=occ,
                       n_extras=n_extras)
        if boost:
            now_rel = (now if now is not None else time.time()) - self.epoch
            scalars = (now_rel, super_gate, acc_boost, nbr_boost)

            def call():
                if ragged:
                    return S.search_fused_ivf_ragged(
                        st, *pre, up["boost"], up["k_q"], up["cap_q"],
                        up["np_q"], *scalars, **statics)[1]
                return S.search_fused_ivf(st, *pre, up["boost"], *scalars,
                                          **statics)[1]

            return self._guarded(call, (st,), "serve_ivf")
        if ragged:
            return S.search_fused_ivf_ragged_read(
                st, *pre, up["k_q"], up["np_q"], super_gate, **statics)
        return S.search_fused_ivf_read(st, *pre, super_gate, **statics)

    def _demux_fused(self, reqs, results, valid, boost_on, gate_s, gate_r,
                     ann_s, ann_r, fast, cap, lengths=None):
        """Per-request decode of the unpacked readback; ``lengths`` (the
        live-length counter) bounds a ragged request's columns."""
        for i, r in enumerate(reqs):
            if not valid[i]:
                continue
            res = results[i]
            ids, scores = decode_topk(ann_s[i:i + 1], ann_r[i:i + 1],
                                      self.row_to_id, S.NEG_INF,
                                      limit=min(int(r.k), cap),
                                      lengths=(None if lengths is None
                                               else lengths[i:i + 1]))[0]
            res.ids, res.scores = ids, scores
            if gate_s[i] > S.NEG_INF / 2:
                res.gate_id = self.row_to_id.get(int(gate_r[i]))
                res.gate_score = float(gate_s[i])
            res.fast = bool(fast[i])
            res.boosted = bool(boost_on[i] and not fast[i])
        return results

    def warmup_serving(self, geometries=(8, 64), *, cap_take: int = 5,
                       max_nbr: int = 32, super_gate: float = 0.4,
                       acc_boost: float = 0.05, nbr_boost: float = 0.02,
                       k: Optional[int] = None) -> Dict[tuple, float]:
        """Build the kernels and launch the serve and read programs once per
        padded batch size, through the live entry point, with queries of a
        tenant that owns no row (no hits; every boost lands on the
        sentinel row). Serving counters are muted meanwhile. Returns
        ``{("exact", padded_batch): ms}``; a no-op on an empty index."""
        out: Dict[tuple, float] = {}
        if not self.id_to_row:
            return out
        tel = self.telemetry
        self._tenants.setdefault("~warmup", -2)   # matches no arena row
        kk = int(k if k is not None else self.serve_k_max)
        buckets = sorted({
            (bucket_size(g, self.serve_pad_granularity)
             if self.serve_ragged else next_pow2(g))
            for g in geometries if g > 0})
        kw = dict(cap_take=cap_take, max_nbr=max_nbr, super_gate=super_gate,
                  acc_boost=acc_boost, nbr_boost=nbr_boost)
        zero_q = np.zeros((self.dim,), np.float32)
        for g in buckets:
            t0 = time.perf_counter()
            prev = tel.enabled
            tel.enabled = False
            try:
                self.search_fused_requests(
                    [RetrievalRequest(query=zero_q, tenant="~warmup", k=kk,
                                      gate_enabled=True, boost=(i == 0))
                     for i in range(g)], **kw)
                self.search_fused_requests(
                    [RetrievalRequest(query=zero_q, tenant="~warmup", k=kk,
                                      gate_enabled=True)
                     for i in range(g)], **kw)
            finally:
                tel.enabled = prev
            ms = (time.perf_counter() - t0) * 1e3
            mode = ("ivf" if self._ivf_fused_pack(kk) is not None
                    else "quant" if self.int8_serving else "exact")
            tel.record("kernel.warmup_ms", ms,
                       labels={"mode": mode, "batch": str(g)})
            out[(mode, g)] = ms
        return out
