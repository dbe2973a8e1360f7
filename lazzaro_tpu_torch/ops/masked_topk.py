"""Masked cosine top-k over the embedding arena: the Hopper kernel and its
plain version.

Replaces the TPU kernel ``lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk``
(and its arena wrapper ``masked_topk_arena``). The kernel is CUDA C++ in
``csrc/masked_topk.cu``, the additive mode of the templated scan in
``csrc/topk_scan.cuh`` (whose keyed mode is ``ops.fused_topk``), built with
``nvcc`` for ``sm_90a`` on first use and bound through ``ctypes``; the
header's note says what bounds it and how it is laid out.
:func:`masked_topk` launches it for a CUDA tensor and runs
:func:`masked_topk_reference` only for a CPU tensor. The plain version is
``ops.topk.masked_topk``, the port's one plain formulation of the function.
``launches`` counts the kernel launches made through :func:`masked_topk`
and :func:`masked_topk_ragged`.

Three stage-1 routes compute the same result (:func:`route_for` picks one
from the arena dtype, the query count and d, never from N): a bf16 arena
goes through the tensor-core stage 1 (wgmma score tiles fed by TMA); an f32
arena scanned for up to ``STREAM_MAX_Q`` queries through the streaming
stage 1 (a matrix-vector scan fed by bulk copies) where a lane's registers
hold its share of the queries (:func:`stream_fits`); any other f32 scan
through the FMA stage 1. On an H100 the tensor cores tie the streaming
scan for bf16 at one query and beat it from two (``PERF.md``, Findings).
``launches_wgmma`` and ``launches_stream`` count the launches that took the
first two; ``stage_launches`` counts the CUDA kernels themselves, as the
scan's C entry point reports each launch the card took (a stage 1 and a
stage 2 for every pass of 128 list entries).

The ragged form (:func:`masked_topk_ragged`) replaces
``pallas_topk.py:pallas_masked_topk_ragged`` and its arena wrapper
``masked_topk_arena_ragged``: ``k`` is a static ceiling, ``k_q [Q]`` each
query's own k as device data, and positions at or past ``k_q[q]`` come back
as ``(NEG_INF, -1)``. :func:`masked_topk_auto` is the port of the dispatch
wrapper ``pallas_topk.py:masked_topk_auto`` and launches the same kernel.

:func:`masked_topk_grouped` scans the shards of a row-sharded arena that
share one card in one launch of each stage (the per-shard scans and the
merge of ``lazzaro_tpu/ops/topk.py:make_sharded_topk``); its plain version
is :func:`masked_topk_grouped_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from lazzaro_tpu_torch.ops import sharded_merge as merge_ops
from lazzaro_tpu_torch.ops.topk import additive_mask, ragged_mask
from lazzaro_tpu_torch.ops.topk import masked_topk as masked_topk_reference
from lazzaro_tpu_torch.utils import cuda_build

# Longest per-query list the kernel keeps; a larger k runs in passes.
MAX_K = 128
# The streaming route takes an f32 scan of up to STREAM_MAX_Q queries where
# a lane holds its share of its query group in STREAM_QREGS registers and
# at most STREAM_MAX_GROUPS groups (each re-reads every row) cover the
# queries (stream_fits): d up to 3,072 at one query.
STREAM_MAX_Q = 16
STREAM_QREGS = 96
STREAM_MAX_GROUPS = 4
ROUTES = {"fma": 0, "wgmma": 1, "stream": 2}
# Shards one launch scans at most (kMaxShards of csrc/topk_scan.cuh).
MAX_SHARDS = 64

launches = 0
launches_wgmma = 0
launches_stream = 0
stage_launches = 0

_lib = None
_sm_count: Dict[int, int] = {}


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("masked_topk")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.masked_topk_splits.argtypes = [i64, i32, i32, i32, i32, i32, i32]
        lib.masked_topk_splits.restype = i32
        lib.masked_topk_grouped.argtypes = [
            ptr, ptr, ptr, i32, i32, ptr, i64, i32, i32, i32, ptr, i64, i32, i32,
            ptr, ptr, ptr, ptr, ptr, ptr]
        lib.masked_topk_grouped.restype = i32
        _lib = lib
    return _lib


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def stream_groups(d: int, nq: int) -> Tuple[int, int]:
    """``(groups, values)`` of a streaming launch, as ``stream_shape`` in
    ``csrc/topk_scan.cuh`` lays it out: the query tile (``nq`` rounded up
    to a power of two) is cut into groups of up to 4 queries, each summed
    by its own math warps, and a lane holds ``values`` query values (its
    8-element slots of the row, ``g`` lanes a row, times its group's
    queries); groups are as large as ``STREAM_QREGS`` values and ``g``
    allow."""
    qt = 1 << max(0, nq - 1).bit_length()
    slots = d // 8
    g = min(32, 1 << max(0, slots - 1).bit_length())
    per_query = 8 * -(-slots // g)
    qg = 4
    while qg > 1 and (qg > qt or qg > g or qg * per_query > STREAM_QREGS):
        qg //= 2
    return qt // qg, qg * per_query


def stream_fits(d: int, nq: int) -> bool:
    """Whether the streaming stage 1 takes ``nq`` queries of width ``d``:
    up to ``STREAM_MAX_Q`` queries whose values fit a lane's registers, in
    at most ``STREAM_MAX_GROUPS`` query groups. Each group re-reads every
    row from shared memory, so past four the FMA stage is faster on an
    H100 (``PERF.md``); up to d = 768 that holds every Q <= 16, up to 1,536
    Q <= 8, up to 3,072 Q <= 4."""
    if nq > STREAM_MAX_Q:
        return False
    groups, values = stream_groups(d, nq)
    return groups <= STREAM_MAX_GROUPS and values <= STREAM_QREGS


def route_for(dtype: torch.dtype, nq: int, d: int) -> str:
    """The stage-1 route of a scan of ``nq`` queries of width ``d``:
    ``"wgmma"`` (tensor cores) for a bf16 arena, ``"stream"`` for an f32
    one where :func:`stream_fits`, else ``"fma"``. It does not depend on
    N, so every shard of a row-sharded arena takes the route one device
    would take for the same batch."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "stream" if stream_fits(d, nq) else "fma"


def passes(kmax: int) -> int:
    """Passes of 128 list entries a scan to ``kmax`` runs: each is one
    stage-1 and one stage-2 launch."""
    return (kmax + MAX_K - 1) // MAX_K


def check_arena(emb: torch.Tensor, what: str) -> None:
    """What every route needs of an arena (shard): a contiguous, 16-byte
    aligned ``[N, d]`` f32 or bf16 tensor with ``d % 8 == 0``."""
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes f32 or bf16 arenas, not {emb.dtype}")
    if emb.ndim != 2 or not emb.is_contiguous():
        raise ValueError(f"{what} needs a contiguous [N, d] arena")
    if emb.shape[1] % 8 or emb.data_ptr() % 16:
        raise ValueError(f"{what} needs d % 8 == 0 and 16-byte aligned rows")


def _launch_table(embs, madds, bases, queries, k, k_q, route, tail_row=-1):
    """One scan of the shards ``embs`` (rows of shard i global from
    ``bases[i]``) on their card: a stage 1 and a stage 2 a pass. Returns
    ``(scores [Q, k] f32, rows [Q, k] i64)``."""
    global launches, launches_wgmma, launches_stream, stage_launches
    shards = len(embs)
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"masked_topk takes 1 to {MAX_SHARDS} shards a launch, "
                         f"not {shards}")
    for emb in embs:
        check_arena(emb, "masked_topk")
    emb0 = embs[0]
    n, d = emb0.shape
    dev = emb0.device
    if any(e.shape != (n, d) or e.dtype != emb0.dtype or e.device != dev
           for e in embs):
        raise ValueError("masked_topk: the shards of a launch must be [N, d] "
                         "arenas of one dtype on one device")
    if not 1 <= k <= shards * n:
        raise ValueError(f"masked_topk needs 1 <= k <= N; k={k}, N={shards * n}")
    # Queries are cast to the arena dtype before the dot, as the TPU kernel
    # does (pallas_topk.py:62); the kernel sums in f32.
    q = torch.atleast_2d(queries).to(device=dev, dtype=emb0.dtype).contiguous()
    madds = [m.to(device=dev, dtype=torch.float32).contiguous() for m in madds]
    if q.shape[1] != d or any(m.shape != (n,) for m in madds):
        raise ValueError("masked_topk: queries [Q, d] and mask [N] must match emb")
    nq = q.shape[0]
    if k_q is not None:
        k_q = k_q.to(device=dev, dtype=torch.int32).contiguous()
        if k_q.shape != (nq,):
            raise ValueError("masked_topk: k_q must be [Q]")
    route = route or route_for(emb0.dtype, nq, d)
    lib = _library()
    bf16 = int(emb0.dtype == torch.bfloat16)
    splits = lib.masked_topk_splits(n, shards, nq, k, ROUTES[route], _sms(dev), d)
    kc = min(k, MAX_K)
    cand_s = torch.empty((shards * splits, nq, kc), dtype=torch.float32, device=dev)
    cand_r = torch.empty((shards * splits, nq, kc), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((nq, k), dtype=torch.int64, device=dev)
    ptrs = ctypes.c_void_p * shards
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masked_topk_grouped(
            ptrs(*[e.data_ptr() for e in embs]), ptrs(*[m.data_ptr() for m in madds]),
            (ctypes.c_longlong * shards)(*[int(b) for b in bases]), shards, bf16,
            q.data_ptr(), n, d, nq, k, None if k_q is None else k_q.data_ptr(),
            tail_row, ROUTES[route], splits, cand_s.data_ptr(), cand_r.data_ptr(),
            out_s.data_ptr(), out_r.data_ptr(), ctypes.byref(launched), stream)
    stage_launches += launched.value
    if rc != 0:
        raise RuntimeError(f"masked_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    launches_stream += route == "stream"
    return out_s, out_r


def _launch(emb: torch.Tensor, madd: torch.Tensor, queries: torch.Tensor,
            k: int, k_q: Optional[torch.Tensor] = None,
            route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan on the card. ``route`` forces a stage 1 (a record of another
    route at the same shape); by default :func:`route_for` picks it. The
    card refuses the tensor-core route for an f32 arena and the streaming
    route for a bf16 one or where :func:`stream_fits` does not hold: that
    raises."""
    return _launch_table([emb], [madd], [0], queries, k, k_q, route)


def masked_topk(emb: torch.Tensor, mask: torch.Tensor, queries: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k: ``emb [N, d]`` (f32 or bf16, L2-normalized rows),
    ``mask [N]`` (bool alive mask or additive f32), ``queries [Q, d]``.
    Returns ``(scores [Q, k] f32, rows [Q, k] i64)``, score-descending and
    row-ascending on ties. A CUDA arena launches the kernel (any N, any Q,
    1 <= k <= N); a CPU arena runs the plain version."""
    if emb.device.type == "cuda":
        return _launch(emb, additive_mask(mask), queries, k)
    if emb.device.type == "cpu":
        return masked_topk_reference(emb, mask, queries, k)
    raise ValueError(f"masked_topk: unsupported device {emb.device}")


def masked_topk_ragged_reference(emb: torch.Tensor, mask: torch.Tensor,
                                 queries: torch.Tensor, k_q: torch.Tensor,
                                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ragged version: :func:`masked_topk_reference` to the ceiling,
    then ``(NEG_INF, -1)`` at positions at or past ``k_q``."""
    s, r = masked_topk_reference(emb, mask, torch.atleast_2d(queries), k)
    return ragged_mask(s, r, k_q, -1)


def masked_topk_ragged(emb: torch.Tensor, mask: torch.Tensor,
                       queries: torch.Tensor, k_q: torch.Tensor,
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged masked cosine top-k (``masked_topk_arena_ragged``): the
    ``[Q, k]`` result of :func:`masked_topk` at the static ceiling ``k``,
    with positions at or past ``k_q[q]`` (``[Q]`` i32) set to ``(NEG_INF,
    -1)``. A CUDA arena launches the kernel, which writes the tail itself;
    a CPU arena runs the plain version."""
    if emb.device.type == "cuda":
        return _launch(emb, additive_mask(mask), queries, k, k_q)
    if emb.device.type == "cpu":
        return masked_topk_ragged_reference(emb, mask, queries, k_q, k)
    raise ValueError(f"masked_topk_ragged: unsupported device {emb.device}")


def masked_topk_auto(emb: torch.Tensor, madd: torch.Tensor,
                     queries: torch.Tensor, k: int = 10
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pallas_topk.py:masked_topk_auto``: the JAX dispatch between the TPU
    kernel and its interpret mode. Here the device of the arena decides,
    as in :func:`masked_topk`, which it calls."""
    return masked_topk(emb, madd, queries, k)


def masked_topk_grouped_reference(embs: Sequence[torch.Tensor],
                                  masks: Sequence[torch.Tensor],
                                  queries: torch.Tensor, k: int,
                                  shard_ids: Sequence[int]
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`masked_topk_grouped`: each shard's plain scan
    at ``k_l = min(k, L)`` and the plain cross-shard merge (rows made global
    from ``shard_ids``), as ``make_sharded_topk`` composes them."""
    local_n = embs[0].shape[0]
    k_l = min(k, local_n)
    parts = [masked_topk_reference(e, m, torch.atleast_2d(queries).to(e.device), k_l)
             for e, m in zip(embs, masks)]
    return merge_ops.sharded_merge_reference(
        [s for s, _ in parts],
        [r + p * local_n for p, (_, r) in zip(shard_ids, parts)], 0, k)


def masked_topk_grouped(embs: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                        queries: torch.Tensor, k: int,
                        shard_ids: Optional[Sequence[int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked top-k of ``queries`` over the shards ``embs`` (``[L, d]``
    each, with their ``[L]`` masks), shard ``i`` holding the global rows
    ``shard_ids[i] * L ..`` (default ``i * L``; the ids ascend): ``(scores
    [Q, k] f32, global rows [Q, k] i32)``, ties to the lower global row.
    Shards on one CUDA device are one launch of each stage for the lot;
    CPU shards run :func:`masked_topk_grouped_reference`."""
    shard_ids = list(range(len(embs))) if shard_ids is None else list(shard_ids)
    dev = embs[0].device
    if dev.type == "cuda":
        local_n = embs[0].shape[0]
        # One conversion for every shard's mask, read in place per shard.
        madd = additive_mask(torch.cat(list(masks))).split(local_n)
        s, r = _launch_table(list(embs), madd, [p * local_n for p in shard_ids],
                             queries, k, None, None)
        return s, r.int()
    if dev.type == "cpu":
        return masked_topk_grouped_reference(embs, masks, queries, k, shard_ids)
    raise ValueError(f"masked_topk_grouped: unsupported device {dev}")
