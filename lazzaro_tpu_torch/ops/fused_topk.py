"""Two-tier ragged masked top-k over the arena: the scan of the fused serving
path, as a Hopper kernel and its plain version.

The kernel (``csrc/fused_topk.cu``, the keyed mode of the templated scan in
``csrc/topk_scan.cuh`` whose additive mode is ``ops.masked_topk``; CUDA C++
for ``sm_90a``, built with ``nvcc`` on first use and bound through
``ctypes``) stands for two TPU-side functions of the JAX package:

- ``lazzaro_tpu/ops/pallas_topk.py:pallas_masked_topk_ragged``, whose
  contract it keeps: a static ceiling ``k``, each query's own ``k_q`` as
  device data, positions at or past ``k_q`` masked;
- the XLA scan it replaces on the fused serving path,
  ``lazzaro_tpu/core/state.py:_exact_two_tier`` + ``_ragged_topk_mask``: a
  super-node top-1 (the gate) and a non-super top-k (the ANN tier) over one
  score matrix, each masked per query by ``alive & tenant == tenant[q]``.

:func:`fused_topk` launches the kernel for a CUDA arena and runs
:func:`fused_topk_reference` only for a CPU arena. ``launches`` counts the
kernel launches made through :func:`fused_topk` and
:func:`fused_topk_grouped`, ``launches_wgmma`` and ``launches_stream``
those that took the tensor-core and the streaming stage 1
(``ops.masked_topk.route_for``), ``stage_launches`` the CUDA kernels as the
scan's C entry point reports them (a stage 1 and a stage 2 a pass of 128
list entries).

:func:`fused_topk_grouped` is the scan and both merges of the fused
sharded program (``state.py:make_fused_sharded``, exact mode) for the
shards that share one card: one launch of each stage a pass, masked pairs
on the global sentinel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import chunked_map, nt_dot
from lazzaro_tpu_torch.ops.masked_topk import (MAX_SHARDS, ROUTES, _sms,
                                               check_arena, route_for)
from lazzaro_tpu_torch.ops import sharded_merge as merge_ops
from lazzaro_tpu_torch.ops.topk import NEG_INF, ragged_mask, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

# Longest per-query list the kernel keeps; a larger k runs in passes.
MAX_K = 128

launches = 0
launches_wgmma = 0
launches_stream = 0
stage_launches = 0

_lib = None

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("fused_topk")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_topk_splits.argtypes = [i64, i32, i32, i32, i32, i32, i32]
        lib.fused_topk_splits.restype = i32
        lib.fused_topk_grouped.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i64, i32, i32, i32,
            i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr]
        lib.fused_topk_grouped.restype = i32
        _lib = lib
    return _lib


def fused_topk_reference(emb: torch.Tensor, alive: torch.Tensor,
                         tenant_id: torch.Tensor, is_super: torch.Tensor,
                         queries: torch.Tensor, tenant: torch.Tensor,
                         k_q: Optional[torch.Tensor], k: int,
                         sentinel: Optional[int] = None) -> Result:
    """Plain version: ``torch.matmul`` scores (queries cast to the arena
    dtype, f32 sums), ``torch.where`` per tier, :func:`stable_topk` for the
    gate top-1 and the ANN top-``k``, then the ``k_q`` tail mask. Chunked by
    query like every plain arena scan."""
    sentinel = emb.shape[0] - 1 if sentinel is None else int(sentinel)
    rows = emb.float()
    q = queries.to(emb.dtype)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=emb.device)
    tenant = tenant.to(emb.device)

    def chunk(q_c, ten_c):
        scores = nt_dot(q_c, rows)
        alive_t = alive[None, :] & (tenant_id[None, :] == ten_c[:, None])
        gate_s, gate_r = stable_topk(
            torch.where(alive_t & is_super[None, :], scores, neg), 1)
        ann_s, ann_r = stable_topk(
            torch.where(alive_t & ~is_super[None, :], scores, neg), k)
        return gate_s[:, 0], gate_r[:, 0], ann_s, ann_r

    gate_s, gate_r, ann_s, ann_r = chunked_map(
        lambda idx: chunk(q[idx], tenant[idx]),
        torch.arange(q.shape[0], device=emb.device))
    if k_q is not None:
        ann_s, ann_r = ragged_mask(ann_s, ann_r, k_q, sentinel)
    return gate_s, gate_r.int(), ann_s, ann_r.int()


def _launch_table(states, bases, queries, tenant, k_q, k, tail_row, k_live,
                  mask_dead, route=None) -> Result:
    """One scan of the shards ``states`` (``(emb, alive, tenant_id,
    is_super)`` each, rows of shard i global from ``bases[i]``) on their
    card: a stage 1 and a stage 2 a pass."""
    global launches, launches_wgmma, launches_stream, stage_launches
    shards = len(states)
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"fused_topk takes 1 to {MAX_SHARDS} shards a launch, "
                         f"not {shards}")
    emb0 = states[0][0]
    n, d = emb0.shape
    dev = emb0.device
    for emb, alive, tenant_id, is_super in states:
        check_arena(emb, "fused_topk")
        if emb.shape != (n, d) or emb.dtype != emb0.dtype or emb.device != dev:
            raise ValueError("fused_topk: the shards of a launch must be [N, d] "
                             "arenas of one dtype on one device")
        cols = (alive, tenant_id, is_super)
        if any(c.shape != (n,) or c.device != dev or not c.is_contiguous()
               for c in cols):
            raise ValueError("fused_topk: alive, tenant_id and is_super must be "
                             "contiguous [N] columns on the arena's device")
        if alive.dtype != torch.bool or is_super.dtype != torch.bool \
                or tenant_id.dtype != torch.int32:
            raise TypeError("fused_topk: alive/is_super bool, tenant_id int32")
    if not 1 <= k <= shards * n:
        raise ValueError(f"fused_topk needs 1 <= k <= N; k={k}, N={shards * n}")
    kmax = k if k_live is None else min(k, max(1, int(k_live)))
    q = queries.to(device=dev, dtype=emb0.dtype).contiguous()
    nq = q.shape[0]
    if q.ndim != 2 or q.shape[1] != d:
        raise ValueError("fused_topk: queries must be [Q, d]")
    ten = tenant.to(device=dev, dtype=torch.int32).contiguous()
    kq = None if k_q is None else k_q.to(device=dev, dtype=torch.int32).contiguous()
    if ten.shape != (nq,) or (kq is not None and kq.shape != (nq,)):
        raise ValueError("fused_topk: tenant and k_q must be [Q]")
    route = route or route_for(emb0.dtype, nq, d)
    lib = _library()
    bf16 = int(emb0.dtype == torch.bfloat16)
    splits = lib.fused_topk_splits(n, shards, nq, kmax, ROUTES[route], _sms(dev), d)
    kc = min(kmax, MAX_K)
    f32, i32 = torch.float32, torch.int32
    slots = shards * splits
    gate_cs = torch.empty((slots, nq), dtype=f32, device=dev)
    gate_cr = torch.empty((slots, nq), dtype=i32, device=dev)
    cand_s = torch.empty((slots, nq, kc), dtype=f32, device=dev)
    cand_r = torch.empty((slots, nq, kc), dtype=i32, device=dev)
    gate_s = torch.empty((nq,), dtype=f32, device=dev)
    gate_r = torch.empty((nq,), dtype=i32, device=dev)
    ann_s = torch.empty((nq, k), dtype=f32, device=dev)
    ann_r = torch.empty((nq, k), dtype=i32, device=dev)
    ptrs = ctypes.c_void_p * shards
    launched = ctypes.c_int(0)

    def col(i):
        return ptrs(*[st[i].data_ptr() for st in states])

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_topk_grouped(
            col(0), col(1), col(2), col(3),
            (ctypes.c_longlong * shards)(*[int(b) for b in bases]), shards, bf16,
            q.data_ptr(), ten.data_ptr(), None if kq is None else kq.data_ptr(), n,
            d, nq, k, kmax, int(tail_row), int(mask_dead), ROUTES[route], splits,
            gate_cs.data_ptr(), gate_cr.data_ptr(), cand_s.data_ptr(),
            cand_r.data_ptr(), gate_s.data_ptr(), gate_r.data_ptr(),
            ann_s.data_ptr(), ann_r.data_ptr(), ctypes.byref(launched), stream)
    stage_launches += launched.value
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    launches_stream += route == "stream"
    return gate_s, gate_r, ann_s, ann_r


def _launch(emb, alive, tenant_id, is_super, queries, tenant, k_q, k,
            sentinel, k_live, route=None) -> Result:
    """One scan on the card; ``route`` forces a stage 1 as in
    ``ops.masked_topk._launch``."""
    return _launch_table([(emb, alive, tenant_id, is_super)], [0], queries,
                         tenant, k_q, k, sentinel, k_live, False, route)


def fused_topk(emb: torch.Tensor, alive: torch.Tensor, tenant_id: torch.Tensor,
               is_super: torch.Tensor, queries: torch.Tensor,
               tenant: torch.Tensor, k_q: Optional[torch.Tensor], k: int,
               sentinel: Optional[int] = None,
               k_live: Optional[int] = None) -> Result:
    """Two-tier masked cosine top-k of ``queries [Q, d]`` (cast to the arena
    dtype, f32 sums) over ``emb [N, d]``, each query masked to its own
    ``tenant [Q]``. Returns ``(gate_s [Q] f32, gate_r [Q] i32, ann_s [Q, k]
    f32, ann_r [Q, k] i32)``: the top-1 over live super rows and the
    top-``k`` over live non-super rows, score-descending, ties to the lowest
    row, other rows scoring ``NEG_INF``. With ``k_q [Q]`` the positions at
    or past ``k_q[q]`` are ``(NEG_INF, sentinel)`` (default sentinel: the
    last row, the arena's scratch row). ``k_live``, a host int ``>=
    max(k_q)``, lets the kernel stop its lists there instead of at ``k``;
    the result is the same. A CUDA arena launches the kernel; a CPU arena
    runs the plain version."""
    if sentinel is None:
        sentinel = emb.shape[0] - 1
    if emb.device.type == "cuda":
        return _launch(emb, alive, tenant_id, is_super, queries, tenant, k_q,
                       k, sentinel, k_live)
    if emb.device.type == "cpu":
        return fused_topk_reference(emb, alive, tenant_id, is_super, queries,
                                    tenant, k_q, k, sentinel)
    raise ValueError(f"fused_topk: unsupported device {emb.device}")


def fused_topk_grouped_reference(states, queries: torch.Tensor,
                                 tenant: torch.Tensor, k_q: Optional[torch.Tensor],
                                 k: int, sentinel: int,
                                 shard_ids: Sequence[int]) -> Result:
    """Plain version of :func:`fused_topk_grouped`: each shard's plain
    two-tier scan at ``k_l = min(k, L)`` without ``k_q``, then the plain
    ANN merge (with ``k_q`` and the sentinel) and gate merge, rows made
    global from ``shard_ids`` (``make_fused_sharded._scan_merge``)."""
    local_n = states[0][0].shape[0]
    k_l = max(1, min(k, local_n))
    parts = [fused_topk_reference(*st, queries.to(st[0].device),
                                  tenant.to(st[0].device), None, k_l)
             for st in states]
    offs = [p * local_n for p in shard_ids]
    ann_s, ann_r = merge_ops.sharded_merge_reference(
        [x[2] for x in parts], [x[3] + o for x, o in zip(parts, offs)], 0, k,
        k_q=k_q, sentinel=sentinel)
    gate_s, gate_r = merge_ops.sharded_merge_reference(
        [x[0][:, None] for x in parts],
        [x[1][:, None] + o for x, o in zip(parts, offs)], 0, 1, sentinel=sentinel)
    return gate_s[:, 0], gate_r[:, 0], ann_s, ann_r


def fused_topk_grouped(states, queries: torch.Tensor, tenant: torch.Tensor,
                       k_q: Optional[torch.Tensor], k: int, sentinel: int,
                       k_live: Optional[int] = None,
                       shard_ids: Optional[Sequence[int]] = None) -> Result:
    """The two-tier scan of ``queries`` over the shards ``states``
    (``(emb, alive, tenant_id, is_super)`` of ``L`` rows each), shard ``i``
    holding the global rows ``shard_ids[i] * L ..`` (default ``i * L``; the
    ids ascend): ``(gate_s [Q], gate_r [Q], ann_s [Q, k], ann_r [Q, k])``
    with global rows, every masked pair (scoring ``NEG_INF``) on
    ``sentinel``, and positions at or past ``k_q`` ``(NEG_INF, sentinel)``.
    ``k <= n * L``; ``k_live`` as in :func:`fused_topk`. Shards on one CUDA
    device are one launch of each stage a pass; CPU shards run
    :func:`fused_topk_grouped_reference`."""
    shard_ids = list(range(len(states))) if shard_ids is None else list(shard_ids)
    dev = states[0][0].device
    if dev.type == "cuda":
        local_n = states[0][0].shape[0]
        return _launch_table(list(states), [p * local_n for p in shard_ids],
                             queries, tenant, k_q, k, sentinel, k_live, True)
    if dev.type == "cpu":
        return fused_topk_grouped_reference(states, queries, tenant, k_q, k,
                                            sentinel, shard_ids)
    raise ValueError(f"fused_topk_grouped: unsupported device {dev}")
