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
kernel launches made through :func:`fused_topk`, ``launches_wgmma`` those
that took the tensor-core stage 1 (``ops.masked_topk.route_for``: a bf16
arena and more than 16 queries).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import chunked_map, nt_dot
from lazzaro_tpu_torch.ops.masked_topk import ROUTES, _sms, route_for
from lazzaro_tpu_torch.ops.topk import NEG_INF, ragged_mask, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

# Longest per-query list the kernel keeps; a larger k runs in passes.
MAX_K = 128

launches = 0
launches_wgmma = 0

_lib = None

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("fused_topk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fused_topk_splits.argtypes = [ctypes.c_longlong, i32, i32, i32,
                                          i32]
        lib.fused_topk_splits.restype = i32
        lib.fused_topk.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, i32,
            i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ptr, ptr]
        lib.fused_topk.restype = ctypes.c_int
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


def _launch(emb, alive, tenant_id, is_super, queries, tenant, k_q, k,
            sentinel, k_live, route=None) -> Result:
    """One scan on the card; ``route`` forces a stage 1 as in
    ``ops.masked_topk._launch``."""
    global launches, launches_wgmma
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_topk takes f32 or bf16 arenas, not {emb.dtype}")
    if emb.ndim != 2 or not emb.is_contiguous():
        raise ValueError("fused_topk needs a contiguous [N, d] arena")
    n, d = emb.shape
    if d % 8 or emb.data_ptr() % 16:
        raise ValueError("fused_topk needs d % 8 == 0 and 16-byte aligned rows")
    if not 1 <= k <= n:
        raise ValueError(f"fused_topk needs 1 <= k <= N; k={k}, N={n}")
    kmax = k if k_live is None else min(k, max(1, int(k_live)))
    dev = emb.device
    cols = (alive, tenant_id, is_super)
    if any(c.shape != (n,) or c.device != dev or not c.is_contiguous()
           for c in cols):
        raise ValueError("fused_topk: alive, tenant_id and is_super must be "
                         "contiguous [N] columns on the arena's device")
    if alive.dtype != torch.bool or is_super.dtype != torch.bool \
            or tenant_id.dtype != torch.int32:
        raise TypeError("fused_topk: alive/is_super bool, tenant_id int32")
    q = queries.to(device=dev, dtype=emb.dtype).contiguous()
    nq = q.shape[0]
    if q.ndim != 2 or q.shape[1] != d:
        raise ValueError("fused_topk: queries must be [Q, d]")
    ten = tenant.to(device=dev, dtype=torch.int32).contiguous()
    kq = None if k_q is None else k_q.to(device=dev, dtype=torch.int32).contiguous()
    if ten.shape != (nq,) or (kq is not None and kq.shape != (nq,)):
        raise ValueError("fused_topk: tenant and k_q must be [Q]")
    route = route or route_for(emb.dtype, nq)
    lib = _library()
    splits = lib.fused_topk_splits(n, nq, kmax, ROUTES[route], _sms(dev))
    kc = min(kmax, MAX_K)
    f32, i32 = torch.float32, torch.int32
    gate_cs = torch.empty((splits, nq), dtype=f32, device=dev)
    gate_cr = torch.empty((splits, nq), dtype=i32, device=dev)
    cand_s = torch.empty((splits, nq, kc), dtype=f32, device=dev)
    cand_r = torch.empty((splits, nq, kc), dtype=i32, device=dev)
    gate_s = torch.empty((nq,), dtype=f32, device=dev)
    gate_r = torch.empty((nq,), dtype=i32, device=dev)
    ann_s = torch.empty((nq, k), dtype=f32, device=dev)
    ann_r = torch.empty((nq, k), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_topk(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16), alive.data_ptr(),
            tenant_id.data_ptr(), is_super.data_ptr(), q.data_ptr(),
            ten.data_ptr(), None if kq is None else kq.data_ptr(), n, d, nq,
            k, kmax, int(sentinel), ROUTES[route], splits, gate_cs.data_ptr(),
            gate_cr.data_ptr(), cand_s.data_ptr(), cand_r.data_ptr(),
            gate_s.data_ptr(), gate_r.data_ptr(), ann_s.data_ptr(),
            ann_r.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    return gate_s, gate_r, ann_s, ann_r


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
