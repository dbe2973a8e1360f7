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

Two routes compute the same result (:func:`route_for` picks one from the
arena dtype and the query count, never from N): a bf16 arena scanned for
more than ``WGMMA_MIN_Q`` queries goes through the tensor-core stage 1
(wgmma score tiles fed by TMA), anything else through the FMA stage 1.
``launches_wgmma`` counts the launches that took the tensor-core route.

The ragged form (:func:`masked_topk_ragged`) replaces
``pallas_topk.py:pallas_masked_topk_ragged`` and its arena wrapper
``masked_topk_arena_ragged``: ``k`` is a static ceiling, ``k_q [Q]`` each
query's own k as device data, and positions at or past ``k_q[q]`` come back
as ``(NEG_INF, -1)``. :func:`masked_topk_auto` is the port of the dispatch
wrapper ``pallas_topk.py:masked_topk_auto`` and launches the same kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from lazzaro_tpu_torch.ops.topk import additive_mask, ragged_mask
from lazzaro_tpu_torch.ops.topk import masked_topk as masked_topk_reference
from lazzaro_tpu_torch.utils import cuda_build

# Longest per-query list the kernel keeps; a larger k runs in passes.
MAX_K = 128
# Above this many queries a bf16 scan runs on the tensor cores; at or below
# it the scan is a bandwidth-bound matrix-vector product (FMA route).
WGMMA_MIN_Q = 16
ROUTES = {"fma": 0, "wgmma": 1}

launches = 0
launches_wgmma = 0

_lib = None
_sm_count: Dict[int, int] = {}


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("masked_topk")
        lib.masked_topk_splits.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int]
        lib.masked_topk_splits.restype = ctypes.c_int
        lib.masked_topk.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.masked_topk.restype = ctypes.c_int
        lib.masked_topk_ragged.argtypes = (
            lib.masked_topk.argtypes[:8]
            + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
            + lib.masked_topk.argtypes[8:])
        lib.masked_topk_ragged.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def route_for(dtype: torch.dtype, nq: int) -> str:
    """The stage-1 route of a scan: ``"wgmma"`` (tensor cores) for a bf16
    arena and more than ``WGMMA_MIN_Q`` queries, else ``"fma"``. It depends
    on nothing else, so every shard of a row-sharded arena takes the route
    one device would take for the same batch."""
    return "wgmma" if dtype == torch.bfloat16 and nq > WGMMA_MIN_Q else "fma"


def _launch(emb: torch.Tensor, madd: torch.Tensor, queries: torch.Tensor,
            k: int, k_q: Optional[torch.Tensor] = None,
            route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scan on the card. ``route`` forces a stage 1 (a record of the
    tensor-core route at small Q); by default :func:`route_for` picks it.
    The card refuses the tensor-core route for an f32 arena: that raises."""
    global launches, launches_wgmma
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"masked_topk takes f32 or bf16 arenas, not {emb.dtype}")
    if emb.ndim != 2 or not emb.is_contiguous():
        raise ValueError("masked_topk needs a contiguous [N, d] arena")
    n, d = emb.shape
    if d % 8 or emb.data_ptr() % 16:
        raise ValueError("masked_topk needs d % 8 == 0 and 16-byte aligned rows")
    if not 1 <= k <= n:
        raise ValueError(f"masked_topk needs 1 <= k <= N; k={k}, N={n}")
    dev = emb.device
    # Queries are cast to the arena dtype before the dot, as the TPU kernel
    # does (pallas_topk.py:62); the kernel sums in f32.
    q = torch.atleast_2d(queries).to(device=dev, dtype=emb.dtype).contiguous()
    madd = madd.to(device=dev, dtype=torch.float32).contiguous()
    if q.shape[1] != d or madd.shape != (n,):
        raise ValueError("masked_topk: queries [Q, d] and mask [N] must match emb")
    nq = q.shape[0]
    if k_q is not None:
        k_q = k_q.to(device=dev, dtype=torch.int32).contiguous()
        if k_q.shape != (nq,):
            raise ValueError("masked_topk: k_q must be [Q]")
    route = route or route_for(emb.dtype, nq)
    lib = _library()
    splits = lib.masked_topk_splits(n, nq, k, ROUTES[route], _sms(dev))
    kc = min(k, MAX_K)
    cand_s = torch.empty((splits, nq, kc), dtype=torch.float32, device=dev)
    cand_r = torch.empty((splits, nq, kc), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((nq, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.masked_topk_ragged(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16), madd.data_ptr(),
            q.data_ptr(), n, d, nq, k,
            None if k_q is None else k_q.data_ptr(), -1, ROUTES[route], splits,
            cand_s.data_ptr(), cand_r.data_ptr(), out_s.data_ptr(),
            out_r.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"masked_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    return out_s, out_r


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
