"""Cross-shard merge of per-shard top-k candidates: the Hopper kernel and its
plain version.

The kernel (``csrc/sharded_merge.cu``; CUDA C++ for ``sm_90a``, built with
``nvcc`` on first use and bound through ``ctypes``) replaces the combine of
the TPU kernel ``lazzaro_tpu/ops/topk.py:make_sharded_topk`` (:115): the
``all_gather`` + global top-k of ``sharded_topk_merge`` (:47) with the row
globalization of :165 and ``core/state.py:_globalize_rows``. The source's
note says what it computes, how and what bounds it. The row-sharded top-k
(``ops.topk.make_sharded_topk``) and the fused sharded serving program
(``core.state.search_fused_sharded``) share it.

:func:`sharded_merge` launches the kernel when the merge's device is a CUDA
device and runs :func:`sharded_merge_reference` (``ops.topk.
sharded_topk_merge``) only when it is the CPU. ``launches`` counts the
kernel launches made through :func:`sharded_merge`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from lazzaro_tpu_torch.ops.topk import \
    sharded_topk_merge as sharded_merge_reference
from lazzaro_tpu_torch.utils import cuda_build

launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("sharded_merge")
        lib.sharded_merge_max_shards.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sharded_merge.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                      ctypes.c_longlong, ptr, i32, i32, ptr,
                                      ptr, ptr]
        lib.sharded_merge.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(top_s, top_i, local_n, k, k_q, sentinel, dev):
    global launches
    n = len(top_s)
    lib = _library()
    if not 1 <= n <= lib.sharded_merge_max_shards():
        raise ValueError(f"sharded_merge takes 1 to "
                         f"{lib.sharded_merge_max_shards()} shards, not {n}")
    # Each shard's lists come to the merge's device (a no-op when the shard
    # lives there) and are read in place.
    s_list = [s.to(dev, non_blocking=True).contiguous() for s in top_s]
    r_list = [r.to(dev, non_blocking=True).contiguous() for r in top_i]
    nq, kl = s_list[0].shape
    r_dtype = r_list[0].dtype
    if r_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sharded_merge takes i32 or i64 rows, not {r_dtype}")
    if any(s.dtype != torch.float32 or s.shape != (nq, kl) for s in s_list) \
            or any(r.dtype != r_dtype or r.shape != (nq, kl) for r in r_list):
        raise ValueError("sharded_merge: every shard's lists must be "
                         "[Q, kl], f32 scores and rows of one int type")
    if not 1 <= k <= n * kl:
        raise ValueError(f"sharded_merge needs 1 <= k <= n * kl; k={k}, "
                         f"n={n}, kl={kl}")
    kq = None
    if k_q is not None:
        kq = k_q.to(device=dev, dtype=torch.int32).contiguous()
        if kq.shape != (nq,):
            raise ValueError("sharded_merge: k_q must be [Q]")
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((nq, k), dtype=torch.int32, device=dev)
    s_ptrs = (ctypes.c_void_p * n)(*[s.data_ptr() for s in s_list])
    r_ptrs = (ctypes.c_void_p * n)(*[r.data_ptr() for r in r_list])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sharded_merge(
            s_ptrs, r_ptrs, int(r_dtype == torch.int64), n, nq, kl, k,
            int(local_n), None if kq is None else kq.data_ptr(),
            int(sentinel is not None),
            -1 if sentinel is None else int(sentinel), out_s.data_ptr(),
            out_r.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sharded_merge kernel launch failed: CUDA error {rc}")
    launches += 1
    return out_s, out_r


def sharded_merge(top_s: Sequence[torch.Tensor], top_i: Sequence[torch.Tensor],
                  local_n: int, k: int, k_q: Optional[torch.Tensor] = None,
                  sentinel: Optional[int] = None,
                  device: Optional[torch.device] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge shard ``p``'s ``[Q, kl]`` candidates ``(top_s[p] f32, top_i[p]
    local rows, i32 or i64)``, each in score-descending, lower-row-first
    order, into the global top ``k <= n * kl``: ``(scores [Q, k] f32, global
    rows [Q, k] i32)``, ties to the lower shard. Rows are ``local + p *
    local_n``; with ``sentinel``, entries scoring at or below ``NEG_INF / 2``
    become the sentinel row; with ``k_q [Q]``, the positions at or past
    ``k_q[q]`` become ``(NEG_INF, sentinel)`` (-1 without one). The merge
    runs on ``device`` (default: ``top_s[0]``'s): a CUDA device launches
    the kernel, the CPU runs the plain version."""
    dev = torch.device(device) if device is not None else top_s[0].device
    if dev.type == "cuda":
        return _launch(top_s, top_i, local_n, k, k_q, sentinel, dev)
    if dev.type == "cpu":
        return sharded_merge_reference([s.to(dev) for s in top_s], top_i,
                                       local_n, k, k_q, sentinel)
    raise ValueError(f"sharded_merge: unsupported device {dev}")
