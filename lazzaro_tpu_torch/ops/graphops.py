"""Graph passes over the edge arena and the all-pairs merge scan.

Counterpart of ``lazzaro_tpu/ops/graphops.py``. ``connected_components``
(label propagation with pointer jumping, looped until no label changes) and
``component_stats`` (three scatter-adds) are small passes that only
``MemoryIndex.components`` calls, so they are plain torch on the edge
arena's device.

``pairwise_merge_candidates`` is the all-pairs merge scan of
``run_consolidation``, which the JAX package computes in XLA (chunked
``nt_dot`` + ``where`` + ``lax.top_k``). For every row ``i`` of ``mask`` it
returns the ``k`` best rows ``j > i`` of ``mask`` whose cosine beats
``threshold``, score descending, ties to the lowest ``j``, and ``-1`` in the
other slots. Its kernel is the pairwise mode of the templated scan in
``csrc/topk_scan.cuh`` (exported by ``csrc/pairwise_topk.cu``, CUDA C++ for
``sm_90a``, built with ``nvcc`` on first use and bound through ``ctypes``):
the mask's rows are gathered in ascending order on the device (no host
wait), the kernel scores only the tiles above the diagonal of that copy and
keeps each row's list in device memory, and a decode maps the lists back to
arena rows. A bf16 arena takes the tensor-core stage 1, an f32 one the FMA
stage 1 (:func:`route_for`). :func:`pairwise_merge_candidates` launches it
for a CUDA arena and runs :func:`pairwise_merge_candidates_reference` only
for a CPU arena. ``launches`` counts the launches made through it,
``launches_wgmma`` those on the tensor-core route.

One difference from the JAX function, which no caller reads
(``MemoryIndex.merge_candidates`` decodes only slots with ``j >= 0``): a
slot whose ``j`` is ``-1`` holds ``NEG_INF`` here, where JAX keeps the
below-threshold score it ranked there (or ``-inf``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import QUERY_CHUNK, chunked_map, nt_dot
from lazzaro_tpu_torch.ops.masked_topk import ROUTES, check_arena
from lazzaro_tpu_torch.ops.topk import NEG_INF, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

MAX_K = 8            # longest list the kernel keeps (kPairMaxK)

launches = 0
launches_wgmma = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("pairwise_topk")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pairwise_topk.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i64, i32, ctypes.c_float, i32, i32,
            ptr, ptr, ptr, ptr, ptr]
        lib.pairwise_topk.restype = i32
        _lib = lib
    return _lib


def route_for(dtype: torch.dtype) -> str:
    """The stage-1 route of a pairwise scan: the tensor cores for a bf16
    arena, the FMA stage for an f32 one."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def pairwise_merge_candidates_reference(emb: torch.Tensor, mask: torch.Tensor,
                                        threshold: float, k: int = 4,
                                        chunk: int = QUERY_CHUNK
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the JAX function step for step: ``nt_dot`` scores of
    ``chunk`` rows against the arena, ``j > i`` and both rows in ``mask``
    (else ``-inf``), :func:`ops.topk.stable_topk`, and ``j = -1`` where the
    score does not beat ``threshold`` (compared in f32); such a slot's
    score is ``NEG_INF``. Returns ``(scores [N, k] f32, rows [N, k] i32)``."""
    n = emb.shape[0]
    dev = emb.device
    col = torch.arange(n, device=dev)
    m = mask.to(device=dev, dtype=torch.bool)
    thr = torch.tensor(threshold, dtype=torch.float32)
    kk = min(k, n)                 # an arena of fewer than k rows: the rest empty

    def one_chunk(rows):
        scores = nt_dot(emb[rows], emb)
        valid = m[rows][:, None] & m[None, :] & (col[None, :] > rows[:, None])
        ts, tj = stable_topk(torch.where(valid, scores, float("-inf")), kk)
        hit = ts > thr
        s = torch.full((rows.shape[0], k), NEG_INF, dtype=torch.float32, device=dev)
        j = torch.full((rows.shape[0], k), -1, dtype=torch.int32, device=dev)
        s[:, :kk] = torch.where(hit, ts, NEG_INF)
        j[:, :kk] = torch.where(hit, tj.int(), -1)
        return s, j

    return chunked_map(one_chunk, col, chunk)


def _launch(emb, mask, threshold, k, route=None):
    """One pairwise scan on the card: the device-side gather of the mask's
    rows, then the kernel (zeroed lists, stage 1, decode). ``route`` forces
    a stage 1; the card refuses the tensor cores for an f32 arena and the
    FMA route for a bf16 one, and the wrapper raises."""
    global launches, launches_wgmma
    check_arena(emb, "pairwise_topk")
    n, d = emb.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pairwise_topk needs 1 <= k <= {MAX_K}, not {k}")
    dev = emb.device
    m = mask.to(device=dev, dtype=torch.bool)
    if m.shape != (n,):
        raise ValueError("pairwise_topk: mask must be [N]")
    # The mask's rows in ascending order: pos[r] is row r's place, comp[p]
    # the row at place p; the live count stays on the device.
    pos = torch.cumsum(m, 0, dtype=torch.int32) - 1
    n_live = (pos[-1:] + 1).contiguous()
    comp = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    comp.index_put_((torch.where(m, pos, n).long(),),
                    torch.arange(n, dtype=torch.int32, device=dev))
    comp = comp[:n].contiguous()
    emb_c = emb.index_select(0, comp.long()).contiguous()
    flags = m.to(torch.uint8).contiguous()
    keys = torch.empty((n, k), dtype=torch.int64, device=dev)
    out_s = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((n, k), dtype=torch.int32, device=dev)
    route = route or route_for(emb.dtype)
    lib = _library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairwise_topk(
            emb_c.data_ptr(), int(emb.dtype == torch.bfloat16), n_live.data_ptr(),
            flags.data_ptr(), pos.data_ptr(), comp.data_ptr(), n, d,
            float(threshold), k, ROUTES[route], keys.data_ptr(),
            out_s.data_ptr(), out_r.data_ptr(), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"pairwise_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    return out_s, out_r


def pairwise_merge_candidates(emb: torch.Tensor, mask: torch.Tensor,
                              threshold: float, k: int = 4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row's ``k`` best later rows above ``threshold`` over the arena
    ``emb [N, d]`` (L2-normalized rows) and the bool ``mask [N]``: ``(scores
    [N, k] f32, rows [N, k] i32)``, ``(NEG_INF, -1)`` past a row's hits. A
    CUDA arena launches the kernel (``k`` <= 8); a CPU arena runs the plain
    version."""
    if emb.device.type == "cuda":
        return _launch(emb, mask, threshold, k)
    if emb.device.type == "cpu":
        return pairwise_merge_candidates_reference(emb, mask, threshold, k)
    raise ValueError(f"pairwise_topk: unsupported device {emb.device}")


def connected_components(src: torch.Tensor, tgt: torch.Tensor,
                         edge_alive: torch.Tensor, node_alive: torch.Tensor,
                         num_nodes: int, min_weight: float = 0.0,
                         weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Label propagation: every alive node ends with the minimum row of its
    component as its label, dead nodes with -1. Edges ``[E]`` i32 (dead ones
    may hold -1), ``node_alive [num_nodes]`` bool; an edge counts when it is
    alive and its ``weight`` (default 1) is at least ``min_weight``."""
    if weight is None:
        weight = torch.ones_like(edge_alive, dtype=torch.float32)
    live_e = edge_alive & (weight >= min_weight)
    s = torch.where(live_e, src, 0).long()
    t = torch.where(live_e, tgt, 0).long()
    big = int(num_nodes)
    labels = torch.where(node_alive,
                         torch.arange(num_nodes, dtype=torch.int32,
                                      device=node_alive.device), big)
    while True:
        m_s = torch.where(live_e, torch.minimum(labels[s], labels[t]), big)
        new = labels.scatter_reduce(0, s, m_s, "amin")
        new = new.scatter_reduce(0, t, m_s, "amin")
        # pointer jumping: label <- label[label] speeds up convergence
        new = torch.minimum(new, new[new.clamp(0, num_nodes - 1).long()])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(node_alive, labels, -1)


def component_stats(labels: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                    edge_alive: torch.Tensor, weight: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per component (keyed by its label, the root row): node count, edge
    count and summed edge weight, ``[n]`` each."""
    n = labels.shape[0]
    dev = labels.device
    node_counts = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, labels.clamp(min=0).long(), (labels >= 0).int())
    edge_lbl = torch.where(edge_alive, labels[src.clamp(min=0).long()], 0)
    at = edge_lbl.clamp(min=0).long()
    edge_counts = torch.zeros((n,), dtype=torch.int32, device=dev).index_add_(
        0, at, edge_alive.int())
    weight_sums = torch.zeros((n,), dtype=torch.float32, device=dev).index_add_(
        0, at, torch.where(edge_alive, weight, 0.0))
    return node_counts, edge_counts, weight_sums
