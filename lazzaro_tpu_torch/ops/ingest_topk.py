"""The whole-arena ingest scan: a Hopper kernel and its plain version.

The counterpart of the scan in ``lazzaro_tpu/core/state.py:_ingest_scan_core``
(and of ``_arena_link_candidates_multi``), which the JAX package computes
with ``nt_dot`` + ``lax.top_k`` in XLA. For each new fact it takes, from one
score matrix over the arena, a dedup-probe top-1 over the tenant's live
non-super rows (less ``probe_excl``) and, per shard mode, a link top-k over
those rows less ``link_excl`` (mode 1 the fact's shard, -1 the others, 0
any). Masked pairs score exactly ``NEG_INF`` and ties go to the lowest row.

The kernel is the ingest mode of the templated scan in
``csrc/topk_scan.cuh`` (exported by ``csrc/ingest_topk.cu``, CUDA C++ for
``sm_90a``, built with ``nvcc`` on first use and bound through ``ctypes``):
one pass over the arena feeds the probe and every mode from one score tile,
so the ``[B, N]`` f32 scores never reach device memory. Its stage 1 takes
one of three routes (:func:`route_for`): the tensor cores for a bf16 arena;
for an f32 one the streaming stage where ``masked_topk`` streams the same
batch (up to 16 facts whose values fit a lane's registers,
``ops.masked_topk.stream_fits``), else the FMA stage. On each route the
probe sums a row as ``masked_topk``'s scan on that route does, so the fused
ingest's probe and the classic ingest's (``masked_topk`` at k = 1) score
every pair bit for bit alike and reach the same verdict at the 0.95 gate.
:func:`ingest_topk` launches the kernel for a CUDA arena and runs
:func:`ingest_topk_reference` only for a CPU arena. ``launches`` counts the
launches of this kernel made through :func:`ingest_topk`,
``launches_wgmma`` and ``launches_stream`` those on the tensor-core and the
streaming route.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import QUERY_CHUNK, chunked_map, nt_dot
from lazzaro_tpu_torch.ops import masked_topk as mt
from lazzaro_tpu_torch.ops.masked_topk import ROUTES, _sms, check_arena
from lazzaro_tpu_torch.ops.topk import NEG_INF, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

MAX_K = 128          # longest list the kernel keeps
MAX_MODES = 2        # shard modes one launch takes

launches = 0
launches_wgmma = 0
launches_stream = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("ingest_topk")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ingest_topk_splits.argtypes = [i64, i32, i32, i32, i32, i32, i32]
        lib.ingest_topk_splits.restype = i32
        lib.ingest_topk.argtypes = [
            ptr, i32, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.ingest_topk.restype = i32
        _lib = lib
    return _lib


def route_for(dtype: torch.dtype, nq: int, d: int) -> str:
    """The stage-1 route of an ingest scan of ``nq`` facts of width ``d``:
    the tensor cores for a bf16 arena; for an f32 one ``"stream"`` where
    ``masked_topk.route_for`` streams the same batch, else the FMA stage.
    Like that rule it depends on the shape only, never on N."""
    if dtype == torch.bfloat16:
        return "wgmma"
    return "stream" if mt.route_for(dtype, nq, d) == "stream" else "fma"


def check_route(route: str, dtype: torch.dtype, nq: int, d: int) -> None:
    """Raises where a forced ``route`` cannot take the scan: the tensor
    cores and the FMA stage are left to the card to refuse (by dtype), the
    streaming stage takes only what :func:`route_for` streams."""
    if route not in ROUTES:
        raise ValueError(f"ingest_topk: no route {route!r}; routes {sorted(ROUTES)}")
    if route == "stream" and route_for(dtype, nq, d) != "stream":
        raise ValueError(
            f"ingest_topk: the streaming route takes an f32 arena of up to "
            f"{mt.STREAM_MAX_Q} facts whose values fit a lane's registers "
            f"(ops.masked_topk.stream_fits), not {dtype} with Q={nq}, d={d}")


def masks(alive, tenant_id, is_super, probe_excl, link_excl, tenant):
    """``(probe mask, link mask)`` over the arena rows: the tenant's live
    non-super rows less ``probe_excl``, and that less ``link_excl``."""
    pmask = alive & (tenant_id == tenant) & ~is_super & ~probe_excl
    return pmask, pmask & ~link_excl


def ingest_topk_reference(emb: torch.Tensor, alive: torch.Tensor,
                          tenant_id: torch.Tensor, is_super: torch.Tensor,
                          shard_id: torch.Tensor, probe_excl: torch.Tensor,
                          link_excl: torch.Tensor, qd: torch.Tensor,
                          q_shard: torch.Tensor, tenant: int, k: int,
                          shard_modes: Sequence[int], with_probe: bool = True
                          ) -> Tuple[torch.Tensor, ...]:
    """Plain version, ``_ingest_scan_core`` step for step: ``nt_dot``
    scores of ``QUERY_CHUNK`` queries at a time, ``torch.where`` masks and
    :func:`ops.topk.stable_topk`. Returns the flat tuple ``(p_s [B, 1],
    p_r [B, 1], s_mode [B, k], r_mode [B, k], ...)`` (rows i32; the probe
    pair only ``with_probe``)."""
    pmask, lmask = masks(alive, tenant_id, is_super, probe_excl, link_excl,
                         tenant)

    def body(idx):
        scores = nt_dot(qd[idx], emb)
        outs = []
        if with_probe:
            s, r = stable_topk(torch.where(pmask[None, :], scores, NEG_INF), 1)
            outs.extend((s, r.int()))
        same = None
        for sm in shard_modes:
            m = lmask[None, :]
            if sm != 0:
                if same is None:
                    same = q_shard[idx][:, None] == shard_id[None, :]
                m = m & (same if sm == 1 else ~same)
            s, r = stable_topk(torch.where(m, scores, NEG_INF), k)
            outs.extend((s, r.int()))
        return tuple(outs)

    return chunked_map(body, torch.arange(qd.shape[0], device=qd.device),
                       QUERY_CHUNK)


def _launch(emb, alive, tenant_id, is_super, shard_id, probe_excl, link_excl,
            qd, q_shard, tenant, k, shard_modes, with_probe, route=None):
    """One scan on the card: a stage 1 and a stage 2 a mode. ``route``
    forces a stage 1 (:func:`check_route`); the card refuses the tensor
    cores for an f32 arena and the FMA route for a bf16 one, and the
    wrapper raises."""
    global launches, launches_wgmma, launches_stream
    check_arena(emb, "ingest_topk")
    n, d = emb.shape
    modes = tuple(int(m) for m in shard_modes)
    if len(modes) > MAX_MODES or any(m not in (-1, 0, 1) for m in modes):
        raise ValueError(f"ingest_topk takes up to {MAX_MODES} shard modes "
                         f"from (1, 0, -1), not {modes}")
    if not modes and not with_probe:
        raise ValueError("ingest_topk: nothing to scan (no mode, no probe)")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"ingest_topk needs 1 <= k <= min({MAX_K}, N); "
                         f"k={k}, N={n}")
    nq = qd.shape[0] if qd.ndim == 2 else 0
    if qd.ndim != 2 or qd.shape[1] != d or nq < 1:
        raise ValueError("ingest_topk: queries must be [B, d] with B >= 1")
    route = route or route_for(emb.dtype, nq, d)
    check_route(route, emb.dtype, nq, d)
    dev = emb.device
    q = qd.to(device=dev, dtype=emb.dtype).contiguous()
    pmask, lmask = masks(alive, tenant_id, is_super, probe_excl, link_excl,
                         tenant)
    flags = (pmask.to(torch.uint8) | (lmask.to(torch.uint8) << 1)).contiguous()
    shard = shard_id.to(device=dev, dtype=torch.int32).contiguous()
    qs = q_shard.to(device=dev, dtype=torch.int32).contiguous()
    if flags.shape != (n,) or shard.shape != (n,) or qs.shape != (nq,):
        raise ValueError("ingest_topk: row columns must be [N], q_shard [B]")
    lib = _library()
    nm = len(modes)
    splits = lib.ingest_topk_splits(n, nq, d, k, nm, ROUTES[route], _sms(dev))
    f32, i32 = torch.float32, torch.int32
    probe_cs = torch.empty((splits, nq), dtype=f32, device=dev)
    probe_cr = torch.empty((splits, nq), dtype=i32, device=dev)
    cand_s = torch.empty((max(nm, 1), splits, nq, k), dtype=f32, device=dev)
    cand_r = torch.empty((max(nm, 1), splits, nq, k), dtype=i32, device=dev)
    probe_s = torch.empty((nq,), dtype=f32, device=dev)
    probe_r = torch.empty((nq,), dtype=i32, device=dev)
    out_s = torch.empty((max(nm, 1), nq, k), dtype=f32, device=dev)
    out_r = torch.empty((max(nm, 1), nq, k), dtype=i32, device=dev)
    mode = list(modes) + [0] * (MAX_MODES - nm)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ingest_topk(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16), flags.data_ptr(),
            shard.data_ptr(), q.data_ptr(), qs.data_ptr(), n, d, nq, k, nm,
            mode[0], mode[1], int(bool(with_probe)), ROUTES[route], splits,
            probe_cs.data_ptr(), probe_cr.data_ptr(), cand_s.data_ptr(),
            cand_r.data_ptr(), probe_s.data_ptr(), probe_r.data_ptr(),
            out_s.data_ptr(), out_r.data_ptr(), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"ingest_topk kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches += 1
    launches_wgmma += route == "wgmma"
    launches_stream += route == "stream"
    outs = []
    if with_probe:
        outs.extend((probe_s[:, None], probe_r[:, None]))
    for m in range(nm):
        outs.extend((out_s[m], out_r[m]))
    return tuple(outs)


def ingest_topk(emb: torch.Tensor, alive: torch.Tensor, tenant_id: torch.Tensor,
                is_super: torch.Tensor, shard_id: torch.Tensor,
                probe_excl: torch.Tensor, link_excl: torch.Tensor,
                qd: torch.Tensor, q_shard: torch.Tensor, tenant: int, k: int,
                shard_modes: Sequence[int] = (1, 0), with_probe: bool = True
                ) -> Tuple[torch.Tensor, ...]:
    """The ingest scan of ``qd [B, d]`` (arena dtype; ``q_shard [B]`` their
    shard ids) over the arena ``emb [N, d]`` with its columns ``alive``,
    ``tenant_id``, ``is_super``, ``shard_id`` and the row masks
    ``probe_excl``, ``link_excl`` (``[N]`` bool), for one ``tenant`` (a host
    int). Returns the flat tuple of :func:`ingest_topk_reference`. A CUDA
    arena launches the kernel (``k`` <= 128, up to two modes); a CPU arena
    runs the plain version."""
    if emb.device.type == "cuda":
        return _launch(emb, alive, tenant_id, is_super, shard_id, probe_excl,
                       link_excl, qd, q_shard, tenant, k, shard_modes,
                       with_probe)
    if emb.device.type == "cpu":
        return ingest_topk_reference(emb, alive, tenant_id, is_super, shard_id,
                                     probe_excl, link_excl, qd, q_shard, tenant,
                                     k, shard_modes, with_probe)
    raise ValueError(f"ingest_topk: unsupported device {emb.device}")
