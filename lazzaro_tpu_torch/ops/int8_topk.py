"""The int8 coarse scan of quantized serving (K4): a Hopper kernel and its
plain version.

K4 replaces no TPU kernel. The JAX package computes this scan in XLA, an
int8 ``dot_general`` with an int32 result and ``lax.top_k``, in two places,
and the kernel has one form for each:

- :func:`int8_topk` (additive form, one list):
  ``lazzaro_tpu/ops/quant.py:quantized_topk``, the classic int8 search;
- :func:`int8_topk_keyed` (keyed form, two lists): the coarse stage of
  ``lazzaro_tpu/core/state.py:_quant_two_tier``, the quantized fused serving
  program: a top-``g`` over the query tenant's live super rows and a
  top-``k`` over its live non-super rows.

The kernel is the int8 mode of the templated scan (``csrc/int8_topk.cu`` in
``csrc/topk_scan.cuh``; CUDA C++ for ``sm_90a``, built with ``nvcc`` on
first use and bound through ``ctypes``), so the ``[Q, N]`` int32 scores
never reach device memory; the header's note gives its design and its
bound (the shadow's bytes read once). Both forms quantize the f32 queries
on the card as ``ops.quant.quantize_rows`` does and score a pair
``(float(dot_i32) * qs[q]) * scale[r]``, so their lists are bit for bit
those of the plain versions here. Stage 1 has two routes, picked by the
shadow's width alone (:func:`route_for`): the tensor cores (``wgmma`` on
s8 fed by a TMA ring) where ``d % 16 == 0``, the ``__dp4a`` stage
otherwise; stage 2 selects each list's best keys across the splits
without k rounds. Lists of any length run in passes. A CUDA tensor
launches the kernel; only a CPU tensor runs the plain version.
``launches`` counts the kernel launches of both forms, ``launches_wgmma``
and ``launches_dp4a`` those of each route, ``launches_keyed`` those of the
keyed form and ``stage_launches`` the CUDA kernels as the C entry point
reports them (the quantization on the tensor-core route, then a stage 1
and a stage 2 a pass).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import chunked_map, nt_dot
from lazzaro_tpu_torch.ops.masked_topk import _sms
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.ops.topk import NEG_INF, additive_mask, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

# Widest row whose int32 dot cannot overflow (127 * 127 * d < 2^31), and
# the widest whose dot an f32 sum keeps exact (127 * 127 * d < 2^24).
MAX_D = 133_144
EXACT_F32_D = 1040
ROUTES = ("wgmma", "dp4a")

launches = 0
launches_wgmma = 0
launches_dp4a = 0
launches_keyed = 0
stage_launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("int8_topk")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int8_topk_plan.argtypes = [i64, i32, i32, i32, i32, i32, i32, ptr]
        lib.int8_topk_plan.restype = i32
        lib.int8_topk.argtypes = [ptr] * 8 + [i64] + [i32] * 10 + [ptr] * 10
        lib.int8_topk.restype = i32
        _lib = lib
    return _lib


def route_for(d: int) -> str:
    """Stage 1's route for a shadow of width ``d``: the tensor cores where
    its rows are a multiple of 16 bytes (TMA's row stride), else the
    ``__dp4a`` stage."""
    return "wgmma" if d % 16 == 0 else "dp4a"


def _scores(codes: torch.Tensor, scale: torch.Tensor, queries: torch.Tensor):
    """The plain scores of every query against every row: ``(float(dot) *
    qs) * scale``, the int32 dot exact and rounded to f32 once (XLA's
    convert of ``dot_general``'s int32 result): summed in f32 while every
    partial sum stays below 2^24 (d <= ``EXACT_F32_D``), in f64 past that
    (integers below 2^53); per chunk of queries by the caller."""
    qq, qs = quantize_rows(queries)
    dtype = torch.float32 if codes.shape[1] <= EXACT_F32_D else torch.float64
    rows = codes.to(dtype)

    def score(idx):
        dots = nt_dot(qq[idx], rows, dtype=dtype).float()
        return ((dots * qs[idx][:, None]) * scale[None, :],)

    return score


def int8_topk_reference(codes: torch.Tensor, scale: torch.Tensor,
                        mask: torch.Tensor, queries: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain additive form: the scores plus the additive mask (a bool mask
    gives ``jnp.where``'s ``NEG_INF``: a cosine plus -1e30 rounds to it),
    then :func:`stable_topk`, per chunk of queries. Returns ``(scores [Q, k]
    f32, rows [Q, k] i32)``."""
    madd = additive_mask(mask).to(codes.device)
    score = _scores(codes, scale, torch.atleast_2d(queries).float())

    def chunk(idx):
        s, r = stable_topk(score(idx)[0] + madd[None, :], k)
        return s, r.int()

    return chunked_map(chunk, torch.arange(torch.atleast_2d(queries).shape[0],
                                           device=codes.device))


def int8_topk_keyed_reference(codes: torch.Tensor, scale: torch.Tensor,
                              alive: torch.Tensor, tenant_id: torch.Tensor,
                              is_super: torch.Tensor, queries: torch.Tensor,
                              tenant: torch.Tensor, k: int, g: int):
    """Plain keyed form (the coarse stage of ``_quant_two_tier``): per query,
    ``stable_topk`` of the scores where ``alive & tenant_id == tenant[q] &
    is_super`` (top-``g``) and ``& ~is_super`` (top-``k``), other rows at
    ``NEG_INF``. Returns ``(gate_s [Q, g], gate_r, ann_s [Q, k], ann_r)``,
    rows i32."""
    score = _scores(codes, scale, queries.float())
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=codes.device)
    tenant = tenant.to(codes.device)

    def chunk(idx):
        s = score(idx)[0]
        alive_t = alive[None, :] & (tenant_id[None, :] == tenant[idx][:, None])
        gs, gr = stable_topk(torch.where(alive_t & is_super[None, :], s, neg), g)
        as_, ar = stable_topk(torch.where(alive_t & ~is_super[None, :], s, neg), k)
        return gs, gr.int(), as_, ar.int()

    return chunked_map(chunk, torch.arange(queries.shape[0], device=codes.device))


def _check(codes, scale, queries, k, g):
    if codes.dtype != torch.int8 or codes.ndim != 2 or not codes.is_contiguous():
        raise TypeError("int8_topk needs contiguous [N, d] int8 codes")
    n, d = codes.shape
    if d > MAX_D:
        raise ValueError(f"int8_topk: d={d} is past {MAX_D}, where an int32 "
                         f"dot of int8 codes can overflow")
    if codes.data_ptr() % 16:
        raise ValueError("int8_topk needs 16-byte aligned codes (a slice of a "
                         "shadow that starts mid-row is not taken)")
    if scale.dtype != torch.float32 or scale.shape != (n,) \
            or scale.device != codes.device:
        raise ValueError("int8_topk: scale must be [N] f32 on the codes' device")
    if not 1 <= k <= n or not 0 <= g <= n:
        raise ValueError(f"int8_topk keeps lists of 1 to N rows; k={k}, g={g}, "
                         f"N={n}")
    q = queries.to(device=codes.device, dtype=torch.float32).contiguous()
    if q.ndim != 2 or q.shape[1] != d or q.shape[0] < 1:
        raise ValueError("int8_topk: queries must be [Q, d]")
    return q


def _launch(codes, scale, queries, k, g=0, madd=None, cols=None, tenant=None,
            route=None):
    """One scan on the card: the additive form with ``madd``, the keyed form
    with ``cols = (alive, tenant_id, is_super)`` and ``tenant``. ``route``
    forces stage 1's route (a record and a test of the other route; the
    card refuses the tensor cores where ``d % 16 != 0``)."""
    global launches, launches_wgmma, launches_dp4a, launches_keyed, stage_launches
    q = _check(codes, scale, queries, k, g)
    n, d = codes.shape
    nq = q.shape[0]
    dev = codes.device
    keyed = cols is not None
    ten = None
    if keyed:
        alive, tenant_id, is_super = cols
        if any(c.shape != (n,) or c.device != dev or not c.is_contiguous()
               for c in cols):
            raise ValueError("int8_topk: alive, tenant_id and is_super must be "
                             "contiguous [N] columns on the codes' device")
        if alive.dtype != torch.bool or is_super.dtype != torch.bool \
                or tenant_id.dtype != torch.int32:
            raise TypeError("int8_topk: alive/is_super bool, tenant_id int32")
        if g < 1:
            raise ValueError("int8_topk_keyed needs a gate list (g >= 1)")
        ten = tenant.to(device=dev, dtype=torch.int32).contiguous()
        if ten.shape != (nq,):
            raise ValueError("int8_topk: tenant must be [Q]")
    else:
        madd = madd.to(device=dev, dtype=torch.float32).contiguous()
        if madd.shape != (n,):
            raise ValueError("int8_topk: mask must be [N]")
    if route is not None and route not in ROUTES:
        raise ValueError(f"int8_topk: route must be one of {ROUTES}")
    lib = _library()
    plan = (ctypes.c_int * 6)()
    if lib.int8_topk_plan(n, nq, k, g, d, _sms(dev),
                          -1 if route is None else ROUTES.index(route), plan):
        raise ValueError(
            f"int8_topk: the card takes no such scan (d={d}, route {route}): "
            "the tensor cores need d % 16 == 0, and the dp4a stage holds its "
            "queries in shared memory (d up to ~50,000)")
    rc_route, splits, kc, gc, qt, rep = plan
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    qq = qsc = None
    if rc_route == 0:
        qq = torch.empty((-(-nq // qt) * 64, d), dtype=torch.int8, device=dev)
        qsc = torch.empty((nq,), dtype=f32, device=dev)
    cand = torch.empty((splits, nq, kc), dtype=i64, device=dev)
    out_s = torch.empty((nq, k), dtype=f32, device=dev)
    out_r = torch.empty((nq, k), dtype=i32, device=dev)
    gcand = gout_s = gout_r = None
    if keyed:
        gcand = torch.empty((splits, nq, gc), dtype=i64, device=dev)
        gout_s = torch.empty((nq, g), dtype=f32, device=dev)
        gout_r = torch.empty((nq, g), dtype=i32, device=dev)

    def p(t):
        return None if t is None else t.data_ptr()

    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        alive, tenant_id, is_super = cols or (None, None, None)
        rc = lib.int8_topk(
            p(codes), p(scale), p(madd), p(tenant_id), p(alive), p(is_super),
            p(q), p(ten), n, d, nq, k, g, rc_route, splits, kc, gc, qt, rep, p(qq),
            p(qsc), p(cand), p(gcand), p(out_s), p(out_r), p(gout_s),
            p(gout_r), ctypes.byref(launched), stream)
    stage_launches += launched.value
    if rc != 0:
        raise RuntimeError(f"int8_topk kernel launch failed: CUDA error {rc}")
    launches += 1
    if rc_route == 0:
        launches_wgmma += 1
    else:
        launches_dp4a += 1
    launches_keyed += keyed
    if keyed:
        return gout_s, gout_r, out_s, out_r
    return out_s, out_r


def int8_topk(codes: torch.Tensor, scale: torch.Tensor, mask: torch.Tensor,
              queries: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k over the int8 shadow (``quantized_topk``): ``codes
    [N, d]`` i8 and ``scale [N]`` f32 from ``quantize_rows`` of the arena,
    ``mask [N]`` a bool alive mask or an additive f32 one, ``queries [Q,
    d]`` f32 (quantized per row here too). Returns ``(scores [Q, k] f32,
    rows [Q, k] i32)``, score-descending, ties to the lower row. A CUDA
    shadow launches K4; a CPU shadow runs the plain version."""
    if codes.device.type == "cuda":
        return _launch(codes, scale, torch.atleast_2d(queries), k,
                       madd=additive_mask(mask))
    if codes.device.type == "cpu":
        return int8_topk_reference(codes, scale, mask, queries, k)
    raise ValueError(f"int8_topk: unsupported device {codes.device}")


def int8_topk_keyed(codes: torch.Tensor, scale: torch.Tensor,
                    alive: torch.Tensor, tenant_id: torch.Tensor,
                    is_super: torch.Tensor, queries: torch.Tensor,
                    tenant: torch.Tensor, k: int, g: int):
    """The coarse stage of quantized fused serving: per query of ``queries
    [Q, d]`` (f32) and its ``tenant [Q]``, the top-``g`` over the tenant's
    live super rows and the top-``k`` over its live non-super rows, other
    rows scoring ``NEG_INF``. Returns ``(gate_s [Q, g], gate_r [Q, g], ann_s
    [Q, k], ann_r [Q, k])``, rows i32. A CUDA shadow launches K4; a CPU
    shadow runs the plain version."""
    if codes.device.type == "cuda":
        return _launch(codes, scale, queries, k, g,
                       cols=(alive, tenant_id, is_super), tenant=tenant)
    if codes.device.type == "cpu":
        return int8_topk_keyed_reference(codes, scale, alive, tenant_id,
                                         is_super, queries, tenant, k, g)
    raise ValueError(f"int8_topk_keyed: unsupported device {codes.device}")
