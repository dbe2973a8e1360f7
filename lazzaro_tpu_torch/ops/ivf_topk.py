"""The IVF candidate scan (K5): a Hopper kernel and its plain version.

K5 replaces no TPU kernel. The JAX package computes this scan in XLA: the
candidate rows of each query (the member slots of its ``nprobe`` nearest
clusters, in rank order, then the exact-scan extras) are gathered into a
``[Q, L, d]`` tensor, scored by an einsum and cut by ``lax.top_k``, in
``lazzaro_tpu/core/state.py:_ivf_two_tier`` (the fused IVF serving
programs) and ``lazzaro_tpu/ops/ivf.py:ivf_search`` (the classic IVF
search; ``ops.ivf.ivf_search`` here). Its three forms:

- ``exact`` (keyed, two lists): the top-``k`` valid non-super candidates
  and the top-``g`` valid super candidates of the query's tenant, scored
  exactly (the query cast to the arena dtype, f32 sums);
- ``int8`` (keyed, two lists): the same lists over the int8 shadow, scored
  ``(float(dot_i32) * qs) * scale`` as K4 scores (``ops.int8_topk``): the
  coarse stage of the int8 composition, whose survivors the caller
  rescores exactly;
- ``classic`` (one list): the top-``k`` candidates of an ``[N]`` mask, the
  f32 query scored against the arena rows widened to f32.

A candidate is valid when its slot holds a row (not -1), the row passes
the tenant mask and, for a member slot in the keyed forms, its cluster's
rank is below the query's ``nprobe_q``. A position outside a list's tier
scores exactly ``NEG_INF``; order is score descending, ties to the lower
candidate POSITION (``lax.top_k`` over the ``[Q, L]`` tile), so a list
with fewer valid candidates than its length fills with the lowest other
positions, carrying whatever the candidate slot holds (-1 padding or
another tenant's row). Every form returns the positions and the rows.

Occupancy: ``occ [C]`` (i32) and ``n_extras`` say where the tables' rows
end: every member slot at or past ``occ[c]`` and every extra at or past
``n_extras`` holds -1 (:func:`check_occupancy`). The callers pass the live
tables' append cursor or the build's ``online_counts`` and the extras'
packed length; without them the whole table is walked. The result does
not depend on them.

The kernel (``csrc/ivf_topk.cu``; CUDA C++ for ``sm_90a``, built with
``nvcc`` on first use and bound through ``ctypes``) walks only the occupied
slots of each query's probed clusters and the occupied extras: stage 1, a
block of 8 warps per (split of those positions, query), reads the member
table through the query's cluster ids, loads a row only for a valid slot
into a ``cp.async`` ring and keeps its split's lists; stage 2 merges each
list across the splits, adds the fill positions and writes scores,
positions and rows (2 launches a pass). No ``[Q, L]`` or ``[Q, L, d]``
tensor is written. A CUDA tensor launches the kernel; only a CPU tensor
runs :func:`ivf_topk_reference`. ``launches`` counts the kernel's
launches (``launches_int8`` and ``launches_classic`` those of two forms),
``stage_launches`` the CUDA kernels as the C entry point reports them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import chunked_map
from lazzaro_tpu_torch.ops.masked_topk import _sms, check_arena
from lazzaro_tpu_torch.ops.quant import quantize_rows
from lazzaro_tpu_torch.ops.topk import NEG_INF, stable_topk
from lazzaro_tpu_torch.utils import cuda_build

# Queries the plain version scores at once: the [chunk, L, d] gather of
# lazzaro_tpu/core/state.py:IVF_SERVE_CHUNK.
IVF_SERVE_CHUNK = 8
# Lanes of a warp and the elements of a lane's chunk in the kernel's sums.
WARP = 32
CHUNK = 8
# List entries one pass of the kernel keeps (kI8MaxK); longer lists run in
# passes.
PASS_K = 256
FORMS = {"exact": 0, "int8": 1, "classic": 2}

launches = 0
launches_int8 = 0
launches_classic = 0
stage_launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("ivf_topk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ivf_topk_plan.argtypes = [ctypes.c_longlong, i32, i32, i32]
        lib.ivf_topk_plan.restype = i32
        lib.ivf_topk.argtypes = ([i32, ptr, i32] + [ptr] * 14 + [i32] * 12
                                 + [ptr] * 12)
        lib.ivf_topk.restype = i32
        _lib = lib
    return _lib


def route_for(form: str) -> str:
    """The stage 1 a form runs on: f32 sums on the CUDA cores for the exact
    and classic forms (named ``fma`` as the other scans' CUDA-core stage;
    here each product rounds before it is added, see :func:`lane_dot`),
    ``__dp4a`` for the int8 form."""
    return "dp4a" if form == "int8" else "fma"


def form_of(rows, cols, mask) -> str:
    """``exact`` (a tensor and the keyed columns), ``int8`` (codes and
    scales and the keyed columns) or ``classic`` (a tensor and a mask)."""
    if (cols is None) == (mask is None):
        raise ValueError("ivf_topk takes the keyed columns or a mask, not both")
    if isinstance(rows, (tuple, list)):
        if cols is None:
            raise ValueError("ivf_topk: the int8 form is keyed")
        return "int8"
    return "exact" if cols is not None else "classic"


def ivf_candidates(members: torch.Tensor, extras: torch.Tensor,
                   cids: torch.Tensor) -> torch.Tensor:
    """The ``[Q, L]`` candidate rows of ``lazzaro_tpu/ops/ivf.py:gather_rows``:
    the member slots of each query's clusters ``cids [Q, P]`` in rank
    order, then the extras (plain; the kernel never writes it)."""
    nq = cids.shape[0]
    cand = members[cids.long()].reshape(nq, -1)
    return torch.cat([cand, extras[None, :].expand(nq, extras.shape[0])], dim=1)


def lane_dot(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``(x * q).sum(-1)`` in f32, summed in the kernel's order
    (``csrc/ivf_topk.cu:gv_stage1``), so that the two agree to the bit on
    any data: lane ``l`` of a warp adds the products of its 8-element chunks
    ``l, l + 32, ...`` one after another in column order, each product
    rounded to f32 before it is added; then a butterfly halves the 32 lane
    sums five times. ``x`` and ``q`` broadcast; ``d % 8 == 0``."""
    p = (x.float() * q.float()).unflatten(-1, (-1, CHUNK))   # [..., d / 8, 8]
    acc = torch.zeros(p.shape[:-2] + (WARP,), dtype=torch.float32,
                      device=p.device)
    for j in range(0, p.shape[-2], WARP):
        block = p[..., j:j + WARP, :]
        lanes = acc[..., :block.shape[-2]]
        for i in range(CHUNK):
            lanes += block[..., i]
    w = WARP
    while w > 1:
        w //= 2
        acc = acc[..., :w] + acc[..., w:2 * w]
    return acc[..., 0]


def check_occupancy(members: torch.Tensor, extras: torch.Tensor, occ=None,
                    n_extras=None) -> None:
    """Raise ``ValueError`` unless every member slot at or past its
    cluster's ``occ`` and every extra at or past ``n_extras`` holds -1 (the
    contract of :func:`ivf_topk`'s occupancy; None checks nothing)."""
    if occ is not None:
        if tuple(occ.shape) != (members.shape[0],):
            raise ValueError("ivf_topk: occ must be [C]")
        slot = torch.arange(members.shape[1], device=members.device)
        past = slot[None, :] >= occ.to(members.device).long()[:, None]
        if bool((past & (members >= 0)).any()):
            raise ValueError("ivf_topk: a member slot at or past its cluster's "
                             "occupancy holds a row")
    if n_extras is not None:
        if not 0 <= n_extras <= extras.shape[0]:
            raise ValueError("ivf_topk: n_extras must be in [0, E]")
        if bool((extras[n_extras:] >= 0).any()):
            raise ValueError("ivf_topk: an extra at or past n_extras holds a row")


def ivf_topk_reference(rows, members: torch.Tensor, extras: torch.Tensor,
                       cids: torch.Tensor, queries: torch.Tensor, k: int, *,
                       g: int = 0, cols=None, q_tenant=None, mask=None,
                       nprobe_q=None, occ=None, n_extras=None):
    """Plain version of :func:`ivf_topk`, ``IVF_SERVE_CHUNK`` queries at a
    time: the candidates gathered, scored (f32 sums in the kernel's order,
    :func:`lane_dot`; the int8 form's int32 dot exact), masked per list and
    cut by :func:`stable_topk`. It reads every slot; ``occ`` and
    ``n_extras`` are only checked (:func:`check_occupancy`)."""
    form = form_of(rows, cols, mask)
    check_occupancy(members, extras, occ, n_extras)
    nq = cids.shape[0]
    m_w = members.shape[1]
    pm = cids.shape[1] * m_w
    if form == "int8":
        codes, scale = rows
        qq, qs = quantize_rows(queries.float())
    else:
        qf = queries.float()

    def chunk(idx):
        cand = ivf_candidates(members, extras, cids[idx])
        safe = torch.clamp(cand, min=0).long()
        if form == "classic":
            valid = (cand >= 0) & mask[safe]
        else:
            alive, tenant_id, is_super = cols
            valid = ((cand >= 0) & alive[safe]
                     & (tenant_id[safe] == q_tenant[idx][:, None]))
            if nprobe_q is not None:
                pos = torch.arange(cand.shape[1], device=cand.device)
                rank = pos // max(m_w, 1)
                valid = valid & ((pos >= pm)[None, :]
                                 | (rank[None, :] < nprobe_q[idx][:, None]))
        if form == "int8":
            d8 = (qq[idx][:, None, :].int() * codes[safe].int()).sum(-1)
            sc = (d8.float() * qs[idx][:, None]) * scale[safe]
        else:
            sc = lane_dot(rows[safe], qf[idx][:, None, :])
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=sc.device)
        if form == "classic":
            lists = [(torch.where(valid, sc, neg), k)]
        else:
            sup = is_super[safe]
            lists = [(torch.where(valid & ~sup, sc, neg), k),
                     (torch.where(valid & sup, sc, neg), g)]
        out = []
        for masked, kk in lists:
            s, p = stable_topk(masked, kk)
            out += [s, p.int(), torch.gather(cand, 1, p)]
        return tuple(out)

    res = chunked_map(chunk, torch.arange(nq, device=cids.device),
                      chunk=IVF_SERVE_CHUNK)
    return tuple(res) if form != "classic" else tuple(res) + (None,) * 3


def _launch(form, rows, members, extras, cids, queries, k, g, cols, q_tenant,
            mask, nprobe_q, occ, n_extras):
    global launches, launches_int8, launches_classic, stage_launches
    dev = members.device
    if form == "int8":
        codes, scale = rows
        if codes.dtype != torch.int8 or codes.ndim != 2 or not codes.is_contiguous():
            raise ValueError("ivf_topk: the int8 form needs contiguous [N, d] i8 codes")
        if codes.shape[1] % 4 or codes.data_ptr() % 16:
            raise ValueError("ivf_topk: the int8 form needs d % 4 == 0 and "
                             "16-byte aligned codes")
        n, d = codes.shape
        scale = scale.to(device=dev, dtype=torch.float32).contiguous()
        qq, qs = quantize_rows(queries.to(dev).float())
        qq, qs = qq.contiguous(), qs.contiguous()
        arena, qry, bf16 = codes, None, 0
    else:
        check_arena(rows, "ivf_topk")
        n, d = rows.shape
        arena, scale, qq, qs = rows, None, None, None
        qry = queries.to(device=dev, dtype=torch.float32).contiguous()
        bf16 = int(rows.dtype == torch.bfloat16)
    members = members.to(device=dev, dtype=torch.int32).contiguous()
    extras = extras.to(device=dev, dtype=torch.int32).contiguous()
    cids = cids.to(device=dev, dtype=torch.int32).contiguous()
    nq, p = cids.shape
    n_c, m_w = members.shape
    e = extras.shape[0]
    length = p * m_w + e
    e_live = e if n_extras is None else int(n_extras)
    if not 0 <= e_live <= e:
        raise ValueError("ivf_topk: n_extras must be in [0, E]")
    if occ is not None:
        occ = occ.to(device=dev, dtype=torch.int32).contiguous()
        if occ.shape != (n_c,):
            raise ValueError("ivf_topk: occ must be [C]")
    if queries.shape != (nq, d):
        raise ValueError("ivf_topk: queries [Q, d] must match cids and rows")
    if not (1 <= k <= length and 0 <= g <= length):
        raise ValueError(f"ivf_topk needs 1 <= k <= L and g <= L; k={k}, g={g}, "
                         f"L={length}")
    u8 = lambda t: t.to(device=dev).contiguous().view(torch.uint8)  # noqa: E731
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()  # noqa: E731
    keyed = form != "classic"
    if keyed:
        alive, row_tenant, is_super = u8(cols[0]), i32(cols[1]), u8(cols[2])
        q_ten = i32(q_tenant)
        npq = None if nprobe_q is None else i32(nprobe_q)
        msk = None
        if alive.shape != (n,) or q_ten.shape != (nq,) or (
                npq is not None and npq.shape != (nq,)):
            raise ValueError("ivf_topk: row columns [N] and query columns [Q]")
    else:
        alive = row_tenant = is_super = q_ten = npq = None
        msk = u8(mask)
        if msk.shape != (n,):
            raise ValueError("ivf_topk: mask must be [N]")
    lib = _library()
    kc, gc = min(k, PASS_K), min(g, PASS_K)
    # The splits are planned from the tables' shape (a build fills a
    # cluster's slots to about a quarter); the blocks share the occupied
    # positions the card counts, so any plan is correct.
    work = (p * m_w if occ is None else p * m_w // 4) + e_live
    splits = lib.ivf_topk_plan(work, nq, _sms(dev), max(kc, gc))
    cand = torch.empty((splits, nq, kc), dtype=torch.int64, device=dev)
    candr = torch.empty((splits, nq, kc), dtype=torch.int32, device=dev)
    gcand = torch.empty((splits, nq, max(gc, 1)), dtype=torch.int64, device=dev)
    gcandr = torch.empty((splits, nq, max(gc, 1)), dtype=torch.int32, device=dev)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_p = torch.empty((nq, k), dtype=torch.int32, device=dev)
    out_r = torch.empty((nq, k), dtype=torch.int32, device=dev)
    gk = max(g, 1)
    gout_s = torch.empty((nq, gk), dtype=torch.float32, device=dev)
    gout_p = torch.empty((nq, gk), dtype=torch.int32, device=dev)
    gout_r = torch.empty((nq, gk), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ivf_topk(
            FORMS[form], arena.data_ptr(), bf16, ptr(scale), members.data_ptr(),
            extras.data_ptr(), cids.data_ptr(), ptr(occ), ptr(alive),
            ptr(row_tenant), ptr(is_super), ptr(msk), ptr(qry), ptr(qq), ptr(qs),
            ptr(q_ten), ptr(npq), d, nq, n_c, m_w, p, e, e_live, k, g, splits,
            kc, gc, cand.data_ptr(), candr.data_ptr(), gcand.data_ptr(),
            gcandr.data_ptr(), out_s.data_ptr(), out_p.data_ptr(),
            out_r.data_ptr(), gout_s.data_ptr(), gout_p.data_ptr(),
            gout_r.data_ptr(), ctypes.byref(launched), stream)
    stage_launches += launched.value
    if rc != 0:
        raise RuntimeError(f"ivf_topk kernel launch failed ({form} form): "
                           f"CUDA error {rc}")
    launches += 1
    launches_int8 += form == "int8"
    launches_classic += form == "classic"
    if not keyed:
        return out_s, out_p, out_r, None, None, None
    return out_s, out_p, out_r, gout_s, gout_p, gout_r


def ivf_topk(rows, members: torch.Tensor, extras: torch.Tensor,
             cids: torch.Tensor, queries: torch.Tensor, k: int, *, g: int = 0,
             cols=None, q_tenant=None, mask=None, nprobe_q=None, occ=None,
             n_extras=None) -> Tuple[torch.Tensor, ...]:
    """The IVF candidate scan. ``rows``: the arena ``[N, d]`` (f32 or bf16),
    or ``(codes [N, d] i8, scale [N] f32)`` for the int8 form; ``members
    [C, M]``, ``extras [E]`` and ``cids [Q, P]`` (i32, -1 padded; ``cids``
    from the coarse stage); ``queries [Q, d]`` f32: the values scored (the
    exact forms) or the normalized queries to quantize (int8). Keyed forms
    take ``cols = (alive, tenant_id, is_super)``, ``q_tenant [Q]``, ``g``
    (the gate list's length) and optionally ``nprobe_q [Q]``; the classic
    form takes ``mask [N]`` bool. ``occ [C]`` (i32, on the tables' device)
    and ``n_extras`` (an int) bound the occupied slots (see the module's
    note; None walks them all). Returns ``(ann_s, ann_pos, ann_rows,
    gate_s, gate_pos, gate_rows)``, ``[Q, k]`` and ``[Q, g]`` (scores f32,
    positions and rows i32; the gate three None in the classic form)."""
    form = form_of(rows, cols, mask)
    if members.device.type == "cuda":
        return _launch(form, rows, members, extras, cids, queries, k, g, cols,
                       q_tenant, mask, nprobe_q, occ, n_extras)
    if members.device.type == "cpu":
        return ivf_topk_reference(rows, members, extras, cids, queries, k, g=g,
                                  cols=cols, q_tenant=q_tenant, mask=mask,
                                  nprobe_q=nprobe_q, occ=occ, n_extras=n_extras)
    raise ValueError(f"ivf_topk: unsupported device {members.device}")

