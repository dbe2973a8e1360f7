"""The duplicate resolve of the fused dedup ingest: a Hopper kernel and its
plain version.

The counterpart of ``lazzaro_tpu/core/state.py:_dedup_resolve`` after its
gram product (XLA: a masked arg-max, a gather and a ``lax.scan``; no Pallas
kernel). For each fact of a batch, the intra-batch gram's best EARLIER valid
fact ``(g_s, g_j)`` (the first column on ties; ``(NEG_INF, 0)`` where there
is none) is blended with the arena probe's top-1 ``(p_s, p_r)``: a valid
fact whose best score beats ``dedup_gate`` is a duplicate of that target (a
duplicate of an earlier duplicate chains to its target), and each live
fact's chain predecessor is the last live fact of its shard group
``chain_gid`` before it. Comparisons are in f32, as the JAX scan makes them.

The kernel (``csrc/dedup_resolve.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` on first use and bound through ``ctypes``) is one C entry with two
forms. The gram form (:func:`dedup_resolve_gram`) launches stage A, the
arg-max over the gram's strict lower triangle (a warp a pair of rows
``i, B - 1 - i``, 16-byte loads; it reads each triangle float once, which
is where its time goes), then stage B, the walk as parallel passes in one
block: the verdicts elementwise, the targets by pointer jumping, the chain
predecessors by a stable block radix sort of the live facts by group. The
walk form (:func:`dedup_resolve`) takes ``(g_s, g_j)`` and launches stage B
alone. Both equal their plain versions bit for bit: the arg-max only selects
gram values and the rest is integer work.

CUDA tensors launch the kernel (a failure raises); CPU tensors run the plain
versions, :func:`dedup_resolve_gram_reference` (the mask, ``masked_fill``,
``argmax`` and ``gather``, then the loop) and
:func:`dedup_resolve_reference` (a loop over the batch). ``launches`` counts
the calls that launched (one an ingest batch), ``launches_card`` the kernels
the card ran (two a gram-form call, one a walk-form call).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lazzaro_tpu_torch.ops.topk import NEG_INF
from lazzaro_tpu_torch.utils import cuda_build

launches = 0
launches_card = 0

_lib = None

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("dedup_resolve")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dedup_resolve.argtypes = [ptr] * 8 + [i32, i32, ctypes.c_float] + [ptr] * 8
        lib.dedup_resolve.restype = i32
        _lib = lib
    return _lib


def gram_argmax_reference(gram: torch.Tensor, valid: torch.Tensor):
    """Plain version of stage A: ``(g_s [B] f32, g_j [B] i64)``, each fact's
    best earlier valid fact in the gram (``NEG_INF`` elsewhere, the first
    column on ties)."""
    b = gram.shape[0]
    earlier = torch.ones((b, b), dtype=torch.bool, device=gram.device).tril(-1)
    tril = gram.masked_fill(~(earlier & valid.bool()[None, :]), NEG_INF)
    g_j = torch.argmax(tril, dim=1)
    g_s = torch.gather(tril, 1, g_j[:, None])[:, 0]
    return g_s, g_j


def dedup_resolve_reference(g_s: torch.Tensor, g_j: torch.Tensor,
                            p_s: torch.Tensor, p_r: torch.Tensor,
                            valid: torch.Tensor, rows: torch.Tensor,
                            chain_gid: torch.Tensor, dedup_gate: float,
                            cap: int) -> Result:
    """Plain version: the scan of ``_dedup_resolve`` as a loop over the
    batch. Returns ``(target [B] i32, dup [B] bool, chain_src [B] i32)`` on
    the inputs' device. ``chain_gid`` is densified (``< B``, -1 padding)."""
    gs, ps = g_s.float().tolist(), p_s.float().tolist()
    gj, pr = g_j.tolist(), p_r.tolist()
    vd, rw, gid = valid.bool().tolist(), rows.tolist(), chain_gid.tolist()
    # the gate as an f32 value: the comparisons below are between f32 values
    gate = torch.tensor(float(dedup_gate), dtype=torch.float32).item()
    b = len(rw)
    target, dup, chain = [cap] * b, [False] * b, [-1] * b
    last = [-1] * b
    for i in range(b):
        use_g = gs[i] > ps[i]
        best_s = gs[i] if use_g else ps[i]
        best_t = target[gj[i]] if use_g else pr[i]
        is_dup = vd[i] and best_s > gate
        target[i] = best_t if is_dup else rw[i]
        dup[i] = is_dup
        live = vd[i] and not is_dup
        g = max(gid[i], 0)
        prev = last[g] if gid[i] >= 0 else -1
        chain[i] = prev if live and prev >= 0 else -1
        if live:
            last[g] = rw[i]
    dev = rows.device
    return (torch.tensor(target, dtype=torch.int32, device=dev),
            torch.tensor(dup, dtype=torch.bool, device=dev),
            torch.tensor(chain, dtype=torch.int32, device=dev))


def dedup_resolve_gram_reference(gram: torch.Tensor, p_s: torch.Tensor,
                                 p_r: torch.Tensor, valid: torch.Tensor,
                                 rows: torch.Tensor, chain_gid: torch.Tensor,
                                 dedup_gate: float, cap: int) -> Result:
    """Plain version of the gram form: :func:`gram_argmax_reference`, then
    :func:`dedup_resolve_reference`."""
    g_s, g_j = gram_argmax_reference(gram, valid)
    return dedup_resolve_reference(g_s, g_j, p_s, p_r, valid, rows, chain_gid,
                                   dedup_gate, cap)


def _check(name: str, gram, cols, dev) -> int:
    """The batch size; raises ``ValueError`` unless every column is ``[B]``
    with ``B >= 1`` and the gram (where given) a ``[B, B]`` f32 tensor on
    ``dev``, the rows' device."""
    b = cols[0].shape[0] if cols[0].dim() == 1 else -1
    if b < 1 or any(c.shape != (b,) for c in cols):
        raise ValueError(f"{name}: every column must be [B] with B >= 1, not "
                         f"{[tuple(c.shape) for c in cols]}")
    if gram is not None and (gram.shape != (b, b) or gram.dtype != torch.float32
                             or gram.device != dev):
        raise ValueError(f"{name}: the gram must be [B, B] = [{b}, {b}] f32 on "
                         f"{dev}, not {list(gram.shape)} "
                         f"{gram.dtype} on {gram.device}")
    return b


def _launch(gram, g_s, g_j, p_s, p_r, valid, rows, chain_gid, dedup_gate,
            cap) -> Result:
    global launches, launches_card
    dev = rows.device
    b = rows.shape[0]

    def col(c, dtype):
        return c.to(dev, dtype).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    valid = col(valid, torch.bool)     # the kernel reads a byte a fact
    p_s, p_r = col(p_s, torch.float32), col(p_r, torch.int32)
    rows, chain_gid = col(rows, torch.int32), col(chain_gid, torch.int32)
    arg_s = arg_j = None
    if gram is None:
        g_s, g_j = col(g_s, torch.float32), col(g_j, torch.int32)
    else:
        gram = gram.contiguous()
        arg_s = torch.empty((b,), dtype=torch.float32, device=dev)
        arg_j = torch.empty((b,), dtype=torch.int32, device=dev)
    target, chain = (torch.empty((b,), dtype=torch.int32, device=dev)
                     for _ in range(2))
    dup = torch.empty((b,), dtype=torch.bool, device=dev)
    scratch = torch.empty((5 * b,), dtype=torch.int32, device=dev)
    lib = _library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dedup_resolve(
            ptr(gram), ptr(g_s), ptr(g_j), ptr(p_s), ptr(p_r), ptr(valid),
            ptr(rows), ptr(chain_gid), b, int(cap), float(dedup_gate),
            ptr(arg_s), ptr(arg_j), ptr(target), ptr(dup), ptr(chain),
            ptr(scratch), ctypes.byref(launched), stream)
    launches_card += launched.value
    if rc != 0:
        raise RuntimeError(f"dedup_resolve kernel launch failed: CUDA error {rc}")
    launches += 1
    return target, dup, chain


def dedup_resolve_gram(gram: torch.Tensor, p_s: torch.Tensor,
                       p_r: torch.Tensor, valid: torch.Tensor,
                       rows: torch.Tensor, chain_gid: torch.Tensor,
                       dedup_gate: float, cap: int) -> Result:
    """The gram form: ``(target [B] i32, dup [B] bool, chain_src [B] i32)``
    of a batch of ``B`` facts from their f32 gram ``[B, B]`` (read, never
    written) and the columns ``[B]`` (``dedup_gate`` a host float, ``cap``
    the arena's capacity). CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check("dedup_resolve_gram", gram, (p_s, p_r, valid, rows, chain_gid),
           rows.device)
    if rows.device.type == "cuda":
        return _launch(gram, None, None, p_s, p_r, valid, rows, chain_gid,
                       dedup_gate, cap)
    if rows.device.type == "cpu":
        return dedup_resolve_gram_reference(gram, p_s, p_r, valid, rows,
                                            chain_gid, dedup_gate, cap)
    raise ValueError(f"dedup_resolve_gram: unsupported device {rows.device}")


def dedup_resolve(g_s: torch.Tensor, g_j: torch.Tensor, p_s: torch.Tensor,
                  p_r: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                  chain_gid: torch.Tensor, dedup_gate: float, cap: int) -> Result:
    """The walk form: ``(target [B] i32, dup [B] bool, chain_src [B] i32)``
    of a batch of ``B`` facts from each one's best earlier fact ``(g_s,
    g_j)`` (``0 <= g_j < B``) and the other columns (inputs ``[B]``;
    ``dedup_gate`` a host float, ``cap`` the arena's capacity). CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _check("dedup_resolve", None, (g_s, g_j, p_s, p_r, valid, rows, chain_gid),
           rows.device)
    if rows.device.type == "cuda":
        return _launch(None, g_s, g_j, p_s, p_r, valid, rows, chain_gid,
                       dedup_gate, cap)
    if rows.device.type == "cpu":
        return dedup_resolve_reference(g_s, g_j, p_s, p_r, valid, rows,
                                       chain_gid, dedup_gate, cap)
    raise ValueError(f"dedup_resolve: unsupported device {rows.device}")
