"""The sequential duplicate resolve of the fused dedup ingest: a Hopper
kernel and its plain version.

The counterpart of the ``lax.scan`` in
``lazzaro_tpu/core/state.py:_dedup_resolve`` (XLA; no Pallas kernel). It
walks a fact batch in order and, per fact, blends the intra-batch gram's
best earlier match ``(g_s, g_j)`` with the arena probe's top-1 ``(p_s,
p_r)``: a valid fact whose best score beats ``dedup_gate`` is a duplicate of
that target (a duplicate of an earlier duplicate chains to its target), and
each live fact's chain predecessor is the last live fact of its shard group
``chain_gid`` before it. Comparisons are in f32, as the JAX scan makes them.

The kernel (``csrc/dedup_resolve.cu``, CUDA C++ for ``sm_90a``, built with
``nvcc`` on first use and bound through ``ctypes``) walks the batch with one
thread in one launch. :func:`dedup_resolve` launches it for CUDA tensors and
runs :func:`dedup_resolve_reference`, a loop over the batch, only for CPU
tensors. ``launches`` counts the launches made through :func:`dedup_resolve`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lazzaro_tpu_torch.utils import cuda_build

launches = 0

_lib = None

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library():
    global _lib
    if _lib is None:
        lib = cuda_build.load("dedup_resolve")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dedup_resolve.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                      ctypes.c_float, ptr, ptr, ptr, ptr, ptr]
        lib.dedup_resolve.restype = i32
        _lib = lib
    return _lib


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


def _launch(g_s, g_j, p_s, p_r, valid, rows, chain_gid, dedup_gate, cap) -> Result:
    global launches
    dev = rows.device
    b = rows.shape[0]
    cols = [g_s.to(dev, torch.float32), g_j.to(dev, torch.int32),
            p_s.to(dev, torch.float32), p_r.to(dev, torch.int32),
            valid.to(dev, torch.uint8), rows.to(dev, torch.int32),
            chain_gid.to(dev, torch.int32)]
    cols = [c.contiguous() for c in cols]
    if b < 1 or any(c.shape != (b,) for c in cols):
        raise ValueError("dedup_resolve: every input must be [B] with B >= 1")
    target, dup, chain, last = (torch.empty((b,), dtype=torch.int32, device=dev)
                                for _ in range(4))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dedup_resolve(*[c.data_ptr() for c in cols], b, int(cap),
                               float(dedup_gate), target.data_ptr(),
                               dup.data_ptr(), chain.data_ptr(), last.data_ptr(),
                               stream)
    if rc != 0:
        raise RuntimeError(f"dedup_resolve kernel launch failed: CUDA error {rc}")
    launches += 1
    return target, dup.bool(), chain


def dedup_resolve(g_s: torch.Tensor, g_j: torch.Tensor, p_s: torch.Tensor,
                  p_r: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                  chain_gid: torch.Tensor, dedup_gate: float, cap: int) -> Result:
    """``(target [B] i32, dup [B] bool, chain_src [B] i32)`` of a batch of
    ``B`` facts (inputs ``[B]``; ``dedup_gate`` a host float, ``cap`` the
    arena's capacity). CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    if rows.device.type == "cuda":
        return _launch(g_s, g_j, p_s, p_r, valid, rows, chain_gid, dedup_gate,
                       cap)
    if rows.device.type == "cpu":
        return dedup_resolve_reference(g_s, g_j, p_s, p_r, valid, rows,
                                       chain_gid, dedup_gate, cap)
    raise ValueError(f"dedup_resolve: unsupported device {rows.device}")
