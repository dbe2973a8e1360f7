"""Query-chunked scans: the "[chunk, N] tile bounds device memory" rule.

Counterpart of ``lazzaro_tpu/ops/chunking.py``. Whole-arena scans score a
[B, capacity+1] f32 matrix; at 1M rows that is ~4 GB per 1k queries, so the
plain scans walk the batch in chunks of ``QUERY_CHUNK`` rows. PyTorch runs
eagerly, so the JAX ``lax.map`` becomes a Python loop.
"""

from __future__ import annotations

import torch

# [QUERY_CHUNK, capacity+1] f32 is the transient high-water mark of every
# plain arena scan: 2 GB at 1M rows.
QUERY_CHUNK = 512
# Elements of the [Q, rows, d] products the CPU form of nt_dot holds at once
# (4 MB of f32: a chunk that stays in cache runs ~6x faster than 64 MB).
CPU_DOT_ELEMS = 1 << 20
# Rows a CPU nt_dot chunk takes at least; a batch whose products would pass
# CPU_DOT_ELEMS at this many rows is split by queries instead.
CPU_DOT_ROWS = 256


def nt_dot(q: torch.Tensor, rows: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q @ rows.T`` with f32 sums: bf16 operands are widened first (their
    products are exact in f32), matching ``preferred_element_type=f32``.
    ``dtype=torch.float64`` sums in f64 instead (the int8 scan's exact dots
    past 2^24).

    On the CPU every score is a function of its query and its row alone:
    the products of a pair, summed over d by one reduction whose order
    depends on d only, never on the row's position, the number of rows or
    of queries (a CPU ``torch.matmul`` picks its blocking from the shapes,
    so the same pair could round differently in a shard than in the whole
    arena, or in a batch than alone). Rows go in chunks of at least
    ``CPU_DOT_ROWS``, queries in groups whose products fit ``CPU_DOT_ELEMS``
    (one group where a row chunk fits them all). On a card it is
    ``torch.matmul`` (no TF32): the plain versions there are references on
    grid values, whose sums are exact in any order."""
    q, rows = q.to(dtype), rows.to(dtype)
    if rows.device.type != "cpu":
        return torch.matmul(q, rows.t())
    nq, d = q.shape
    n = rows.shape[0]
    out = torch.empty((nq, n), dtype=dtype)
    rstep = max(CPU_DOT_ROWS, CPU_DOT_ELEMS // max(1, nq * d))
    qstep = max(1, CPU_DOT_ELEMS // (rstep * max(1, d)))
    for i in range(0, n, rstep):
        r = rows[None, i:i + rstep]
        for j in range(0, nq, qstep):
            out[j:j + qstep, i:i + rstep] = (q[j:j + qstep, None, :] * r).sum(-1)
    return out


def chunked_map(fn, xs: torch.Tensor, chunk: int = QUERY_CHUNK):
    """Apply ``fn`` ([C, ...] -> tuple of [C, ...]) to row-chunks of ``xs``
    and concatenate each output along dim 0."""
    b = xs.shape[0]
    if b <= chunk:
        return fn(xs)
    parts = [fn(xs[i:i + chunk]) for i in range(0, b, chunk)]
    return tuple(torch.cat(col) for col in zip(*parts))
