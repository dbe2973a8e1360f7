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


def nt_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``q @ rows.T`` with f32 sums: bf16 operands are widened first (their
    products are exact in f32), matching ``preferred_element_type=f32``."""
    return torch.matmul(q.float(), rows.float().t())


def chunked_map(fn, xs: torch.Tensor, chunk: int = QUERY_CHUNK):
    """Apply ``fn`` ([C, ...] -> tuple of [C, ...]) to row-chunks of ``xs``
    and concatenate each output along dim 0."""
    b = xs.shape[0]
    if b <= chunk:
        return fn(xs)
    parts = [fn(xs[i:i + chunk]) for i in range(0, b, chunk)]
    return tuple(torch.cat(col) for col in zip(*parts))
