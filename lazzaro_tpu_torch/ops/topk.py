"""Plain top-k building blocks, counterpart of ``lazzaro_tpu/ops/topk.py``.

``stable_topk`` is the one place the port picks k best entries without a
kernel: it reproduces ``lax.top_k``'s order (score descending, ties to the
lowest index), which ``torch.topk`` does not promise. Duplicate facts score
exact ties, and the dedup and link decisions must not depend on luck.
``masked_topk`` is the plain masked cosine top-k, and the plain version the
Hopper kernel (``ops.masked_topk``) is held against; ``ragged_mask`` is the
per-query k boundary of both kernels' ragged forms.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lazzaro_tpu_torch.ops.chunking import chunked_map, nt_dot

NEG_INF = -1e30


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of an f32 tensor: ``(values, indices)``,
    values descending, equal values in ascending index order.

    Each entry becomes one unique int64 key, its f32 bits mapped to an
    order-preserving int32 in the high half and the complement of its index
    in the low half, so ``torch.topk`` over the keys has no ties to break."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    key32 = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    keys = key32.to(torch.int64) * (1 << 32) + (0xFFFFFFFF - idx)
    top = torch.topk(keys, k, dim=-1).indices
    return torch.gather(x, -1, top), top


def ragged_mask(scores: torch.Tensor, rows: torch.Tensor, k_q: torch.Tensor,
                sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k boundary (``pallas_topk.py:pallas_masked_topk_ragged``,
    ``state.py:_ragged_topk_mask``): positions at or past each query's
    ``k_q`` become ``(NEG_INF, sentinel)``. Exactly the per-query top-k,
    since the ceiling top-k is score-sorted."""
    live = (torch.arange(scores.shape[1], device=scores.device)[None, :]
            < k_q.to(scores.device)[:, None])
    return (torch.where(live, scores, NEG_INF),
            torch.where(live, rows, torch.full_like(rows, sentinel)))


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """Bool ``[N]`` alive mask -> additive f32 mask (0 alive / ``NEG_INF``
    dead); an f32 mask passes through."""
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    return mask.to(torch.float32)


def masked_topk(emb: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device masked cosine top-k (``lazzaro_tpu/ops/topk.py:33``).
    ``emb [N, d]`` has L2-normalized rows; ``mask [N]`` is a bool alive mask
    or an additive f32 one. The query is cast to the arena dtype and the
    products summed in f32, plus the additive mask, as the TPU kernel does
    (``pallas_topk.py:37``): a dead row scores ``NEG_INF + s``, which rounds
    to ``NEG_INF`` for a cosine, so a bool mask gives the JAX ``where``
    result. Then :func:`stable_topk`, per chunk of ``QUERY_CHUNK`` queries.
    Returns ``(scores f32, rows i64)``, ``[k]`` for a 1-D query and
    ``[Q, k]`` otherwise."""
    madd = additive_mask(mask)
    rows = emb.float()
    q = torch.atleast_2d(query).to(emb.dtype)
    top_s, top_i = chunked_map(
        lambda qc: stable_topk(nt_dot(qc, rows) + madd, k), q)
    if query.ndim == 1:
        return top_s[0], top_i[0]
    return top_s, top_i
