"""Plain top-k building blocks, counterpart of ``lazzaro_tpu/ops/topk.py``.

``stable_topk`` is the one place the port picks k best entries without a
kernel: it reproduces ``lax.top_k``'s order (score descending, ties to the
lowest index), which ``torch.topk`` does not promise. Duplicate facts score
exact ties, and the dedup and link decisions must not depend on luck.
``masked_topk`` is the plain masked cosine top-k, and the plain version the
Hopper kernel (``ops.masked_topk``) is held against; ``ragged_mask`` is the
per-query k boundary of both kernels' ragged forms.

The row-sharded top-k (``lazzaro_tpu/ops/topk.py:make_sharded_topk``) is
:func:`make_sharded_topk`: the shards that share a card scanned by one
grouped launch of the masked top-k kernel (``ops.masked_topk.
masked_topk_grouped``), and the groups of several cards joined by the
cross-shard merge (``ops.sharded_merge``), whose plain version is
:func:`sharded_topk_merge`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

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


def sharded_topk_merge(top_s: Sequence[torch.Tensor],
                       top_i: Sequence[torch.Tensor], local_n: int, k: int,
                       k_q: Optional[torch.Tensor] = None,
                       sentinel: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain cross-shard merge (``lazzaro_tpu/ops/topk.py:sharded_topk_merge``
    with the row globalization of ``:165`` and
    ``core/state.py:_globalize_rows``). ``top_s[p]`` / ``top_i[p]`` are shard
    ``p``'s ``[Q, kl]`` candidates (scores f32, LOCAL rows) in
    :func:`stable_topk` order; shard ``p`` holds the global rows ``[p *
    local_n, (p + 1) * local_n)``. Rows are globalized (entries scoring at
    or below ``NEG_INF / 2`` become ``sentinel`` when one is given), the
    lists concatenate shard-major, so ties go to the lower shard, i.e. to
    the lower global row, as ``lax.top_k`` over the ``all_gather`` orders
    them, and :func:`stable_topk` takes the top ``k``. With ``k_q [Q]`` the
    positions at or past ``k_q[q]`` become ``(NEG_INF, sentinel)`` (-1
    without one). Runs on the device of ``top_s[0]``; returns ``(scores
    [Q, k] f32, rows [Q, k] i32)``."""
    dev = top_s[0].device
    scores, rows = [], []
    for p, (s, r) in enumerate(zip(top_s, top_i)):
        s = s.to(dev).float()
        r = r.to(dev).long() + p * int(local_n)
        if sentinel is not None:
            r = torch.where(s > NEG_INF / 2, r, int(sentinel))
        scores.append(s)
        rows.append(r)
    all_s, all_r = torch.cat(scores, dim=1), torch.cat(rows, dim=1)
    fin_s, pos = stable_topk(all_s, k)
    fin_r = torch.gather(all_r, 1, pos).int()
    if k_q is not None:
        fin_s, fin_r = ragged_mask(fin_s, fin_r, k_q,
                                   -1 if sentinel is None else int(sentinel))
    return fin_s, fin_r


def shard_groups(devices: Sequence) -> List[Tuple[torch.device, List[int]]]:
    """Runs of consecutive shards on one device: ``[(device, [p, ...])]`` in
    shard order. Each run is one grouped launch; the runs of a mesh that
    puts every shard on one card are one run, and ascending shard ids keep
    the cross-run merge's ties in global-row order."""
    groups: List[Tuple[torch.device, List[int]]] = []
    for p, dev in enumerate(devices):
        dev = torch.device(dev)
        if groups and groups[-1][0] == dev:
            groups[-1][1].append(p)
        else:
            groups.append((dev, [p]))
    return groups


def make_sharded_topk(mesh, axis: str = "data", k: int = 10) -> Callable:
    """The row-sharded masked top-k (``lazzaro_tpu/ops/topk.py:115``) over
    ``mesh`` (``parallel.mesh.Mesh``). Returns ``search(shards, mask_shards,
    query) -> (scores [Q, k] f32, global_rows [Q, k] i32)``: ``shards[p]``
    is shard ``p``'s ``[L, d]`` embedding rows on its device and
    ``mask_shards[p]`` its ``[L]`` bool alive mask, the query ``[Q, d]`` (or
    ``[d]``) is replicated to every shard. The shards of each device (a run,
    :func:`shard_groups`) are one grouped scan,
    ``ops.masked_topk.masked_topk_grouped``: the top ``k`` of the union of
    the per-shard top-``k_l`` lists (``k_l = min(k, L)``), the same pairs
    since no two ``(score, global row)`` keys are equal. Several runs meet
    in the merge kernel (``ops.sharded_merge``) on the mesh's first device,
    ties to the lower run, i.e. the lower global row, as ``:165`` orders
    them."""
    from lazzaro_tpu_torch.ops.masked_topk import masked_topk_grouped
    from lazzaro_tpu_torch.ops.sharded_merge import sharded_merge

    n = mesh.shape[axis]
    dev0 = mesh.devices[0]

    def search(shards, mask_shards, query):
        if len(shards) != n or len(mask_shards) != n:
            raise ValueError(f"make_sharded_topk: {n} shards expected")
        q = torch.atleast_2d(query)
        local_n = shards[0].shape[0]
        k_l = min(k, local_n)
        parts = [masked_topk_grouped([shards[p] for p in ids],
                                     [mask_shards[p] for p in ids],
                                     q.to(dev, non_blocking=True),
                                     min(k, len(ids) * k_l), ids)
                 for dev, ids in shard_groups([s.device for s in shards])]
        if len(parts) == 1:
            return parts[0]
        return sharded_merge([s for s, _ in parts], [r for _, r in parts], 0, k,
                             device=dev0)

    return search
