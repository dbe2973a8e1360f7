"""Coarse-to-fine retrieval over the arena: the IVF build, the coarse
stage and the classic IVF search, in torch.

Counterpart of ``lazzaro_tpu/ops/ivf.py``. Spherical k-means clusters the
live rows; a query scores the C centroids (C ~ sqrt(N)), visits the member
rows of its ``nprobe`` nearest clusters plus the exact-scan extras
(overflowed rows, rows added after the build and, for fused serving, the
super rows), and scans only those. Recall is controlled by ``nprobe`` (all
clusters is exact, as every live row sits in a cluster or the extras).

The coarse stage (:func:`coarse_clusters`) is the masked top-k kernel
(``ops.masked_topk``, #1) over the f32 centroid table with every row live;
the candidate scan is K5 (``ops.ivf_topk``). The k-means and the table
build are plain torch on the arena's device and numpy on the host, as the
JAX package leaves them to XLA and numpy. Cluster sums are segment sums in
row order on both devices (:func:`segment_sum`), so a build on a card is
the same run to run; :func:`shard_serve_tables` (the pod path) is not
ported (ROADMAP Queue 1 item 21).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.ops.chunking import nt_dot
from lazzaro_tpu_torch.ops.ivf_topk import ivf_candidates, ivf_topk
from lazzaro_tpu_torch.ops.masked_topk import masked_topk

# Rows a k-means assignment scores at once on a card ([chunk, C] f32
# scores); on the CPU ``nt_dot`` chunks by itself.
ASSIGN_CHUNK = 65_536


def segment_sum(n_seg: int, seg: torch.Tensor, vals: torch.Tensor
                ) -> torch.Tensor:
    """``zeros([n_seg, ...]).at[seg].add(vals)`` with each segment's values
    added one after another in row order, as XLA's CPU scatter adds them:
    ``index_add_`` on the CPU (a serial loop over the index) and, on a card,
    ``index_put_(accumulate=True)``, which sorts the index stably and adds
    each segment's values in that order (``index_add_`` there adds with
    atomics, in an order that changes from run to run). One call for both
    will not do: on the CPU ``index_put_(accumulate=True)`` differs from
    XLA's sums in the last bits."""
    out = torch.zeros((n_seg,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    seg = seg.long()
    if vals.device.type == "cpu":
        return out.index_add_(0, seg, vals)
    return out.index_put_((seg,), vals, accumulate=True)


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Each row's nearest centroid (``jnp.argmax`` of its f32 scores: ties
    to the lowest id), ``[N]`` i64."""
    n = x.shape[0]
    step = n if x.device.type == "cpu" else ASSIGN_CHUNK
    return torch.cat([torch.argmax(nt_dot(x[i:i + step], cent), dim=1)
                      for i in range(0, n, step)])


def _kmeans(emb: torch.Tensor, mask: torch.Tensor, init_rows: torch.Tensor,
            n_clusters: int, iters: int) -> torch.Tensor:
    """Spherical k-means (``ops/ivf.py:_kmeans_device``): normalized
    centroids ``[C, d]`` f32. Dead rows never contribute (they go to bucket
    C, which is dropped); a cluster that goes empty keeps its centroid."""
    x = emb.float()
    cent = x[init_rows.long()]
    c = n_clusters
    for _ in range(iters):
        a = torch.where(mask, _assign(x, cent), c)
        sums = segment_sum(c + 1, a, x)[:c]
        counts = segment_sum(c + 1, a, mask.float())[:c]
        norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        new = sums / torch.clamp(norms, min=1e-9)
        cent = torch.where((counts[:, None] > 0) & (norms > 1e-9), new, cent)
    return cent


def _assign_masked(emb: torch.Tensor, mask: torch.Tensor,
                   cent: torch.Tensor) -> torch.Tensor:
    """Final assignment ``[N]`` i32, dead rows -1
    (``ops/ivf.py:_assign_device``)."""
    return torch.where(mask, _assign(emb.float(), cent), -1).int()


@dataclass
class IvfIndex:
    centroids: torch.Tensor  # [C, d] f32, L2-normalized
    members: torch.Tensor    # [C, M] i32 arena rows, -1 padded
    residual: torch.Tensor   # [R] i32 arena rows scanned exactly, -1 padded
    built_rows: int          # alive rows at build time (staleness signal)

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]


def _pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << max(0, int(n - 1)).bit_length())


def build_ivf(emb: torch.Tensor, mask_np: np.ndarray,
              n_clusters: Optional[int] = None, iters: int = 8,
              member_cap_factor: int = 4, seed: int = 0) -> IvfIndex:
    """Cluster the alive rows and build the fixed-shape member table
    (``ops/ivf.py:build_ivf``): the initial centroids are the rows numpy's
    ``default_rng(seed).choice`` draws, as the JAX package draws them; a
    cluster's capacity is ``member_cap_factor * N / C`` (pow2-rounded) and
    the rows past it overflow into the residual, never dropped. The tables
    live on ``emb``'s device."""
    alive_rows = np.nonzero(mask_np)[0]
    n_alive = len(alive_rows)
    if n_alive == 0:
        raise ValueError("cannot build an IVF over an empty arena")
    if n_clusters is None:
        n_clusters = max(4, _pow2(int(np.sqrt(n_alive)), lo=4))
    n_clusters = min(n_clusters, n_alive)
    rng = np.random.default_rng(seed)
    init = rng.choice(alive_rows, size=n_clusters, replace=False)

    dev = emb.device
    mask = torch.as_tensor(np.asarray(mask_np, bool), device=dev)
    cent = _kmeans(emb, mask, torch.as_tensor(init.astype(np.int64), device=dev),
                   n_clusters, iters)
    assign = _assign_masked(emb, mask, cent).cpu().numpy()

    cap = _pow2(member_cap_factor * max(1, n_alive // n_clusters))
    members = np.full((n_clusters, cap), -1, np.int32)
    a = assign[alive_rows]
    order = np.argsort(a, kind="stable")
    sorted_rows = alive_rows[order].astype(np.int32)
    counts = np.bincount(a, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    overflow_parts = []
    for c in range(n_clusters):
        seg = sorted_rows[starts[c]:starts[c] + counts[c]]
        members[c, :min(cap, len(seg))] = seg[:cap]
        if len(seg) > cap:
            overflow_parts.append(seg[cap:])
    overflow = (np.concatenate(overflow_parts) if overflow_parts
                else np.zeros((0,), np.int32))
    residual = np.full((_pow2(len(overflow), lo=8),), -1, np.int32)
    residual[:len(overflow)] = overflow
    return IvfIndex(centroids=cent, members=torch.from_numpy(members).to(dev),
                    residual=torch.from_numpy(residual).to(dev),
                    built_rows=n_alive)


def online_counts(members: torch.Tensor) -> torch.Tensor:
    """Per-cluster live-prefix occupancy of a member table, the append
    cursor of the online ingest update (``ops/ivf.py:online_counts``)."""
    return (members >= 0).sum(dim=-1).int()


def assignment_staleness(emb: torch.Tensor, mask_np: np.ndarray,
                         cent: torch.Tensor, members: torch.Tensor) -> float:
    """Fraction of live member slots whose row's nearest centroid is no
    longer its cluster (``ops/ivf.py:assignment_staleness``): an O(N * C)
    diagnostic, never the serving path."""
    mask = torch.as_tensor(np.asarray(mask_np, bool), device=emb.device)
    assign = _assign_masked(emb, mask, cent)
    safe = torch.clamp(members, min=0).long()
    ok = (members >= 0) & (assign[safe] >= 0)
    home = torch.arange(cent.shape[0], device=members.device)[:, None]
    stale = ok & (assign[safe] != home)
    live = int(ok.sum())
    return float(stale.sum()) / live if live else 0.0


def coarse_clusters(centroids: torch.Tensor, q: torch.Tensor,
                    nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest clusters of each normalized f32 query,
    ``[Q, nprobe]`` i32 in rank order: ``lax.top_k`` of ``jnp.dot(q,
    centroids.T)`` (ties to the lower id), through the masked top-k
    kernel with every centroid live."""
    live = torch.zeros((centroids.shape[0],), dtype=torch.float32,
                       device=centroids.device)
    return masked_topk(centroids, live, q, nprobe)[1].int()


def gather_rows(centroids: torch.Tensor, members: torch.Tensor,
                extras: torch.Tensor, q_c: torch.Tensor, nprobe: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain candidate assembly (``ops/ivf.py:gather_rows``): the coarse
    stage, then ``(cand [Q, L], safe [Q, L])`` with L = nprobe * M + E and
    ``safe = max(cand, 0)``. The scans do not call it: K5 reads the
    tables itself."""
    cand = ivf_candidates(members, extras, coarse_clusters(centroids, q_c,
                                                           nprobe))
    return cand, torch.clamp(cand, min=0)


def gather_candidates(centroids: torch.Tensor, members: torch.Tensor,
                      residual: torch.Tensor, mask: torch.Tensor,
                      q_c: torch.Tensor, nprobe: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-tenant view over :func:`gather_rows`
    (``ops/ivf.py:gather_candidates``): ``(cand, safe, valid)``."""
    cand, safe = gather_rows(centroids, members, residual, q_c, nprobe)
    return cand, safe, (cand >= 0) & mask[safe.long()]


def pack_extras(residual: np.ndarray, fresh_rows, super_rows) -> np.ndarray:
    """The exact-scan row set of fused serving (``ops/ivf.py:pack_extras``):
    the sealed residual, the fresh rows and every super row, -1-padded to
    a power of two. A super row can then appear twice (its cluster slot
    and here); the top-k dedup drops the second, and the top-1 gate is
    immune to duplicates."""
    base = np.asarray(residual)
    comb = np.concatenate([base[base >= 0],
                           np.asarray(list(fresh_rows), np.int32),
                           np.asarray(list(super_rows), np.int32)])
    padded = np.full((_pow2(len(comb)),), -1, np.int32)
    padded[:len(comb)] = comb
    return padded


def ivf_search(centroids: torch.Tensor, members: torch.Tensor,
               residual: torch.Tensor, emb: torch.Tensor, mask: torch.Tensor,
               queries: torch.Tensor, k: int, nprobe: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse (centroid) to fine (member scan) masked top-k
    (``ops/ivf.py:ivf_search``): the queries normalized in f32, their
    ``nprobe`` nearest clusters, then K5's classic form over the members
    and the residual with the ``[N]`` mask, the f32 query against the rows
    widened to f32. Returns ``(scores [Q, k] f32, rows [Q, k] i32)``; a
    position past the valid candidates carries its slot's row at
    ``NEG_INF``."""
    q = queries.float()
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-9)
    nprobe = min(nprobe, centroids.shape[0])
    cids = coarse_clusters(centroids, q, nprobe)
    s, _, rows, *_ = ivf_topk(emb, members, residual, cids, q, k, mask=mask)
    return s, rows
