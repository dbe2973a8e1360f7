"""Host-side batching helpers of the port, a subset of
``lazzaro_tpu/utils/batching.py``: power-of-two and linear-bucket query
padding, the top-k decode from (scores, rows) back to ids, the unpacking of
the fused serving readback, and the time/size flush policy shared by the
ingest coalescer and the query scheduler.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1 — a single item needs no
    padding; mapping 1 → 2 would double every single-query dispatch)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pad_to_pow2(arr: np.ndarray) -> np.ndarray:
    """Pad axis 0 with zero rows up to the power-of-two bucket."""
    n = arr.shape[0]
    bucket = next_pow2(n)
    if bucket == n:
        return arr
    pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def bucket_size(n: int, granularity: int) -> int:
    """Query-batch bucket of the ragged serving path: linear multiples of
    ``granularity`` once a batch passes it (padding wastes at most
    ``granularity - 1`` slots), the power-of-two ladder below it (a lone
    request stays a 1-slot batch)."""
    g = max(1, int(granularity))
    n = max(1, int(n))
    if n <= g:
        return next_pow2(n)
    return -(-n // g) * g


def pad_to_bucket(arr: np.ndarray, granularity: int) -> np.ndarray:
    """Pad axis 0 with zero rows up to :func:`bucket_size`."""
    n = arr.shape[0]
    bucket = bucket_size(n, granularity)
    if bucket == n:
        return arr
    pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def decode_topk(scores: np.ndarray, rows: np.ndarray,
                row_to_id: Dict[int, str], neg_inf: float,
                limit: Optional[int] = None,
                lengths: Optional[Sequence[int]] = None
                ) -> List[Tuple[List[str], List[float]]]:
    """Per query: drop NEG_INF sentinels, rows without a live id mapping,
    and repeated rows (a slot reused after delete can appear in both a
    stale IVF member slot and the fresh residual — scores are sorted
    descending, so keeping the first occurrence keeps the best); return
    (ids, scores) pairs. ``limit`` caps each list AFTER dedup — the IVF
    serving path over-fetches k + slack so duplicates can't shrink the
    result below k, then trims back here. ``lengths`` is the RAGGED
    decode bound: the packed readback's per-query live-length
    counter, so a k=4 request in a K-ceiling batch scans 4 columns of its
    row instead of all K (live entries are a sorted prefix — everything
    past a query's own k was masked to NEG_INF on device)."""
    out: List[Tuple[List[str], List[float]]] = []
    for qi in range(scores.shape[0]):
        ids: List[str] = []
        sc: List[float] = []
        seen = set()
        n_cols = scores.shape[1]
        if lengths is not None:
            n_cols = min(n_cols, max(0, int(lengths[qi])))
        for s, r in zip(scores[qi, :n_cols], rows[qi, :n_cols]):
            if limit is not None and len(ids) >= limit:
                break
            if s <= neg_inf / 2:
                continue
            r = int(r)
            if r in seen:
                continue
            seen.add(r)
            node_id = row_to_id.get(r)
            if node_id is not None:
                ids.append(node_id)
                sc.append(float(s))
        out.append((ids, sc))
    return out


def empty_results(n: int) -> List[Tuple[List[str], List[float]]]:
    """n independent ([], []) pairs — NOT `[([], [])] * n`, which aliases
    the same two lists across every entry."""
    return [([], []) for _ in range(n)]


# Column names of the device-counter tail of every fused serving readback
# (bit-cast int32 columns after the fast bit, core.state._pack_retrieval).
RETRIEVAL_COUNTERS = ("live", "dedup_dropped", "acc_boost_rows",
                      "nbr_boost_rows", "semantic")


def unpack_retrieval(host: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray, np.ndarray]:
    """Host half of ``core.state._pack_retrieval``: split the one
    ``[Q, 3 + 2k + 5]`` packed readback into (gate_scores, gate_rows,
    ann_scores, ann_rows, fast, counters). Row and counter columns were
    bit-cast on the device, so the int32 view restores them exactly."""
    ann_s = host[:, 2:2 + k]
    ann_r = np.ascontiguousarray(host[:, 2 + k:2 + 2 * k]).view(np.int32)
    gate_s = host[:, 0]
    gate_r = np.ascontiguousarray(host[:, 1:2]).view(np.int32)[:, 0]
    fast = host[:, 2 + 2 * k] > 0.5
    counters = np.ascontiguousarray(
        host[:, 3 + 2 * k:3 + 2 * k + len(RETRIEVAL_COUNTERS)]
    ).view(np.int32)
    return gate_s, gate_r, ann_s, ann_r, fast, counters


class FlushPolicy:
    """Time/size flush decision shared by ``IngestCoalescer`` (ingest side)
    and ``serve.QueryScheduler`` (query side).

    A batch flushes when it holds ``max_items`` entries OR when its oldest
    entry has waited ``max_wait_s`` — so bursty load coalesces into dense
    device batches while trickle load is never held hostage to a size
    threshold it will not reach. ``max_wait_s <= 0`` means "flush on every
    check" (the eager pre-policy behavior)."""

    def __init__(self, max_items: int, max_wait_s: float):
        self.max_items = max(1, int(max_items))
        self.max_wait_s = float(max_wait_s)
        self._oldest: Optional[float] = None

    def note_add(self, now: float) -> None:
        if self._oldest is None:
            self._oldest = now

    def should_flush(self, n_items: int, now: float,
                     oldest: Optional[float] = None) -> bool:
        """``oldest`` overrides the internally-tracked first-add time —
        callers that pop partial batches (the query scheduler) know the
        true head-of-queue age; callers that drain whole buffers (the
        ingest coalescer) rely on ``note_add``/``reset``."""
        if n_items <= 0:
            return False
        if self.max_wait_s <= 0 or n_items >= self.max_items:
            return True
        if oldest is None:
            oldest = self._oldest
        return oldest is not None and (now - oldest) >= self.max_wait_s

    def wait_remaining(self, now: float,
                       oldest: Optional[float] = None) -> float:
        """Seconds until the oldest entry's deadline (0 when due, an hour
        when empty): the query scheduler's condition-wait timeout."""
        if oldest is None:
            oldest = self._oldest
        if oldest is None:
            return 3600.0
        if self.max_wait_s <= 0:
            return 0.0
        return max(0.0, oldest + self.max_wait_s - now)

    @property
    def oldest(self) -> Optional[float]:
        """First-add time of the current buffer (None when empty) — the
        coalesce-wait telemetry reads it at drain time."""
        return self._oldest

    def reset(self) -> None:
        self._oldest = None


class IngestCoalescer:
    """Cross-conversation ingest batcher.

    Consolidation extracts a fact list per drained conversation; this
    buffer coalesces the lists of EVERY buffered conversation into
    mega-batches of at most ``max_facts`` facts, each ingested as one batch.
    Conversations are kept whole when they fit under ``max_facts`` — the
    cap bounds the padded query batch of the dedup probe and the
    [B, capacity] link-scan tile — and only oversized single conversations
    are split.

    ``drain`` returns ``(facts, n_conversations)`` mega-batches and empties
    the buffer; nothing is ever withheld across a drain.

    With ``max_wait_s > 0`` the coalescer also carries a time/size flush
    policy (``FlushPolicy``): ``should_flush`` stays False while the buffer
    is small AND young, so a steady trickle of single conversations
    accumulates into one dense batch instead of draining one conversation
    at a time. ``max_wait_s = 0`` (default) preserves the eager behavior:
    every check says flush.
    """

    def __init__(self, max_facts: int = 8192, max_wait_s: float = 0.0):
        self.max_facts = max(1, int(max_facts))
        self.policy = FlushPolicy(self.max_facts, max_wait_s)
        self._convs: List[List[dict]] = []

    def add_conversation(self, facts: Sequence[dict],
                         now: Optional[float] = None) -> None:
        if facts:
            import time as _time
            self._convs.append(list(facts))
            self.policy.note_add(now if now is not None else _time.time())

    def should_flush(self, now: Optional[float] = None) -> bool:
        import time as _time
        return self.policy.should_flush(
            len(self), now if now is not None else _time.time())

    def oldest_age_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest buffered conversation (0.0 when empty) — the
        per-mega-batch coalesce-wait the ingest telemetry records at drain
        time (the write-path twin of the serving queue-wait span)."""
        import time as _time
        oldest = self.policy.oldest
        if oldest is None:
            return 0.0
        return max(0.0, (now if now is not None else _time.time()) - oldest)

    def __len__(self) -> int:
        return sum(len(c) for c in self._convs)

    @property
    def pending_conversations(self) -> int:
        return len(self._convs)

    def requeue(self, batches: Sequence[Tuple[Sequence[dict], int]],
                now: Optional[float] = None) -> None:
        """Put drained-but-not-ingested mega-batches BACK at the front of
        the buffer: an ingest dispatch failure must not lose
        the facts the drain already popped — they retry on the next
        flush, ahead of anything buffered since, and the durable ingest
        journal keeps them crash-safe meanwhile."""
        if not batches:
            return
        import time as _time
        self._convs = [list(facts) for facts, _ in batches
                       if facts] + self._convs
        if self._convs:
            self.policy.note_add(now if now is not None else _time.time())

    def drain(self) -> List[Tuple[List[dict], int]]:
        batches: List[Tuple[List[dict], int]] = []
        batch: List[dict] = []
        n_convs = 0
        convs, self._convs = self._convs, []
        self.policy.reset()
        for conv in convs:
            while len(conv) > self.max_facts:          # oversized: split
                if batch:
                    batches.append((batch, n_convs))
                    batch, n_convs = [], 0
                batches.append((conv[:self.max_facts], 1))
                conv = conv[self.max_facts:]
            if batch and len(batch) + len(conv) > self.max_facts:
                batches.append((batch, n_convs))
                batch, n_convs = [], 0
            if conv:
                batch = batch + conv
                n_convs += 1
        if batch:
            batches.append((batch, n_convs))
        return batches
