"""The port's query scheduler (``lazzaro_tpu_torch.serve``) and the shared
time/size flush policy, host-only: the port's versions of
``tests/test_query_scheduler.py`` (flush policy, demux, coalescing, errors,
close, flush barrier, ingest deferral in ``MemorySystem``) and of the
continuous-batching tests of ``tests/test_ragged_serving.py`` (a lone
request ships at once, arrivals ride the next dispatch, the per-tenant
admission cap). Every check is of counts, order and timing bounds, with no
numeric tolerance.
"""

import tempfile
import threading
import time

import numpy as np
import pytest

from lazzaro_tpu_torch import MemoryConfig, MemorySystem
from lazzaro_tpu_torch.serve import (QueryScheduler, RetrievalRequest,
                                     RetrievalResult)
from lazzaro_tpu_torch.utils.batching import FlushPolicy, IngestCoalescer
from tests.test_fused_ingest import ClusteredEmb, QueueLLM


# ------------------------------------------------------------- FlushPolicy
def test_flush_policy_size_and_time():
    p = FlushPolicy(max_items=4, max_wait_s=10.0)
    t0 = 1000.0
    p.note_add(t0)
    assert not p.should_flush(1, t0 + 1)          # small AND young: wait
    assert p.should_flush(4, t0 + 1)              # size threshold
    assert p.should_flush(1, t0 + 10.0)           # age threshold
    assert p.wait_remaining(t0 + 4) == pytest.approx(6.0)
    p.reset()
    assert p.wait_remaining(t0) == 3600.0         # empty: park the worker
    # explicit oldest overrides the internal tracker (scheduler pops
    # partial batches, so head-of-queue age is the caller's truth)
    assert p.should_flush(1, t0 + 3, oldest=t0 - 8)


def test_flush_policy_eager_mode():
    p = FlushPolicy(max_items=100, max_wait_s=0.0)
    p.note_add(0.0)
    assert p.should_flush(1, 0.0)                 # wait<=0: always flush
    assert not p.should_flush(0, 0.0)             # ...except when empty


def test_coalescer_time_policy():
    c = IngestCoalescer(max_facts=100, max_wait_s=30.0)
    t0 = 2000.0
    c.add_conversation([{"content": "a"}], now=t0)
    assert not c.should_flush(now=t0 + 1)          # trickle: hold
    assert c.should_flush(now=t0 + 31)             # aged out: ship
    for i in range(100):
        c.add_conversation([{"content": f"b{i}"}], now=t0 + 2)
    assert c.should_flush(now=t0 + 2)              # full: ship now
    c.drain()
    c.add_conversation([{"content": "c"}], now=t0 + 60)
    # drain reset the clock: the new lone fact is young again
    assert not c.should_flush(now=t0 + 61)


# ---------------------------------------------------------- QueryScheduler
def _echo_executor(reqs):
    out = []
    for r in reqs:
        res = RetrievalResult()
        res.ids = [f"{r.tenant}:{int(r.query[0])}"]
        res.scores = [1.0]
        out.append(res)
    return out


def test_scheduler_demuxes_in_order():
    s = QueryScheduler(_echo_executor, max_batch=8, max_wait_us=1000)
    try:
        reqs = [RetrievalRequest(query=np.asarray([i], np.float32),
                                 tenant="u") for i in range(20)]
        futures = s.submit_many(reqs)
        got = [f.result(timeout=10).ids[0] for f in futures]
        assert got == [f"u:{i}" for i in range(20)]
        stats = s.stats()
        assert stats["requests_served"] == 20
        # max_batch=8 bounds every flush
        assert stats["max_batch_seen"] <= 8
    finally:
        s.close()


def test_scheduler_coalesces_while_executor_busy():
    """Requests arriving while a flush is in flight pile up and ship as one
    dense batch — the core amortization claim."""
    release = threading.Event()
    batches = []

    def slow_executor(reqs):
        batches.append(len(reqs))
        if len(batches) == 1:
            release.wait(timeout=10)
        return _echo_executor(reqs)

    s = QueryScheduler(slow_executor, max_batch=64, max_wait_us=500)
    try:
        first = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                          tenant="u"))
        time.sleep(0.05)                       # worker is now blocked
        rest = s.submit_many([
            RetrievalRequest(query=np.asarray([i], np.float32), tenant="u")
            for i in range(10)])
        release.set()
        first.result(timeout=10)
        for f in rest:
            f.result(timeout=10)
        assert batches[0] == 1
        assert batches[1] == 10                # coalesced into ONE batch
    finally:
        s.close()


def test_scheduler_propagates_executor_errors():
    def boom(reqs):
        raise RuntimeError("kernel exploded")

    s = QueryScheduler(boom, max_batch=4, max_wait_us=100)
    try:
        f = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                      tenant="u"))
        with pytest.raises(RuntimeError, match="kernel exploded"):
            f.result(timeout=10)
    finally:
        s.close()


def test_scheduler_close_drains_then_rejects():
    s = QueryScheduler(_echo_executor, max_batch=4, max_wait_us=50_000)
    futures = s.submit_many([
        RetrievalRequest(query=np.asarray([i], np.float32), tenant="u")
        for i in range(3)])
    s.close()                                  # drains pending before exit
    assert [f.result(timeout=1).ids[0] for f in futures] == \
        ["u:0", "u:1", "u:2"]
    assert s.closed
    with pytest.raises(RuntimeError):
        s.submit(RetrievalRequest(query=np.zeros(1, np.float32), tenant="u"))


def test_scheduler_flush_barrier():
    s = QueryScheduler(_echo_executor, max_batch=64, max_wait_us=200_000)
    try:
        futures = s.submit_many([
            RetrievalRequest(query=np.asarray([i], np.float32), tenant="u")
            for i in range(5)])
        s.flush(timeout=10)                    # beats the 200 ms wait
        assert all(f.done() for f in futures)
    finally:
        s.close()


# ----------------------------------------- ingest deferral (MemorySystem)
def _system(tmp, wait_s):
    ms = MemorySystem(
        enable_async=False, db_dir=tmp, verbose=False, load_from_disk=False,
        llm_provider=QueueLLM(6), embedding_provider=ClusteredEmb(),
        auto_prune=False, max_buffer_size=10_000, device="cpu",
        config=MemoryConfig(decay_rate=0.0, ingest_flush_wait_s=wait_s))
    return ms


def test_trickle_ingest_defers_then_coalesces():
    """With ingest_flush_wait_s > 0 a lone conversation's facts wait in the
    coalescer instead of draining immediately; the next
    consolidation inside the window lands BOTH conversations in one
    mega-batch; close() force-drains whatever remains."""
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp, wait_s=3600.0)
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 0            # deferred, not ingested
        assert len(ms._ingest_coalescer) == 6
        assert ms._deferred_batches                # held, not dropped
        # aging past the window flushes on the next consolidation
        ms._ingest_coalescer.policy._oldest -= 7200.0
        ms.start_conversation()
        ms.add_to_short_term("conv 1", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 12           # both conversations
        assert len(ms._ingest_coalescer) == 0
        assert not ms._deferred_batches
        ms.close()


def test_close_force_drains_deferred_facts():
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp, wait_s=3600.0)
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 0
        ms.close()                                 # force-drain
        assert ms.buffer.size()[0] == 6


def test_eager_default_preserves_behavior():
    with tempfile.TemporaryDirectory() as tmp:
        ms = _system(tmp, wait_s=0.0)
        ms.start_conversation()
        ms.add_to_short_term("conv 0", "episodic", 0.7)
        ms.end_conversation()
        assert ms.buffer.size()[0] == 6            # ingested immediately
        ms.close()


# --------------------------------------------------- continuous batching
def test_lone_request_dispatches_immediately():
    """A single request on an idle continuous scheduler must NOT wait the
    flush timeout — latency is the dispatch time, not ``serve_flush_us``."""
    def echo(reqs):
        return [RetrievalResult(ids=["x"], scores=[1.0]) for _ in reqs]

    flush_s = 0.5
    s = QueryScheduler(echo, max_batch=64, max_wait_us=int(flush_s * 1e6),
                       continuous=True)
    try:
        t0 = time.perf_counter()
        fut = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                        tenant="u"))
        fut.result(timeout=10)
        elapsed = time.perf_counter() - t0
        assert elapsed < flush_s / 2, (
            f"lone request waited {elapsed:.3f}s — flush-boundary latency "
            f"leaked into the continuous scheduler")
    finally:
        s.close()


def test_flush_boundary_mode_still_waits():
    """The A/B control: with continuous OFF, a lone request is held until
    the flush window closes (the flush-boundary policy)."""
    def echo(reqs):
        return [RetrievalResult(ids=["x"], scores=[1.0]) for _ in reqs]

    flush_s = 0.3
    s = QueryScheduler(echo, max_batch=64, max_wait_us=int(flush_s * 1e6),
                       continuous=False)
    try:
        t0 = time.perf_counter()
        fut = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                        tenant="u"))
        fut.result(timeout=10)
        assert time.perf_counter() - t0 >= flush_s * 0.8
    finally:
        s.close()


def test_continuous_admits_arrivals_into_next_dispatch():
    """Requests arriving while a dispatch is in flight admit into the NEXT
    dispatch as one dense batch (the in-flight dispatch is the batching
    window — no timer involved)."""
    release = threading.Event()
    batches = []

    def blocking(reqs):
        batches.append(len(reqs))
        if len(batches) == 1:
            release.wait(timeout=10)
        return [RetrievalResult(ids=["x"], scores=[1.0]) for _ in reqs]

    s = QueryScheduler(blocking, max_batch=64, max_wait_us=10_000_000,
                       continuous=True)
    try:
        first = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                          tenant="u"))
        time.sleep(0.05)
        rest = s.submit_many([
            RetrievalRequest(query=np.zeros(1, np.float32), tenant="u")
            for _ in range(9)])
        release.set()
        first.result(timeout=10)
        for f in rest:
            f.result(timeout=10)
        assert batches == [1, 9]
    finally:
        s.close()


def test_tenant_admission_cap_with_oldest_first_fairness():
    """Per-tenant admission control: a flooding tenant is capped per
    dispatch; deferred requests keep their queue position and ship in the
    following dispatches (every future still completes)."""
    release = threading.Event()
    batches = []

    def executor(reqs):
        batches.append([r.tenant for r in reqs])
        if len(batches) == 1:
            release.wait(timeout=10)
        return [RetrievalResult(ids=[r.tenant], scores=[1.0])
                for r in reqs]

    s = QueryScheduler(executor, max_batch=8, max_wait_us=500,
                       continuous=True, tenant_max_inflight=2)
    try:
        first = s.submit(RetrievalRequest(query=np.zeros(1, np.float32),
                                          tenant="warm"))
        time.sleep(0.05)
        flood = s.submit_many([
            RetrievalRequest(query=np.zeros(1, np.float32), tenant="hog")
            for _ in range(6)])
        trickle = s.submit_many([
            RetrievalRequest(query=np.zeros(1, np.float32), tenant="small")
            for _ in range(2)])
        release.set()
        for f in [first] + flood + trickle:
            f.result(timeout=10)
        # no post-warmup batch carries more than 2 of the flooding tenant,
        # and the small tenant rode the FIRST post-warmup dispatch (it was
        # not starved behind the hog's queue depth)
        for b in batches[1:]:
            assert b.count("hog") <= 2
        assert "small" in batches[1]
        assert s.requests_deferred > 0
        assert sum(len(b) for b in batches) == 9
    finally:
        s.close()
