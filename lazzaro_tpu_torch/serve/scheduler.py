"""Cross-request query batching for the fused retrieval kernel.

Counterpart of ``lazzaro_tpu/serve/scheduler.py`` (``RetrievalRequest``,
``RetrievalResult``, ``QueryScheduler``). Callers ``submit()`` requests and
block on futures; one worker thread pops pending requests, runs the
``executor`` on them as one batch (``MemoryIndex.search_fused_requests``: one
kernel launch and one packed readback) and demuxes the results in order.
Per-request tenants ride into the kernel as a device column, so one batch
serves many tenants.

Batching: **continuous** (default) admits pending requests the moment the
worker is free, so a lone request on an idle scheduler ships at once and
arrivals during a dispatch ride the next one; with a tenant cap
(``tenant_max_inflight``) at most that many requests of one tenant enter a
batch, oldest first, and the rest keep their place. **Flush-boundary**
(``continuous=False``) ships when ``max_batch`` requests wait or the oldest
has waited ``max_wait_us``.

Failure model: a future resolves with a result or a typed error, never
hangs. An executor exception fails that batch's futures and counts a
breaker failure; a worker death elsewhere fails the batch with
:class:`WorkerCrashed` and the worker restarts; a dispatch deadline
(``dispatch_timeout_s``) fails the batch with :class:`DispatchTimeout` and
discards the late result; consecutive failures open the circuit breaker,
under which batches run degraded (per-request ``cap_take`` clamped); an
over-full queue (``shed_depth``/``shed_bytes``) fails new submissions at
once with :class:`LoadShed`.

The worker launches CUDA work, so it runs under ``torch.cuda.device`` of
the scheduler's ``device``, the index's device.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lazzaro_tpu_torch.reliability import faults
from lazzaro_tpu_torch.reliability.errors import (DispatchTimeout, LoadShed,
                                                  WorkerCrashed)
from lazzaro_tpu_torch.reliability.watchdog import CircuitBreaker
from lazzaro_tpu_torch.utils.batching import FlushPolicy
from lazzaro_tpu_torch.utils.telemetry import default_registry

logger = logging.getLogger("lazzaro_tpu_torch.serve")


@dataclass
class RetrievalRequest:
    """One query's chat-turn retrieval. ``boost=True`` asks the device to
    apply the access boost to the returned rows and the neighbor boost to
    their CSR neighbors in the same dispatch (chat); ``boost=False`` is a
    pure read (``search_memories``). ``gate_enabled`` turns the super-node
    top-1 gate on. ``cap_take`` is a per-request knob (None: the index's
    default)."""

    query: np.ndarray
    tenant: str
    k: int = 10
    gate_enabled: bool = False
    boost: bool = False
    cap_take: Optional[int] = None


@dataclass
class RetrievalResult:
    ids: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    gate_id: Optional[str] = None
    gate_score: float = float("-inf")
    fast: bool = False          # device gate verdict (gate_enabled & > gate)
    boosted: bool = False       # device applied this query's boosts


Executor = Callable[[List[RetrievalRequest]], List[RetrievalResult]]


def _fail_future(fut: Future, err: BaseException) -> None:
    """Set an exception, tolerating a future that already resolved (the
    watchdog and a late dispatch race by design)."""
    if fut.cancelled():
        return
    try:
        fut.set_exception(err)
    except InvalidStateError:
        pass


def _set_future(fut: Future, res) -> None:
    if fut.cancelled():
        return
    try:
        fut.set_result(res)
    except InvalidStateError:
        pass            # the watchdog already failed it: late result dropped


class QueryScheduler:
    """Coalesce concurrent retrievals into batches for one executor."""

    def __init__(self, executor: Executor, max_batch: int = 64,
                 max_wait_us: int = 2000, name: str = "lz-query-scheduler",
                 telemetry=None, continuous: bool = True,
                 tenant_max_inflight: int = 0,
                 dispatch_timeout_s: float = 0.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 shed_depth: int = 0, shed_bytes: int = 0,
                 degrade_cap_take: int = 1, device=None):
        self._executor = executor
        self.telemetry = telemetry if telemetry is not None \
            else default_registry()
        self.policy = FlushPolicy(max_batch, max_wait_us / 1e6)
        self.continuous = bool(continuous)
        self.tenant_max_inflight = max(0, int(tenant_max_inflight))
        self.dispatch_timeout_s = max(0.0, float(dispatch_timeout_s))
        self.shed_depth = max(0, int(shed_depth))
        self.shed_bytes = max(0, int(shed_bytes))
        self.degrade_cap_take = max(1, int(degrade_cap_take))
        self.device = torch.device(device) if device is not None else None
        self.breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(breaker_threshold, breaker_cooldown_s,
                           telemetry=self.telemetry, name=name)
            if breaker_threshold > 0 else None)
        self._cond = threading.Condition()
        self._pending: List[Tuple[RetrievalRequest, Future, float]] = []
        self._pending_bytes = 0
        self._inflight = 0
        self._closed = False
        self.batches_flushed = 0
        self.requests_served = 0
        self.requests_deferred = 0           # tenant-cap admission defers
        self.requests_shed = 0               # admission-control rejections
        self.worker_restarts = 0
        self.watchdog_timeouts = 0
        self.batch_sizes: List[int] = []
        self._name = name
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._worker.start()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------- submit
    def submit(self, request: RetrievalRequest) -> "Future[RetrievalResult]":
        return self.submit_many([request])[0]

    def submit_many(self, requests: Sequence[RetrievalRequest]
                    ) -> List["Future[RetrievalResult]"]:
        """Enqueue a group atomically (a ``search_memories_batch`` fleet
        stays contiguous). Under admission overload every future of the
        group fails at once with :class:`LoadShed`."""
        futures = [Future() for _ in requests]
        now = time.time()
        nbytes = (sum(np.asarray(r.query).nbytes for r in requests)
                  if self.shed_bytes else 0)
        with self._cond:
            if self._closed:
                raise RuntimeError("QueryScheduler is closed")
            over_depth = (self.shed_depth and
                          len(self._pending) + len(requests) > self.shed_depth)
            over_bytes = (self.shed_bytes and
                          self._pending_bytes + nbytes > self.shed_bytes)
            if over_depth or over_bytes:
                self.requests_shed += len(requests)
                self.telemetry.bump("reliability.load_shed", len(requests))
                reason = "depth" if over_depth else "bytes"
                err = LoadShed(
                    f"admission queue over {reason} budget "
                    f"({len(self._pending)} pending); retry with backoff")
                for fut in futures:
                    _fail_future(fut, err)
                return futures
            for req, fut in zip(requests, futures):
                self._pending.append((req, fut, now))
            self._pending_bytes += nbytes
            self._ensure_worker_locked()
            self._cond.notify()
        return futures

    def _ensure_worker_locked(self) -> None:
        """Respawn the worker if it is gone, so no future sits unserved."""
        if self._closed or self._worker.is_alive():
            return
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=self._name)
        self._worker.start()

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        """Crash-restarting wrapper around the serve loop; only a clean
        close exits. CUDA work launches on the scheduler's device."""
        while True:
            try:
                if self.device is not None and self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        self._serve_loop()
                else:
                    self._serve_loop()
                return
            except BaseException:       # noqa: BLE001 — must not die silent
                logger.exception("query-scheduler worker crashed; restarting")
                self.worker_restarts += 1
                self.telemetry.bump("reliability.worker_restarts",
                                    labels={"actor": "query_scheduler"})
                with self._cond:
                    if self._closed and not self._pending:
                        return
                time.sleep(0.005)       # never spin on a persistent fault

    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.time()
                    oldest = self._pending[0][2] if self._pending else None
                    if self._pending and (
                            self._closed or self.continuous
                            or self.policy.should_flush(len(self._pending),
                                                        now, oldest)):
                        break
                    if self._closed:
                        return
                    timeout = (self.policy.wait_remaining(now, oldest)
                               if self._pending else None)
                    self._cond.wait(timeout)
                batch = self._admit_locked()
                self._inflight += 1
            try:
                # Fault point "scheduler.worker": a raise here models the
                # worker dying outside the demuxed executor call.
                try:
                    faults.fire("scheduler.worker", batch=len(batch))
                    self._execute(batch)
                except BaseException as e:
                    err = WorkerCrashed(
                        f"query-scheduler worker died mid-batch: {e!r}")
                    for _, fut, _ in batch:
                        _fail_future(fut, err)
                    raise
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _admit_locked(self) -> List[Tuple[RetrievalRequest, Future, float]]:
        """Pop the next batch, oldest first, at most ``max_batch``; with a
        tenant cap at most ``tenant_max_inflight`` per tenant, over-cap
        requests keeping their queue position."""
        limit = self.policy.max_items
        cap = self.tenant_max_inflight
        if not cap:
            batch = self._pending[:limit]
            del self._pending[:len(batch)]
            self._note_admitted_locked(batch)
            return batch
        batch: List[Tuple[RetrievalRequest, Future, float]] = []
        kept: List[Tuple[RetrievalRequest, Future, float]] = []
        counts: dict = {}
        deferred = 0
        for item in self._pending:
            tenant = item[0].tenant
            if len(batch) < limit and counts.get(tenant, 0) < cap:
                batch.append(item)
                counts[tenant] = counts.get(tenant, 0) + 1
            else:
                kept.append(item)
                if len(batch) < limit:
                    deferred += 1        # capped out, not batch-full
        self._pending = kept
        self._note_admitted_locked(batch)
        if deferred:
            self.requests_deferred += deferred
            self.telemetry.bump("serve.admission_deferred", deferred)
        return batch

    def _note_admitted_locked(self, batch) -> None:
        if self.shed_bytes and batch:
            self._pending_bytes = max(
                0, self._pending_bytes
                - sum(np.asarray(req.query).nbytes for req, _, _ in batch))

    def _degrade(self, req: RetrievalRequest) -> RetrievalRequest:
        """The breaker's cheap rung: a copy of the request with a smaller
        ``cap_take`` (same k results, fewer rows boosted)."""
        cap = (self.degrade_cap_take if req.cap_take is None
               else min(req.cap_take, self.degrade_cap_take))
        return dataclasses.replace(req, cap_take=cap)

    def _execute(self, batch) -> None:
        reqs = [req for req, _, _ in batch]
        flush_t = time.time()
        for req, _, enq in batch:
            self.telemetry.record("serve.queue_wait_ms",
                                  (flush_t - enq) * 1e3,
                                  labels={"tenant": req.tenant})
        if self.breaker is not None and self.breaker.degraded(flush_t):
            reqs = [self._degrade(r) for r in reqs]
            self.telemetry.bump("reliability.degraded_requests", len(reqs))
        timer = None
        timed_out = threading.Event()
        if self.dispatch_timeout_s > 0:
            def _deadline():
                timed_out.set()
                self.watchdog_timeouts += 1
                self.telemetry.bump("reliability.watchdog_timeouts")
                if self.breaker is not None:
                    self.breaker.record_failure()
                err = DispatchTimeout(
                    f"dispatch exceeded the {self.dispatch_timeout_s:.3f}s "
                    f"watchdog deadline (batch of {len(batch)})")
                for _, fut, _ in batch:
                    _fail_future(fut, err)
            timer = threading.Timer(self.dispatch_timeout_s, _deadline)
            timer.daemon = True
            timer.start()
        try:
            # one batch is one profiler range, so traces line up with it
            with torch.profiler.record_function("lz.serve.batch"):
                results = self._executor(reqs)
        except Exception as e:                      # noqa: BLE001 — demuxed
            if timer is not None:
                timer.cancel()
            if self.breaker is not None:
                self.breaker.record_failure()
            for _, fut, _ in batch:
                _fail_future(fut, e)
            return
        if timer is not None:
            timer.cancel()
        if timed_out.is_set():
            return          # the watchdog already failed these futures
        if self.breaker is not None:
            self.breaker.record_success()
        self.batches_flushed += 1
        self.requests_served += len(batch)
        self.telemetry.bump("serve.requests", len(batch))
        self.telemetry.bump("serve.batches")
        self.telemetry.record("serve.batch_requests", len(batch))
        self.batch_sizes.append(len(batch))
        if len(self.batch_sizes) > 1024:
            del self.batch_sizes[:512]
        for (_, fut, _), res in zip(batch, results):
            _set_future(fut, res)

    def load(self) -> int:
        """Queue depth plus in-flight dispatches."""
        with self._cond:
            return len(self._pending) + self._inflight

    # ----------------------------------------------------------- lifecycle
    def flush(self, timeout: float = 30.0) -> None:
        """Block until everything submitted so far has been executed."""
        deadline = time.time() + timeout
        with self._cond:
            self._cond.notify()
            while self._pending or self._inflight:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError("QueryScheduler.flush timed out")
                self._cond.wait(min(remaining, 0.05))

    def close(self) -> None:
        """Serve what is pending, then stop the worker."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=30.0)

    def stats(self) -> dict:
        with self._cond:
            sizes = list(self.batch_sizes)
            return {
                "batches_flushed": self.batches_flushed,
                "requests_served": self.requests_served,
                "requests_deferred": self.requests_deferred,
                "requests_shed": self.requests_shed,
                "worker_restarts": self.worker_restarts,
                "watchdog_timeouts": self.watchdog_timeouts,
                "breaker": (self.breaker.stats()
                            if self.breaker is not None else None),
                "continuous": self.continuous,
                "pending": len(self._pending),
                "mean_batch": (round(float(np.mean(sizes)), 2)
                               if sizes else None),
                "max_batch_seen": max(sizes) if sizes else None,
            }
