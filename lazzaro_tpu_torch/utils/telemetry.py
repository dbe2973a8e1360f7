"""Metrics registry of the port: the subset of ``lazzaro_tpu/utils/telemetry.py``
that the classic and fused serving paths record into.

- **timers**: ring-buffered latency samples (``record``), e.g. chat
  retrieval and consolidation wall time;
- **counters**: monotonic totals (``bump``), e.g. ingest failures;
- **gauges**: last-value observations (``gauge``).

Names may carry labels; the (name, labels) pair canonicalizes to one key in
Prometheus sample syntax, and label sets are clamped per metric so a tenant
explosion folds into one ``"~other"`` series. Thread-safe; ``MemorySystem``
owns one instance.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Deque, Dict, Optional

import numpy as np

MAX_LABEL_SETS = 256


def _fmt_labels(labels: Dict[str, object]) -> str:
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


def split_key(key: str):
    """``name{k="v",...}`` -> (name, label_str)."""
    i = key.find("{")
    if i < 0:
        return key, ""
    return key[:i], key[i:]


class Telemetry:
    def __init__(self, window: int = 10_000, enabled: bool = True):
        self.enabled = bool(enabled)
        self.window = window
        self._lock = threading.Lock()
        self.timers: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self._series_per_name: Dict[str, int] = defaultdict(int)
        self._known_keys = set()

    def _key(self, name: str, labels: Optional[Dict] = None) -> str:
        if not labels:
            return name
        key = name + _fmt_labels(labels)
        with self._lock:
            if key not in self._known_keys:
                if self._series_per_name[name] >= MAX_LABEL_SETS:
                    return name + _fmt_labels({k: "~other" for k in labels})
                self._series_per_name[name] += 1
                self._known_keys.add(key)
        return key

    def record(self, name: str, value_ms: float,
               labels: Optional[Dict] = None) -> None:
        if not self.enabled:
            return
        self.timers[self._key(name, labels)].append(float(value_ms))

    def bump(self, name: str, n: int = 1,
             labels: Optional[Dict] = None) -> None:
        if n == 0 or not self.enabled:
            return
        key = self._key(name, labels)
        with self._lock:
            self.counters[key] += int(n)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict] = None) -> None:
        if not self.enabled:
            return
        self.gauges[self._key(name, labels)] = float(value)

    @contextmanager
    def span(self, name: str, labels: Optional[Dict] = None):
        """Record the wall time of the ``with`` body as a timer sample."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e3, labels)

    def counter_total(self, name: str) -> int:
        """Sum of a counter across every label set."""
        with self._lock:
            return sum(v for k, v in self.counters.items()
                       if split_key(k)[0] == name)

    def timer_values(self, name: str) -> list:
        """All ring-buffered samples of a timer across every label set."""
        out: list = []
        for k, v in list(self.timers.items()):
            if split_key(k)[0] == name:
                out.extend(v)
        return out

    @staticmethod
    def tier(latency_ms: float) -> str:
        """The reference's emoji latency tiers (memory_system.py:332-337)."""
        return "⚡" if latency_ms < 100 else ("✓" if latency_ms < 200 else "⏱")


# The process-wide default registry: components built on their own (a bare
# MemoryIndex, a QueryScheduler in a test) record here; MemorySystem passes
# its own instance to everything it owns.
REGISTRY = Telemetry()


def default_registry() -> Telemetry:
    return REGISTRY


def record_device_counters(tel: Telemetry, counters, fast, gate_on, valid,
                           k_req) -> None:
    """Fold one fused readback's device-counter tail into the registry
    (``lazzaro_tpu/utils/telemetry.py:record_device_counters`` without the
    semantic cache). ``counters`` is the ``[Q, 5]`` int32 tail of
    ``utils.batching.unpack_retrieval`` (live, dedup, acc-boost rows,
    nbr-boost rows, semantic), ``fast`` the gate verdicts, ``gate_on`` and
    ``valid`` the per-query flags, ``k_req`` each request's own k (the
    top-k shortfall counts against it)."""
    v = np.asarray(valid, bool)
    if not v.any():
        return
    live = np.asarray(counters[:, 0])[v]
    want = np.asarray(k_req)[v]
    g_on = np.asarray(gate_on, bool)[v]
    f = np.asarray(fast, bool)[v]
    tel.bump("device.gate_hit", int((g_on & f).sum()))
    tel.bump("device.gate_miss", int((g_on & ~f).sum()))
    tel.bump("device.topk_shortfall", int(np.maximum(want - live, 0).sum()))
    tel.bump("device.dedup_hits", int(counters[:, 1][v].sum()))
    tel.bump("device.boost_rows", int(counters[:, 2][v].sum()))
    tel.bump("device.nbr_boost_rows", int(counters[:, 3][v].sum()))
