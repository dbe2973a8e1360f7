"""Circuit breaker of the serving path (``lazzaro_tpu/reliability/
watchdog.py:CircuitBreaker``).

CLOSED: batches run at full quality. ``threshold`` consecutive failures or
timeouts open it; while OPEN (for ``cooldown_s``) every batch runs degraded;
then one HALF_OPEN probe at full quality closes it again on success or
reopens it on failure.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, threshold: int = 5, cooldown_s: float = 5.0,
                 telemetry=None, name: str = "serve"):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.telemetry = telemetry
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opens = 0

    def _gauge(self) -> None:
        if self.telemetry is not None:
            self.telemetry.gauge("reliability.breaker_state",
                                 _STATE_CODE[self._state],
                                 labels={"name": self.name})

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def degraded(self, now: Optional[float] = None) -> bool:
        """Should the next batch run degraded? OPEN inside the cooldown:
        yes; cooldown over: HALF_OPEN, probe at full quality."""
        now = time.time() if now is None else now
        with self._lock:
            if self._state == OPEN:
                if now - self._opened_at >= self.cooldown_s:
                    self._state = HALF_OPEN
                    self._gauge()
                    return False
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != CLOSED:
                self._state = CLOSED
                self._gauge()

    def record_failure(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.threshold:
                if self._state != OPEN:
                    self.opens += 1
                    if self.telemetry is not None:
                        self.telemetry.bump("reliability.breaker_opens",
                                            labels={"name": self.name})
                self._state = OPEN
                self._opened_at = now
                self._failures = 0
                self._gauge()

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state, "opens": self.opens,
                    "consecutive_failures": self._failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s}
