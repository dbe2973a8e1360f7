"""Named fault-injection points for the recovery tests
(``lazzaro_tpu/reliability/faults.py``).

Production code calls :func:`fire` at a handful of *named* points, the
places where the failure model says a crash hurts most. When nothing is
armed (always, in production) ``fire`` is one attribute load and a falsy
check; when a test arms a point, the next ``fire`` there runs the plan's
hook (e.g. truncate a checkpoint file) and/or raises, a bounded number of
times.

Injection points of the port (grep for ``faults.fire`` to find the sites):

====================  =====================================================
``index.dispatch``    inside the state dispatch guard
                      (``reliability.guard.run_guarded``), per attempt,
                      just before the program runs
``scheduler.worker``  QueryScheduler worker loop, after batch admission,
                      outside the demuxed executor try — a raise here is a
                      worker-thread death, not an executor error
``ingest.worker``     MemorySystem._consolidate_once, between the ingest
                      journal's append and the fused ingest dispatches
``checkpoint.torn``   core.checkpoint._write_versioned, after the CURRENT
                      flip — the hook corrupts the committed payload to
                      model a torn write the filesystem lied about
====================  =====================================================

The JAX package's other points (``plan.oom``, ``pump.mid_chunk``,
``coldstore.read``, ``replica.mid_replay``) sit in code the port does not
have yet (ROADMAP Queue 1 items 19, 17 and 21).

Arming is process-global (the injected sites live on background threads),
guarded by a lock, and always bounded: a plan fires ``times`` times then
disarms itself, so a forgotten ``armed()`` context can never wedge a
suite. The injected exception defaults to :class:`InjectedFault` so tests
can assert the failure they see is *theirs*.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional

from lazzaro_tpu_torch.reliability.errors import ReliabilityError


class InjectedFault(ReliabilityError):
    """Default exception raised at an armed injection point."""


class _Plan:
    __slots__ = ("point", "times", "exc", "hook", "fired")

    def __init__(self, point: str, times: int,
                 exc: Optional[Callable[[], BaseException]],
                 hook: Optional[Callable[[dict], None]]):
        self.point = point
        self.times = int(times)
        self.exc = exc
        self.hook = hook
        self.fired = 0


class FaultInjector:
    """Registry of armed fault plans (one per point)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: Dict[str, _Plan] = {}
        self._fired: Dict[str, int] = {}
        # Read without the lock: the disarmed cost of fire() is one falsy
        # check.
        self.active = False

    def arm(self, point: str, times: int = 1, *,
            exc: Optional[Callable[[], BaseException]] = InjectedFault,
            hook: Optional[Callable[[dict], None]] = None) -> None:
        """Arm ``point`` to fail the next ``times`` visits. ``exc=None``
        makes the fault silent (hook-only — e.g. corrupt a file and let
        the caller believe the write succeeded)."""
        with self._lock:
            self._plans[point] = _Plan(point, times, exc, hook)
            self.active = True

    def disarm(self, point: str) -> None:
        with self._lock:
            self._plans.pop(point, None)
            self.active = bool(self._plans)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._fired.clear()
            self.active = False

    def fired(self, point: str) -> int:
        """How many times ``point`` actually fired (survives disarm)."""
        with self._lock:
            return self._fired.get(point, 0)

    def fire(self, point: str, **ctx) -> None:
        """Called by production code at a named injection point. No-op
        unless the point is armed; otherwise runs the hook and raises the
        planned exception (``times``-bounded)."""
        if not self.active:
            return
        with self._lock:
            plan = self._plans.get(point)
            if plan is None or plan.times <= 0:
                return
            plan.times -= 1
            plan.fired += 1
            self._fired[point] = self._fired.get(point, 0) + 1
            if plan.times <= 0:
                self._plans.pop(point, None)
                self.active = bool(self._plans)
            hook, exc = plan.hook, plan.exc
        # hook and raise outside the lock: hooks touch files
        if hook is not None:
            hook(ctx)
        if exc is not None:
            raise exc()

    @contextmanager
    def armed(self, point: str, times: int = 1, *,
              exc: Optional[Callable[[], BaseException]] = InjectedFault,
              hook: Optional[Callable[[dict], None]] = None):
        """Scoped arming; always disarms on exit."""
        self.arm(point, times, exc=exc, hook=hook)
        try:
            yield self
        finally:
            self.disarm(point)


# Process-wide injector: the injected sites run on background threads, so
# the registry is shared.
INJECTOR = FaultInjector()


def fire(point: str, **ctx) -> None:
    """Module-level fast path (the one production sites call)."""
    if INJECTOR.active:
        INJECTOR.fire(point, **ctx)


def oom_error() -> BaseException:
    """Exception factory for arming ``index.dispatch``: a plain RuntimeError
    carrying the allocator's RESOURCE_EXHAUSTED marker, so
    ``guard.is_resource_exhausted`` classifies it as a real device
    allocation failure."""
    return RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory allocating 1073741824 bytes "
        "(injected by reliability.faults.oom_error)")


def poison_states_hook(ctx: dict) -> None:
    """Hook for ``index.dispatch``: mark the dispatch's states written before
    the raise, so the failure models a program that died after its first
    in-place write (the poisoned-arena case)."""
    for st in ctx.get("states", ()):
        for s in (st if isinstance(st, (list, tuple)) else (st,)):
            if s is not None:
                s.written = True


def torn_write_hook(keep_bytes: int = 256) -> Callable[[dict], None]:
    """Hook factory for ``checkpoint.torn``: truncate the committed
    ``arrays.npz`` to ``keep_bytes`` — the classic torn write (CURRENT
    points at the version, the payload is garbage)."""
    def _hook(ctx: dict) -> None:
        path = os.path.join(ctx["dir"], "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(min(keep_bytes, size))
    return _hook
