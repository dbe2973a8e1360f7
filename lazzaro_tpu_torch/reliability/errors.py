"""Typed failures of the serving path, the subset of
``lazzaro_tpu/reliability/errors.py`` that the query scheduler raises: a
request future resolves with a result or one of these, never by hanging."""

from __future__ import annotations


class ReliabilityError(RuntimeError):
    """Base class for every typed reliability failure."""


class DispatchTimeout(ReliabilityError):
    """The dispatch watchdog deadline expired for this request's batch."""


class LoadShed(ReliabilityError):
    """Admission control rejected the request before it was queued."""


class WorkerCrashed(ReliabilityError):
    """The owning worker thread died; the request was failed rather than
    left to block forever. The worker restarts automatically."""
