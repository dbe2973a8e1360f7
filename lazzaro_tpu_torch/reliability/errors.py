"""Typed failures, the subset of ``lazzaro_tpu/reliability/errors.py`` that
the port raises: the query scheduler's (a request future resolves with a
result or one of these, never by hanging) and the index checkpoint's."""

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


class CheckpointCorrupt(ReliabilityError):
    """Checkpoint payload failed checksum/decoding — refusing to load."""
