"""Typed failures, the subset of ``lazzaro_tpu/reliability/errors.py`` that
the port raises: the query scheduler's (a request future resolves with a
result or one of these, never by hanging), the index checkpoint's and the
state dispatch guard's (``reliability.guard``)."""

from __future__ import annotations


class ReliabilityError(RuntimeError):
    """Base class for every typed reliability failure."""


class ArenaPoisoned(ReliabilityError):
    """A state program failed after its first in-place write: the arena or
    edge tensors are torn. Every later touch of the index raises this;
    recover by reloading the last checkpoint and replaying the ingest
    journal."""


class DeviceOom(ReliabilityError):
    """A dispatch failed allocating device memory. Not a transient: the
    same geometry re-fails identically, so the guard raises this at once
    and never retries it."""


class DispatchTimeout(ReliabilityError):
    """The dispatch watchdog deadline expired for this request's batch."""


class LoadShed(ReliabilityError):
    """Admission control rejected the request before it was queued."""


class WorkerCrashed(ReliabilityError):
    """The owning worker thread died; the request was failed rather than
    left to block forever. The worker restarts automatically."""


class CheckpointCorrupt(ReliabilityError):
    """Checkpoint payload failed checksum/decoding — refusing to load."""
