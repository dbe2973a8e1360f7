"""Guarded execution of the index's state programs, the port's counterpart
of ``lazzaro_tpu/reliability/guard.py``.

The JAX package donates its state to each program and tells a failure's
two cases apart by whether donation deleted the input buffers. The port
has no donation: its state programs write the index's tensors in place.
So the line falls at the program's first write:

- **A failure before the first write** leaves the state intact. It is
  retried, at most ``retries`` times with an exponential backoff, and each
  retry counts ``serve.dispatch_retries{mode,reason}``. A success leaves
  the index exactly where a run that never failed would.
- **An out-of-memory error** is not a transient (the same geometry
  re-fails identically): it becomes :class:`DeviceOom` at once, is never
  retried, and counts ``reliability.oom{mode}``.
- **A failure after the first write** leaves a torn state: the guard raises
  :class:`ArenaPoisoned` (``reliability.poisoned{mode}``), the index marks
  itself poisoned and every later touch raises at once. Recovery is a
  checkpoint reload plus the ingest journal's replay.

Every in-place write of ``core.state`` marks the state it writes
(``state.mark_written``); the guard clears the marks before each attempt
and after a success, and reads them after a failure (:func:`is_poisoned`).
The fault point ``index.dispatch`` fires once per attempt, before the
program; its ``faults.poison_states_hook`` marks the states before it
raises, which models a program that died after its first write.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

from lazzaro_tpu_torch.reliability import faults
from lazzaro_tpu_torch.reliability.errors import ArenaPoisoned, DeviceOom

# The allocator's phrasings of a device allocation failure (the JAX
# package's markers; torch.cuda.OutOfMemoryError says "CUDA out of memory").
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating", "Resource exhausted")


def is_resource_exhausted(e: BaseException) -> bool:
    """True when ``e`` is a device allocation failure (or the typed
    :class:`DeviceOom` it becomes)."""
    if isinstance(e, DeviceOom):
        return True
    msg = f"{type(e).__name__}: {e}"
    return any(m in msg for m in _OOM_MARKERS)


def _each(states: Sequence):
    for st in states:
        if st is None:
            continue
        if isinstance(st, (list, tuple)):   # a mesh's shards
            yield from (s for s in st if s is not None)
        else:
            yield st


def is_poisoned(states: Sequence) -> bool:
    """True when a program wrote one of ``states`` in place and did not
    finish."""
    return any(getattr(st, "written", False) for st in _each(states))


def clear_marks(states: Sequence) -> None:
    for st in _each(states):
        st.written = False


def run_guarded(call: Callable, states: Sequence, *, telemetry=None,
                mode: str = "mutate", retries: int = 2,
                backoff_s: float = 0.005,
                fault_point: str = "index.dispatch"):
    """Run ``call()``, one state program over ``states`` (``ArenaState`` /
    ``EdgeState`` objects, or lists of a mesh's shards), under the failure
    model above. Raises :class:`ArenaPoisoned` for a torn state,
    :class:`DeviceOom` for an allocation failure, or the last error once
    the retries are spent."""
    attempt = 0
    while True:
        clear_marks(states)
        try:
            faults.fire(fault_point, states=states, mode=mode, attempt=attempt)
            out = call()
            clear_marks(states)
            return out
        except ArenaPoisoned:
            raise
        except Exception as e:               # noqa: BLE001 — typed below
            if is_poisoned(states):
                if telemetry is not None:
                    telemetry.bump("reliability.poisoned",
                                   labels={"mode": mode})
                raise ArenaPoisoned(
                    f"{mode} program failed after its first in-place write "
                    f"({type(e).__name__}: {e}); reload the last checkpoint "
                    f"and replay the ingest journal") from e
            if is_resource_exhausted(e):
                if telemetry is not None:
                    telemetry.bump("reliability.oom", labels={"mode": mode})
                raise DeviceOom(
                    f"{mode} dispatch exhausted device memory "
                    f"({type(e).__name__}: {e}); the same geometry would "
                    f"fail again") from e
            if attempt >= retries:
                raise
            if telemetry is not None:
                telemetry.bump("serve.dispatch_retries",
                               labels={"mode": mode,
                                       "reason": type(e).__name__})
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def check_not_poisoned(flag: bool, what: str = "index") -> None:
    """Entry-point guard: raise typed and at once on a poisoned index."""
    if flag:
        raise ArenaPoisoned(
            f"{what} is poisoned (a state program failed after its first "
            f"in-place write); reload the last checkpoint and replay the "
            f"ingest journal")


__all__ = ["is_poisoned", "is_resource_exhausted", "run_guarded",
           "check_not_poisoned", "clear_marks", "ArenaPoisoned", "DeviceOom"]
