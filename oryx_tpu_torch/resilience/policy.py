"""Per-request deadlines.

Counterpart of ``oryx_tpu/resilience/policy.py``, cut down to
``Deadline`` and ``DeadlineExceeded`` (the front end mints a deadline
and the request batcher sheds work whose budget ran out), and
``run_with_resubscribe`` with its ``Backoff`` (the serving layer's
update-topic consumer).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable

from ..common import clock as clockmod

__all__ = ["Deadline", "DeadlineExceeded", "Backoff",
           "run_with_resubscribe"]

_log = logging.getLogger(__name__)


class Backoff:
    """Exponential backoff, capped: ``initial * 2**(attempt-1)`` up to
    ``maximum`` seconds."""

    def __init__(self, initial: float = 0.1, maximum: float = 5.0):
        self.initial = initial
        self.maximum = maximum

    def delay(self, attempt: int) -> float:
        return min(self.maximum, self.initial * (2 ** max(0, attempt - 1)))


def run_with_resubscribe(fn: Callable[[], Any], stop: threading.Event,
                         what: str, backoff: Backoff | None = None,
                         log: logging.Logger | None = None,
                         healthy_reset_sec: float = 300.0) -> None:
    """Run a blocking subscription (``fn`` returns only on a clean end)
    until it completes or ``stop`` is set, restarting it with backoff on
    failure.  The serving model is rebuilt by a replay from offset 0, so
    recovery is the cold-start path.  A subscription that stayed up
    ``healthy_reset_sec`` resets the attempt count; the wait between
    attempts ends as soon as ``stop`` is set."""
    backoff = backoff or Backoff()
    log = log or _log
    attempt = 0
    while not stop.is_set():
        started = clockmod.monotonic()
        try:
            fn()
            return  # clean end: stop was requested
        except Exception:  # noqa: BLE001 — resubscribe, don't die
            if clockmod.monotonic() - started >= healthy_reset_sec:
                attempt = 0
            attempt += 1
            log.exception("%s failed; resubscribing (attempt %d)",
                          what, attempt)
            stop.wait(backoff.delay(attempt))


class DeadlineExceeded(Exception):
    """A per-call deadline expired before the work completed (mapped to
    HTTP 503 at the serving surface)."""


class Deadline:
    """A monotonic-clock deadline carried from the serving front end
    down through the request micro-batcher: work that cannot finish in
    time is refused up front (503) instead of queueing to die."""

    __slots__ = ("t_end",)

    def __init__(self, t_end: float):
        self.t_end = t_end

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(clockmod.monotonic() + seconds)

    @property
    def expired(self) -> bool:
        return clockmod.monotonic() >= self.t_end

    def check(self, what: str = "call") -> None:
        if self.expired:
            raise DeadlineExceeded(f"deadline exceeded in {what}")
