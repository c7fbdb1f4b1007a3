"""Per-request deadlines.

Counterpart of ``oryx_tpu/resilience/policy.py``, cut down to
``Deadline`` and ``DeadlineExceeded``: the front end mints a deadline
and the request batcher sheds work whose budget ran out.
"""

from __future__ import annotations

from ..common import clock as clockmod

__all__ = ["Deadline", "DeadlineExceeded"]


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
