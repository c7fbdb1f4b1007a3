"""The injectable clock seam: the one source of time of the request
batcher, the supervisor and the observability modules.

Counterpart of ``oryx_tpu/common/clock.py``, without its simulation
clock (the deterministic cluster simulation is not part of this
package).  Two implementations:

- :class:`SystemClock` — the production default: real ``time.*`` and
  real ``Event.wait``.  Installing nothing changes nothing.
- :class:`ManualClock` — a thread-safe test clock: time moves only
  when the test calls :meth:`ManualClock.advance`; ``sleep`` and
  ``wait`` block the calling thread until another thread advances past
  the deadline (or the event sets).  Tests pin SLO windows, flight
  ticks and debounce intervals with it instead of sleeping.

The module-level functions (:func:`now`, :func:`monotonic`,
:func:`sleep`, :func:`wait`) read the active clock on every call, so
``install()`` reaches code that captured the functions at import time.
"""

from __future__ import annotations

import threading
import time as _time

__all__ = ["Clock", "SystemClock", "ManualClock", "SYSTEM", "get",
           "install", "installed", "now", "monotonic", "sleep", "wait"]


class Clock:
    """The seam protocol.  ``time()`` is wall-clock epoch seconds
    (timestamps, record ``ts`` headers); ``monotonic()`` is the
    scheduling, TTL and timeout clock; ``sleep`` blocks; ``wait`` is the
    seam's ``threading.Event.wait`` and honors an event set by another
    thread as well as the timeout."""

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait(self, event: threading.Event,
             timeout: float | None = None) -> bool:
        raise NotImplementedError


class SystemClock(Clock):
    """Real time — the production default."""

    def time(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def wait(self, event: threading.Event,
             timeout: float | None = None) -> bool:
        return event.wait(timeout)


class ManualClock(Clock):
    """Thread-safe virtual clock for tests with real threads: time moves
    only through :meth:`advance`.  ``sleep`` and ``wait`` park the
    caller on a condition until the clock passes their deadline (or the
    event sets).  The start values default to the real clocks, so
    readers outside the test see a plausible frozen time, not zero."""

    def __init__(self, start_monotonic: float | None = None,
                 start_time: float | None = None):
        self._cond = threading.Condition()
        self._mono = (_time.monotonic() if start_monotonic is None
                      else start_monotonic)
        self._wall = _time.time() if start_time is None else start_time

    def time(self) -> float:
        with self._cond:
            return self._wall

    def monotonic(self) -> float:
        with self._cond:
            return self._mono

    def advance(self, seconds: float) -> None:
        """Move both clocks forward and wake every sleeper and waiter."""
        if seconds < 0:
            raise ValueError(f"cannot advance by {seconds}")
        with self._cond:
            self._mono += seconds
            self._wall += seconds
            self._cond.notify_all()

    def sleep(self, seconds: float) -> None:
        with self._cond:
            deadline = self._mono + max(0.0, seconds)
            while self._mono < deadline:
                self._cond.wait()

    def wait(self, event: threading.Event,
             timeout: float | None = None) -> bool:
        with self._cond:
            deadline = (None if timeout is None
                        else self._mono + max(0.0, timeout))
            while not event.is_set():
                if deadline is not None and self._mono >= deadline:
                    break
                # a bounded real wait, so an event set by a thread that
                # does not know this clock still wakes the caller
                self._cond.wait(0.05)
            return event.is_set()


SYSTEM = SystemClock()
_active: Clock = SYSTEM
_install_lock = threading.Lock()


def get() -> Clock:
    """The active clock."""
    return _active


def install(clock: Clock) -> Clock:
    """Install ``clock`` process-wide; returns the previous one.  Only
    tests call this."""
    global _active
    with _install_lock:
        prev = _active
        _active = clock
        return prev


class installed:
    """``with clock.installed(ManualClock()) as mc:`` — a scoped install
    that always restores the previous clock."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self._prev: Clock | None = None

    def __enter__(self) -> Clock:
        self._prev = install(self.clock)
        return self.clock

    def __exit__(self, *exc) -> None:
        assert self._prev is not None
        install(self._prev)


def now() -> float:
    """Wall-clock epoch seconds from the active clock."""
    return _active.time()


def monotonic() -> float:
    return _active.monotonic()


def sleep(seconds: float) -> None:
    _active.sleep(seconds)


def wait(event: threading.Event, timeout: float | None = None) -> bool:
    """``event.wait(timeout)`` through the seam."""
    return _active.wait(event, timeout)
