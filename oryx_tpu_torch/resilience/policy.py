"""Resilience policies: deadlines, backoff, retry, circuit breaker.

Counterpart of ``oryx_tpu/resilience/policy.py``, cut down to what the
serving layer uses: ``Deadline`` and ``DeadlineExceeded`` (the front end
mints a deadline and the request batcher sheds work whose budget ran
out), ``run_with_resubscribe`` with its ``Backoff`` (the update-topic
consumer), and ``Retry``, ``CircuitBreaker`` and
``ResilientTopicProducer`` around the input-topic producer of
``/pref`` and ``/ingest``, and ``Supervisor``, which restarts a layer
run from the operator CLI (``deploy/main.py``).  Every named
:class:`Retry` and :class:`CircuitBreaker` registers itself in a
process-wide table; :func:`resilience_snapshot` renders their counters
for ``/metrics`` (the serving layer's, and the batch and speed layers'
side door, ``obs/server.py``).
"""

from __future__ import annotations

import logging
import random
import threading
import time
import weakref
from typing import Any, Callable

from ..common import clock as clockmod
from .faults import InjectedFault

__all__ = ["Deadline", "DeadlineExceeded", "CircuitOpenError", "Backoff",
           "Retry", "CircuitBreaker", "ResilientTopicProducer",
           "Supervisor", "resilience_snapshot", "run_with_resubscribe"]

_log = logging.getLogger(__name__)

# -- the named-instance table (the /metrics feed) ---------------------------

_REGISTRY: "weakref.WeakValueDictionary[str, Any]" = \
    weakref.WeakValueDictionary()
_REGISTRY_LOCK = threading.Lock()


def _register(name: str, instance) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[name] = instance


def resilience_snapshot() -> dict:
    """{name: stats} for every live named Retry and CircuitBreaker."""
    with _REGISTRY_LOCK:
        items = list(_REGISTRY.items())
    return {name: inst.stats() for name, inst in sorted(items)}


class Backoff:
    """Exponential backoff with full jitter on its top ``jitter``
    fraction, capped: ``delay(attempt)`` for attempt 1, 2, ...;
    deterministic with ``jitter=0``."""

    __slots__ = ("initial", "maximum", "multiplier", "jitter", "_rng")

    def __init__(self, initial: float = 0.05, maximum: float = 2.0,
                 multiplier: float = 2.0, jitter: float = 0.2,
                 rng: random.Random | None = None):
        self.initial = initial
        self.maximum = maximum
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        base = min(self.maximum,
                   self.initial * self.multiplier ** max(0, attempt - 1))
        if not self.jitter:
            return base
        return base * (1.0 - self.jitter * self._rng.random())

    @classmethod
    def from_config(cls, config, path: str = "oryx.resilience.retry"
                    ) -> "Backoff":
        return cls(
            initial=config.get_int(f"{path}.initial-backoff-ms") / 1000.0,
            maximum=config.get_int(f"{path}.max-backoff-ms") / 1000.0,
            multiplier=config.get_double(f"{path}.multiplier"),
            jitter=config.get_double(f"{path}.jitter"))


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
    backoff = backoff or Backoff(initial=0.1, maximum=5.0)
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
            clockmod.wait(stop, backoff.delay(attempt))


class DeadlineExceeded(Exception):
    """A per-call deadline expired before the work completed (mapped to
    HTTP 503 at the serving surface)."""


class CircuitOpenError(Exception):
    """Fast-fail: the guarded dependency is presumed down and the
    breaker is shedding calls instead of queueing them."""


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

    def remaining(self) -> float:
        return max(0.0, self.t_end - clockmod.monotonic())

    def check(self, what: str = "call") -> None:
        if self.expired:
            raise DeadlineExceeded(f"deadline exceeded in {what}")


class Retry:
    """Bounded retry of transient failures with backoff.

    ``retryable`` is an exception tuple or a predicate; anything else
    propagates at once.  An optional :class:`Deadline` bounds the whole
    call, sleeps included: when no time is left for the next pause the
    last failure is raised."""

    def __init__(self, name: str,
                 retryable: tuple | Callable[[BaseException], bool]
                 = (ConnectionError, OSError, TimeoutError,
                    InjectedFault),
                 max_attempts: int = 5,
                 backoff: Backoff | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.name = name
        self._retryable = retryable
        self.max_attempts = max(1, max_attempts)
        self.backoff = backoff or Backoff()
        self._sleep = sleep
        self._lock = threading.Lock()
        self.calls = 0
        self.retries = 0
        self.give_ups = 0
        _register(name, self)

    @classmethod
    def from_config(cls, name: str, config, retryable=None) -> "Retry":
        kw = {} if retryable is None else {"retryable": retryable}
        return cls(name,
                   max_attempts=config.get_int(
                       "oryx.resilience.retry.max-attempts"),
                   backoff=Backoff.from_config(config), **kw)

    def _is_retryable(self, e: BaseException) -> bool:
        r = self._retryable
        # an exception class is callable too: a bare class means
        # isinstance, not a predicate
        if isinstance(r, tuple) or (isinstance(r, type)
                                    and issubclass(r, BaseException)):
            return isinstance(e, r)
        return bool(r(e))

    def call(self, fn: Callable, *args,
             deadline: Deadline | None = None, **kwargs):
        with self._lock:
            self.calls += 1
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if not self._is_retryable(e) or attempt >= self.max_attempts:
                    with self._lock:
                        self.give_ups += 1
                    raise
                pause = self.backoff.delay(attempt)
                if deadline is not None and deadline.remaining() <= pause:
                    with self._lock:
                        self.give_ups += 1
                    raise
                with self._lock:
                    self.retries += 1
                _log.debug("%s: retrying after %s (attempt %d/%d)",
                           self.name, e, attempt, self.max_attempts)
                self._sleep(pause)

    def stats(self) -> dict:
        with self._lock:
            return {"kind": "retry", "calls": self.calls,
                    "retries": self.retries, "give_ups": self.give_ups,
                    "max_attempts": self.max_attempts}


class CircuitBreaker:
    """Closed -> open after ``failure_threshold`` consecutive failures;
    open sheds calls (CircuitOpenError) for ``reset_timeout_sec``; then
    half-open admits ``half_open_probes`` probe calls — success closes,
    failure re-opens.  ``clock`` is injectable, so a test controls time
    instead of sleeping through it."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_sec: float = 1.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = clockmod.monotonic):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_sec = reset_timeout_sec
        self.half_open_probes = max(1, half_open_probes)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self.opens = 0
        self.rejected = 0
        self.calls = 0
        _register(name, self)

    @classmethod
    def from_config(cls, name: str, config,
                    path: str = "oryx.resilience.breaker"
                    ) -> "CircuitBreaker":
        return cls(
            name,
            failure_threshold=config.get_int(f"{path}.failure-threshold"),
            reset_timeout_sec=config.get_int(
                f"{path}.reset-timeout-ms") / 1000.0,
            half_open_probes=config.get_int(f"{path}.half-open-probes"))

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _admit(self) -> bool:
        """Reserve the right to make one call; False sheds it."""
        with self._lock:
            self.calls += 1
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if (self._clock() - self._opened_at
                        < self.reset_timeout_sec):
                    self.rejected += 1
                    return False
                self._state = self.HALF_OPEN
                self._probes_in_flight = 0
            # half-open: a bounded number of concurrent probes
            if self._probes_in_flight >= self.half_open_probes:
                self.rejected += 1
                return False
            self._probes_in_flight += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == self.HALF_OPEN:
                self._state = self.CLOSED
                _log.info("%s: circuit closed (probe succeeded)",
                          self.name)
            self._probes_in_flight = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN \
                    or self._failures >= self.failure_threshold:
                if self._state != self.OPEN:
                    self.opens += 1
                    _log.warning("%s: circuit OPEN after %d failure(s)",
                                 self.name, self._failures)
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probes_in_flight = 0

    def call(self, fn: Callable, *args, **kwargs):
        if not self._admit():
            raise CircuitOpenError(f"{self.name}: circuit open, call shed")
        try:
            out = fn(*args, **kwargs)
        except BaseException:
            # BaseException too: a probe killed mid-call must release
            # its slot, or the breaker sheds every later call
            self.record_failure()
            raise
        self.record_success()
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"kind": "breaker", "state": self._state,
                    "consecutive_failures": self._failures,
                    "opens": self.opens, "rejected": self.rejected,
                    "calls": self.calls}


# -- supervised restart ------------------------------------------------------

class Supervisor:
    """Restart-with-backoff around a layer's start/await_/close
    lifecycle (deploy/main.py).

    The layers' worker threads survive ``Exception`` but die on anything
    harsher (an injected crash, a bug escaping the survival handlers);
    ``await_`` returning while ``close`` was never requested is the
    crash signal.  The supervisor rebuilds the layer from its factory
    and restarts it, with backoff, up to ``max_restarts`` times; a layer
    that stayed up ``healthy_reset_sec`` earns its budget back."""

    def __init__(self, factory: Callable[[], Any], name: str = "layer",
                 max_restarts: int = 5, backoff: Backoff | None = None,
                 sleep: Callable[[float], None] = clockmod.sleep,
                 healthy_reset_sec: float = 300.0,
                 clock: Callable[[], float] = clockmod.monotonic):
        self.factory = factory
        self.name = name
        self.max_restarts = max_restarts
        self.backoff = backoff or Backoff(initial=0.2, maximum=5.0)
        self._sleep = sleep
        self._stop = threading.Event()
        self.restarts = 0
        self.layer = None
        # the cap bounds crash loops, not the lifetime count of crashes
        self.healthy_reset_sec = healthy_reset_sec
        self._clock = clock

    @classmethod
    def from_config(cls, factory, name: str, config) -> "Supervisor":
        path = "oryx.resilience.supervisor"
        return cls(factory, name=name,
                   max_restarts=config.get_int(f"{path}.max-restarts"),
                   backoff=Backoff(
                       initial=config.get_int(
                           f"{path}.initial-backoff-ms") / 1000.0,
                       maximum=config.get_int(
                           f"{path}.max-backoff-ms") / 1000.0))

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        """Blocks until the layer exits cleanly (stop requested or
        KeyboardInterrupt) or the restart budget is spent, which
        raises."""
        while not self._stop.is_set():
            started = self._clock()
            self.layer = None  # a failed factory() must not re-close
            try:               # the previous, already-closed layer
                # factory() and start() are inside the try: a rebuild
                # against a dependency still down counts as a crash and
                # retries with backoff instead of ending the process
                self.layer = self.factory()
                self.layer.start()
                self.layer.await_()
            except KeyboardInterrupt:
                self._stop.set()
            except Exception:  # noqa: BLE001 — a failed (re)build is a
                _log.exception("%s: layer failed", self.name)  # crash
            finally:
                if self.layer is not None:
                    try:
                        self.layer.close()
                    except Exception:  # noqa: BLE001 — best effort
                        _log.exception("%s: close() failed", self.name)
            if self._stop.is_set():
                return
            if self._clock() - started >= self.healthy_reset_sec:
                self.restarts = 0
            if self.restarts >= self.max_restarts:
                _log.error("%s: gave up after %d restart(s)", self.name,
                           self.restarts)
                raise RuntimeError(
                    f"{self.name}: exceeded {self.max_restarts} restarts")
            self.restarts += 1
            pause = self.backoff.delay(self.restarts)
            _log.warning("%s: layer died; restart %d/%d in %.2fs",
                         self.name, self.restarts, self.max_restarts,
                         pause)
            self._sleep(pause)


class ResilientTopicProducer:
    """Retry + circuit breaker around a TopicProducer.

    The breaker sits outside the retry: one exhausted retry sequence is
    ONE breaker failure, so the threshold measures a sustained outage.
    With the breaker open, sends shed at once (CircuitOpenError), which
    the serving routes map to 503."""

    def __init__(self, inner, retry: Retry,
                 breaker: CircuitBreaker | None = None):
        self._inner = inner
        self._retry = retry
        self._breaker = breaker

    def _call(self, fn: Callable, *args, **kwargs) -> None:
        if self._breaker is None:
            self._retry.call(fn, *args, **kwargs)
        else:
            self._breaker.call(self._retry.call, fn, *args, **kwargs)

    def send(self, key: str | None, message: str,
             headers: dict | None = None) -> None:
        kw = {} if headers is None else {"headers": headers}
        self._call(self._inner.send, key, message, **kw)

    def send_many(self, entries: list[tuple[str | None, str,
                                            dict | None]]) -> None:
        """A pipelined multi-record send under ONE retry and breaker
        admission: a failure retries the whole batch (at least once;
        the update topic's set semantics absorb duplicates)."""
        entries = list(entries)
        if entries:
            self._call(self._inner.send_many, entries)

    def get_update_broker(self) -> str:
        return self._inner.get_update_broker()

    def get_topic(self) -> str:
        return self._inner.get_topic()

    def close(self) -> None:
        self._inner.close()
