"""Process-wide fault-injection registry.

Counterpart of ``oryx_tpu/resilience/faults.py``.  A call site declares
a named injection point::

    faults.fire("route-measure-lsh")

and with no fault registered for that name (the production default)
``fire`` is one module-global boolean check.  A test, or the
``oryx.resilience.faults`` config block, arms the point::

    faults.inject("route-measure-lsh", mode="delay", delay_sec=0.05)

after which the next ``times`` calls take the fault action:

========== ==========================================================
mode       effect at the call site
========== ==========================================================
``error``  raise (the point's ``error`` factory, or the spec's, or
           :class:`InjectedFault`)
``crash``  raise :class:`InjectedCrash` — a BaseException, so layer
           code that survives ``Exception`` dies as if the process
           were killed at that line
``delay``  sleep ``delay_sec``, then continue
``hold``   park on the point's gate until :func:`release` (or a 30 s
           safety cap) — a deterministic stall
``drop``   return ``"drop"`` — the call site discards the operation
``duplicate`` return ``"duplicate"`` — the call site performs the
           operation twice (a producer retry's redelivery)
========== ==========================================================

``fired(name)`` counts consumed activations, and a fire listener
(``add_fire_listener``: the flight recorder's chaos trigger) sees each
one.  Point names are the reference's, verbatim, including the serving
cluster's: ``router-shard-timeout`` (the scatter, once per shard query:
a stalled or failing shard), ``replica-heartbeat-drop`` and
``replica-group-flap`` (a replica's heartbeat publisher: a silent or
straggling replica), ``reshard-warm-stall`` (a replica's update
replay, per record), ``transport-frame-stall`` (a replica's frame
dispatcher, per stream), ``async-loop-block`` (the router's asyncio
front end, per request, on the loop), ``router-cache-stale-feed`` (the
result cache's invalidation tap) and ``router-coalesce-leader-death``
(a coalescing leader at its flight's start), the mirror's
``mirror-link-partition`` and ``mirror-crash-mid-replay``, the Kafka wire
client's ``wire-send`` and ``wire-read`` and its ``MiniKafkaBroker``'s
``mini-broker-drop``, ``mini-broker-produce-error`` and
``mini-broker-fetch-error``, and the speed layer's ``speed-publish`` and
``speed-crash-mid-batch`` (between a micro-batch's publishes and its
checkpoint commit).  ``configure_from_config`` arms any name, so a
chaos config written for the reference may arm a point of a module this
package does not have yet, which then never fires.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

from ..common import clock as clockmod

_log = logging.getLogger(__name__)

__all__ = ["InjectedFault", "InjectedCrash", "inject", "clear", "fire",
           "fired", "release", "add_fire_listener",
           "remove_fire_listener", "configure_from_config"]

_MODES = ("error", "crash", "delay", "hold", "drop", "duplicate")


class InjectedFault(Exception):
    """A transient injected failure — retryable, like the I/O error it
    stands in for."""


class InjectedCrash(BaseException):
    """A simulated process kill.  BaseException on purpose: the layers'
    ``except Exception`` survival handlers must not absorb it, as they
    could not absorb ``kill -9``."""


class _Spec:
    __slots__ = ("mode", "remaining", "delay_sec", "error", "gate")

    def __init__(self, mode: str, times: int | None, delay_sec: float,
                 error: Callable[[], BaseException] | None):
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.mode = mode
        self.remaining = times  # None = unlimited
        self.delay_sec = delay_sec
        self.error = error
        self.gate = threading.Event() if mode == "hold" else None


_LOCK = threading.Lock()
_SPECS: dict[str, _Spec] = {}
_FIRED: dict[str, int] = {}
# fast path: fire() costs one global read while nothing is armed
_ACTIVE = False
# configure_from_config arms once per process (until clear())
_CONFIG_APPLIED = False
# observers of every consumed activation (the flight recorder's chaos
# trigger); a copy-on-write tuple, so fire() reads it without the lock
_LISTENERS: tuple = ()


def inject(point: str, mode: str = "error", times: int | None = 1,
           delay_sec: float = 0.0,
           error: Callable[[], BaseException] | None = None) -> None:
    """Arm an injection point (last registration per point wins)."""
    global _ACTIVE
    spec = _Spec(mode, times, delay_sec, error)
    with _LOCK:
        _SPECS[point] = spec
        _ACTIVE = True
    _log.info("Fault armed: %s mode=%s times=%s", point, mode, times)


def clear(point: str | None = None) -> None:
    """Disarm one point, or every point (also resetting the fired
    counters and letting configure_from_config arm again)."""
    global _ACTIVE, _CONFIG_APPLIED
    with _LOCK:
        if point is None:
            _SPECS.clear()
            _FIRED.clear()
            _CONFIG_APPLIED = False
        else:
            _SPECS.pop(point, None)
        _ACTIVE = bool(_SPECS)


def fired(point: str) -> int:
    """How many times the point's fault has actually been consumed."""
    with _LOCK:
        return _FIRED.get(point, 0)


def release(point: str) -> None:
    """Open a ``mode="hold"`` point's gate: every caller parked at the
    point resumes, and later activations pass straight through."""
    with _LOCK:
        spec = _SPECS.get(point)
        gate = spec.gate if spec is not None else None
    if gate is not None:
        gate.set()


def add_fire_listener(fn) -> None:
    """Register ``fn(point, mode)`` to observe every consumed fault
    activation.  It is called after the spec is consumed and the lock
    released, before the fault's action runs; a raising listener is
    swallowed, so observers never alter the seam."""
    global _LISTENERS
    with _LOCK:
        _LISTENERS = _LISTENERS + (fn,)


def remove_fire_listener(fn) -> None:
    global _LISTENERS
    with _LOCK:
        _LISTENERS = tuple(f for f in _LISTENERS if f is not fn)


def fire(point: str,
         error: Callable[[], BaseException] | None = None) -> str | None:
    """Consume one activation of ``point`` if armed: raise for
    ``error`` and ``crash``, sleep for ``delay``, park on the gate for
    ``hold``, return the mode for ``drop`` and
    ``duplicate`` (the call site acts), and None when the point is not
    armed.  ``error`` is the call site's
    exception factory; a factory on the spec overrides it."""
    if not _ACTIVE:
        return None
    with _LOCK:
        spec = _SPECS.get(point)
        if spec is None:
            return None
        if spec.remaining is not None:
            if spec.remaining <= 0:
                return None
            spec.remaining -= 1
        _FIRED[point] = _FIRED.get(point, 0) + 1
        mode, delay = spec.mode, spec.delay_sec
        factory = spec.error or error
        gate = spec.gate
    _log.info("Fault fired: %s mode=%s", point, mode)
    for listener in _LISTENERS:
        try:
            listener(point, mode)
        except Exception:  # noqa: BLE001 — observers never alter the seam
            pass
    if mode == "delay":
        clockmod.sleep(delay)
        return None
    if mode == "hold":
        # safety cap: a test that forgets release() stalls one point
        # for 30 s, not forever
        clockmod.wait(gate, 30.0)
        return None
    if mode == "crash":
        raise InjectedCrash(f"injected crash at {point}")
    if mode == "error":
        raise factory() if factory else InjectedFault(
            f"injected fault at {point}")
    return mode


def configure_from_config(config) -> None:
    """Arm every fault declared under ``oryx.resilience.faults``: each
    child maps a point name to ``{mode, times, delay-ms}`` (``times``
    absent = 1, -1 = unlimited).  Arms at most once per process until
    :func:`clear`, as the reference does."""
    global _CONFIG_APPLIED
    try:
        node = config.get("oryx.resilience.faults")
    except KeyError:
        return
    if not isinstance(node, dict) or not node:
        return
    with _LOCK:
        if _CONFIG_APPLIED:
            return
        _CONFIG_APPLIED = True
    for point, spec in node.items():
        if not isinstance(spec, dict):
            continue
        times = spec.get("times", 1)
        inject(point,
               mode=str(spec.get("mode", "error")),
               times=None if times in (None, -1) else int(times),
               delay_sec=float(spec.get("delay-ms", 0)) / 1000.0)
