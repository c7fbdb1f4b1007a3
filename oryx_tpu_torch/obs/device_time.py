"""Continuous device-time accounting.

Counterpart of ``oryx_tpu/obs/device_time.py``, whole.  Every bracketed
device-execute interval — a scoring batch in serving/batcher.py (a wall
interval from drain pickup to results on the host, which includes the
window's host share), a route-measurement sweep in app/als/
kernel_router.py — lands here as ``note(route_class, kernel_route,
generation, seconds)``.  The accountant keeps three views:

- cumulative **microsecond counters** on the tier's registry:
  ``device_time_us`` plus one dynamic
  ``device_time_us_<route_class>_<kernel_route>`` per observed route,
  riding the existing Prometheus exposition as
  ``oryx_device_time_us_*_total`` — mergeable across replicas;
- the ``device_busy_fraction`` **gauge**: busy seconds over a sliding
  ~60 s window, the "is the device the bottleneck" scrape the
  autoscaler and the diagnosis engine read;
- a structured :meth:`snapshot` — per-(route-class, kernel_route,
  generation) seconds and time-share — folded into ``/admin/tail``'s
  stage taxonomy and every flight bundle, so "ANN vs exact vs
  fold-in" occupancy is a first-class forensic fact.

Route classes: ``serve`` (the batcher's scoring dispatches) and
``measure`` (kernel_router's calibration probes).  The kernel_router
has no layer wiring of its own, so it reaches the accountant through
the process-level hook (:func:`install_process_accountant`) the
serving layer installs — one process is one replica in production.
"""

from __future__ import annotations

import re
import threading
from collections import deque

from ..common import clock as clockmod

__all__ = ["DeviceTimeAccountant", "install_process_accountant",
           "process_accountant"]

# busy-fraction window; long enough to smooth batch cadence, short
# enough that a saturation spike pages while it is still true
_WINDOW_SEC = 60.0

_LABEL_RE = re.compile(r"[^a-z0-9_]+")


def _label(kernel_route) -> str:
    return _LABEL_RE.sub("_", str(kernel_route or "default").lower())


class DeviceTimeAccountant:
    """Thread-safe accumulator of device-execute seconds."""

    def __init__(self, registry=None, clock=None):
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._t0 = self._mono()
        self._busy_s = 0.0  # guarded-by: _lock
        # (route_class, kernel_route, generation) -> seconds
        self._by_key: dict = {}  # guarded-by: _lock
        # (t, cumulative-busy) samples bounding the sliding window;
        # the pruned tail becomes the window baseline
        self._samples: deque = deque()  # guarded-by: _lock
        self._base_t = self._t0  # guarded-by: _lock
        self._base_busy = 0.0  # guarded-by: _lock
        if registry is not None:
            registry.gauge_fn("device_busy_fraction",
                              self.busy_fraction)

    def _mono(self) -> float:
        return self._clock() if self._clock is not None \
            else clockmod.monotonic()

    def note(self, route_class: str, kernel_route,
             generation, seconds: float) -> None:
        """Account one device-execute interval; never raises."""
        try:
            seconds = float(seconds)
            # not-a-number poisons every cumulative view downstream;
            # the comparison filters it (NaN < 0 and NaN >= 0 are
            # both false), so require a provably sane interval
            if not seconds >= 0.0 or seconds == float("inf"):
                return
            now = self._mono()
            with self._lock:
                self._busy_s += seconds
                key = (route_class, _label(kernel_route), generation)
                self._by_key[key] = self._by_key.get(key, 0.0) \
                    + seconds
                self._samples.append((now, self._busy_s))
                while self._samples \
                        and now - self._samples[0][0] > _WINDOW_SEC:
                    self._base_t, self._base_busy = \
                        self._samples.popleft()
                rc_label = _label(route_class)
                kr_label = _label(kernel_route)
            if self._registry is not None:
                us = int(seconds * 1e6)
                self._registry.inc("device_time_us", us)
                # dynamic per-route share; the catalog documents the
                # device_time_us_* prefix rather than each expansion
                self._registry.inc(
                    f"device_time_us_{rc_label}_{kr_label}", us)
        except Exception:  # noqa: BLE001 — accounting never breaks serving
            pass

    def busy_fraction(self) -> float:
        """Busy seconds over the sliding window, clamped to [0, 1]."""
        now = self._mono()
        with self._lock:
            span = now - self._base_t
            if span <= 0.0:
                return 0.0
            frac = (self._busy_s - self._base_busy) / span
        return round(max(0.0, min(1.0, frac)), 4)

    def snapshot(self) -> dict:
        """The structured view for /admin/tail, /metrics, and flight
        bundles: totals plus per-route share, busiest first."""
        now = self._mono()
        with self._lock:
            busy = self._busy_s
            by_key = sorted(self._by_key.items(),
                            key=lambda kv: (-kv[1], kv[0]))
        uptime = max(now - self._t0, 1e-9)
        return {
            "busy_s": round(busy, 6),
            "uptime_s": round(uptime, 3),
            "busy_fraction": self.busy_fraction(),
            "by_route": [
                {"route_class": rc, "kernel_route": kr,
                 "generation": gen, "device_s": round(s, 6),
                 "share": round(s / busy, 4) if busy > 0 else 0.0}
                for (rc, kr, gen), s in by_key],
        }


# -- process-level hook ------------------------------------------------------

_PROCESS_LOCK = threading.Lock()
_PROCESS: DeviceTimeAccountant | None = None


def install_process_accountant(
        acct: DeviceTimeAccountant) -> DeviceTimeAccountant:
    """Publish ``acct`` as the process's accountant (the serving layer
    calls this at construction); code without layer wiring — the
    kernel_router's calibration probes — books time against it."""
    global _PROCESS
    with _PROCESS_LOCK:
        _PROCESS = acct
    return acct


def process_accountant() -> DeviceTimeAccountant | None:
    return _PROCESS
