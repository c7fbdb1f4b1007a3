"""Device-time accounting.

Counterpart of ``oryx_tpu/obs/device_time.py``, cut down to the
accumulator and the process-level hook the measured-cost router books
its sweeps against (``note("measure", chosen, generation, seconds)``).
The registry counters and the busy-fraction gauge come with the
metrics surface.
"""

from __future__ import annotations

import re
import threading

__all__ = ["DeviceTimeAccountant", "install_process_accountant",
           "process_accountant"]

_LABEL_RE = re.compile(r"[^a-z0-9_]+")


def _label(kernel_route) -> str:
    return _LABEL_RE.sub("_", str(kernel_route or "default").lower())


class DeviceTimeAccountant:
    """Thread-safe accumulator of device-execute seconds per
    (route class, kernel route, generation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._busy_s = 0.0
        self._by_key: dict = {}

    def note(self, route_class: str, kernel_route,
             generation, seconds: float) -> None:
        """Account one device-execute interval; never raises."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return
        # NaN compares false both ways: require a provably sane interval
        if not seconds >= 0.0 or seconds == float("inf"):
            return
        key = (route_class, _label(kernel_route), generation)
        with self._lock:
            self._busy_s += seconds
            self._by_key[key] = self._by_key.get(key, 0.0) + seconds

    def snapshot(self) -> dict:
        """Total busy seconds and the per-route seconds, busiest first."""
        with self._lock:
            busy = self._busy_s
            by_key = sorted(self._by_key.items(),
                            key=lambda kv: (-kv[1], kv[0]))
        return {"busy_s": round(busy, 6),
                "by_route": [{"route_class": rc, "kernel_route": kr,
                              "generation": gen, "device_s": round(s, 6)}
                             for (rc, kr, gen), s in by_key]}


_PROCESS_LOCK = threading.Lock()
_PROCESS: DeviceTimeAccountant | None = None


def install_process_accountant(
        acct: DeviceTimeAccountant | None) -> DeviceTimeAccountant | None:
    """Publish ``acct`` as the process's accountant (None removes it);
    the kernel router books its measurement sweeps against it."""
    global _PROCESS
    with _PROCESS_LOCK:
        _PROCESS = acct
    return acct


def process_accountant() -> DeviceTimeAccountant | None:
    return _PROCESS
