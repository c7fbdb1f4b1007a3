"""Request metrics registry for the serving layer.

Counterpart of ``oryx_tpu/lambda_rt/metrics.py``, whole.  The
reference's observability is logs + the Spark UI (SURVEY §5.1/5.5 —
no metrics registry exists); ops parity needs at least request counts
and latency percentiles per endpoint.  This is a
minimal thread-safe registry: per-route counters plus a bounded
latency reservoir (ring buffer), surfaced by the ``/metrics`` endpoint
(serving/framework.py) and usable from bench harnesses.

Each route also feeds a fixed-bucket latency histogram (obs/prom.py):
reservoir percentiles are exact per process but cannot be combined,
while bucket counts merge exactly — the cluster gateway sums them
across replicas for the ``/metrics?format=prometheus`` cluster view.
Errors are split by class: ``client_errors`` (4xx — the caller's
problem) vs ``server_errors`` (5xx, plus status 0 = the connection
died before a response was written), so a burst of 404s or partial-
answer-tolerant clients cannot pollute the server fault signal.
Named gauges (set directly or computed-on-read via ``gauge_fn``) carry
the lambda freshness surface: consumer lag, model generation age,
batch cadence.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from ..obs.prom import Histogram

__all__ = ["MetricsRegistry"]

# per-route latency ring-buffer capacity; percentiles reflect the most
# recent window, counters are cumulative
_RESERVOIR = 8192


class _RouteStats:
    __slots__ = ("count", "client_errors", "server_errors", "total_ms",
                 "latencies", "pos", "filled", "hist")

    def __init__(self):
        self.count = 0
        self.client_errors = 0
        self.server_errors = 0
        self.total_ms = 0.0
        self.latencies = np.zeros(_RESERVOIR, dtype=np.float32)
        self.pos = 0
        self.filled = False
        self.hist = Histogram()

    def record(self, status: int, ms: float,
               trace_id: str | None = None) -> None:
        self.count += 1
        if 400 <= status < 500:
            self.client_errors += 1
        elif status >= 500 or status == 0:
            # status 0 = connection died before a response was written —
            # indistinguishable from a server fault, counted as one
            self.server_errors += 1
        self.total_ms += ms
        self.latencies[self.pos] = ms
        self.pos += 1
        if self.pos >= _RESERVOIR:
            self.pos = 0
            self.filled = True
        # sampled requests stamp their bucket with an exemplar so the
        # cluster-wide p99 resolves to a concrete trace (obs/prom.py)
        self.hist.observe(ms, trace_id)

    def snapshot(self) -> dict:
        window = self.latencies[:self.pos] if not self.filled \
            else self.latencies
        out = {
            "count": self.count,
            # back-compat total alongside the class split
            "errors": self.client_errors + self.server_errors,
            "client_errors": self.client_errors,
            "server_errors": self.server_errors,
            "mean_ms": round(self.total_ms / self.count, 3)
            if self.count else 0.0,
        }
        if len(window):
            p50, p95, p99 = np.percentile(window, (50, 95, 99))
            out.update(p50_ms=round(float(p50), 3),
                       p95_ms=round(float(p95), 3),
                       p99_ms=round(float(p99), 3))
        return out

    def prometheus_snapshot(self) -> dict:
        return {
            "count": self.count,
            "client_errors": self.client_errors,
            "server_errors": self.server_errors,
            "latency_ms": self.hist.snapshot(),
        }


class MetricsRegistry:
    """Thread-safe per-route request stats + named event counters and
    gauges."""

    def __init__(self):
        self._routes: dict[str, _RouteStats] = {}
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._gauge_fns: dict[str, Callable[[], float | None]] = {}
        self._lock = threading.Lock()

    def record(self, route: str, status: int, seconds: float,
               trace_id: str | None = None) -> None:
        with self._lock:
            stats = self._routes.get(route)
            if stats is None:
                stats = self._routes[route] = _RouteStats()
            stats.record(status, seconds * 1000.0, trace_id)

    def inc(self, counter: str, by: int = 1) -> None:
        """Bump a named cumulative counter (e.g. the cluster gateway's
        ``partial_answers``); surfaced by counters_snapshot()."""
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + by

    def set_gauge(self, gauge: str, value: float) -> None:
        """Set an instantaneous gauge (the speed layer's freshness
        measurements land here after each micro-batch)."""
        with self._lock:
            self._gauges[gauge] = value

    def gauge_fn(self, gauge: str,
                 fn: Callable[[], float | None]) -> None:
        """Register a computed-on-read gauge (consumer lag, model
        generation age — values that are a subtraction at read time,
        not an event at write time).  Evaluated best-effort at
        snapshot; a raising fn reports null rather than failing
        ``/metrics``."""
        with self._lock:
            self._gauge_fns[gauge] = fn

    def counters_snapshot(self) -> dict:
        with self._lock:
            return dict(sorted(self._counters.items()))

    def gauge_value(self, gauge: str) -> float | None:
        """Evaluate ONE gauge by name (set value or computed fn),
        best-effort.  The SLO engine's kind=gauge objectives read their
        watched gauge through this instead of ``gauges_snapshot`` so
        evaluation cannot recurse through the engine's own exported
        ``slo_*`` gauges."""
        with self._lock:
            if gauge in self._gauges:
                return self._gauges[gauge]
            fn = self._gauge_fns.get(gauge)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — gauges are best-effort
            return None

    def gauges_snapshot(self) -> dict:
        with self._lock:
            out = dict(self._gauges)
            fns = list(self._gauge_fns.items())
        for name, fn in fns:
            try:
                out[name] = fn()
            except Exception:  # noqa: BLE001 — gauges are best-effort
                out[name] = None
        return dict(sorted(out.items()))

    def snapshot(self) -> dict:
        """{route: {count, errors, client_errors, server_errors,
        mean_ms, p50_ms, p95_ms, p99_ms}}"""
        with self._lock:
            return {route: stats.snapshot()
                    for route, stats in sorted(self._routes.items())}

    def prometheus_snapshot(self, gauges: bool = True) -> dict:
        """The mergeable structured view (obs/prom.py): per-route
        counts, error classes, and latency bucket counts, plus named
        counters and gauges.  ``gauges=False`` skips gauge-fn
        evaluation — the SLO engine reads bucket counters from inside
        a gauge fn, and evaluating gauges there would recurse."""
        with self._lock:
            routes = {route: stats.prometheus_snapshot()
                      for route, stats in sorted(self._routes.items())}
            counters = dict(sorted(self._counters.items()))
        out = {"routes": routes, "counters": counters}
        if gauges:
            out["gauges"] = self.gauges_snapshot()
        return out
