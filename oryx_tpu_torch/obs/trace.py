"""Sampled distributed span tracer with W3C ``traceparent`` context.

Counterpart of ``oryx_tpu/obs/trace.py``, whole.

Dapper's (Sigelman et al., 2010) two load-bearing ideas, sized for this
runtime: (1) sampling decided once at the trace root and carried in the
propagated context, so the common unsampled request costs one branch
and zero allocation at every instrumentation point; (2) spans recorded
locally per process into a bounded in-memory ring, joined by trace id
at read time (``/admin/traces`` on each tier) instead of shipped
through a collector the runtime would then depend on.

Context crosses process boundaries two ways:

- HTTP: the ``traceparent`` request header
  (``00-<trace-id>-<span-id>-<flags>``), sent by the router's scatter
  transport and honored by every serving front end, which also echoes
  the trace id back as ``X-Oryx-Trace`` on sampled responses so a
  client can correlate a slow answer with its recorded trace.
- Kafka: a ``traceparent`` record header attached by ``/ingest``-family
  writes, so the speed layer can attribute its fold-in work to the
  originating request's trace.

Recording is STRICTLY best-effort: a raising recorder (the
``obs-trace-drop`` chaos point stands in for any internal failure)
degrades that span to a no-op and bumps ``record_failures`` — tracing
must never fail a request.  Everything is config-gated under
``oryx.obs.tracing.*``; the span-name taxonomy lives in
docs/OBSERVABILITY.md and is linted by tests/test_torch_obs_catalog.py.
"""

from __future__ import annotations

import json
import logging
import random
import threading
from collections import OrderedDict

from ..common import clock as clockmod
from ..resilience import faults

_log = logging.getLogger(__name__)

__all__ = ["Span", "NOOP_SPAN", "Tracer", "parse_traceparent",
           "format_traceparent", "unsampled_traceparent",
           "tracer_from_config"]

_FLAG_SAMPLED = 0x01
# spans kept per trace: a runaway instrumentation loop must not let one
# trace eat the whole ring's memory
_MAX_SPANS_PER_TRACE = 512


def parse_traceparent(value: str | None):
    """``(trace_id, span_id, sampled)`` from a W3C traceparent header,
    or None when absent/malformed — malformed context starts a fresh
    trace, never an error (the W3C processing model)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16
            or len(flags) != 2):
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        f = int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(f & _FLAG_SAMPLED)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def unsampled_traceparent() -> str:
    """A valid context whose flags say NOT sampled — propagated on the
    internal hops of unsampled requests so downstream tiers honor the
    root's decision instead of re-rolling their own sampling dice.
    Ids are fresh per call; callers cache ONE per process (the
    receiving side returns NOOP_SPAN and never records them), keeping
    the unsampled hot path allocation-free."""
    return format_traceparent(_new_trace_id(), _new_span_id(),
                              sampled=False)


def _new_trace_id() -> str:
    return f"{random.getrandbits(128) or 1:032x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(64) or 1:016x}"


class _NoopSpan:
    """The shared do-nothing span handed out for every unsampled
    request: one instance for the whole process, so the unsampled hot
    path allocates nothing and every instrumentation point is one
    ``span.sampled`` branch."""

    __slots__ = ()
    sampled = False
    trace_id = None
    span_id = None
    parent_id = None

    def set_attr(self, key, value) -> None:
        pass

    def end(self, status: str | None = None) -> None:
        pass

    def traceparent(self) -> None:
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One sampled span.  Usable as a context manager (sets itself as
    the calling thread's current span for the duration) or ended
    explicitly with :meth:`end`."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "t_start", "attrs", "status", "_prev")
    sampled = True

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str | None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.t_start = clockmod.monotonic()
        self.attrs: dict = {}
        self.status = "ok"
        self._prev = None

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)

    def end(self, status: str | None = None) -> None:
        if status is not None:
            self.status = status
        self._tracer._record(self.name, self.trace_id, self.span_id,
                             self.parent_id, self.t_start,
                             clockmod.monotonic(), self.attrs, self.status)

    def __enter__(self):
        self._prev = self._tracer._swap(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
            self.status = "error"
        self.end()
        self._tracer._swap(self._prev)
        return False


class Tracer:
    """Per-process span recorder + sampling/propagation policy."""

    def __init__(self, service: str, sample_ratio: float = 0.01,
                 max_traces: int = 256,
                 slow_request_ms: int | None = None):
        self.service = service
        self.sample_ratio = float(sample_ratio)
        self.max_traces = int(max_traces)
        self.slow_request_ms = slow_request_ms
        # recorder failures degraded to no-ops (the best-effort contract)
        self.record_failures = 0
        self._local = threading.local()
        self._lock = threading.Lock()
        # trace id -> finished span dicts, oldest trace evicted first
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        # anchor so spans recorded from stored monotonic stamps (the
        # batcher's enqueue time) still carry wall-clock start times
        self._mono_anchor = clockmod.now() - clockmod.monotonic()

    # -- thread-current context ---------------------------------------------

    def current(self):
        """The calling thread's active span (NOOP_SPAN when none)."""
        return getattr(self._local, "span", None) or NOOP_SPAN

    def _swap(self, span):
        prev = getattr(self._local, "span", None)
        self._local.span = span
        return prev

    # -- span creation -------------------------------------------------------

    def begin_request(self, name: str,
                      traceparent: str | None = None):
        """Server-side request span: a sampled inbound ``traceparent``
        is continued (the root already decided), an explicitly
        UNsampled one is honored, anything else samples locally.
        Returns NOOP_SPAN for the unsampled case — one branch, no
        allocation — and installs a sampled span as the thread's
        current span (cleared by :meth:`end_request`)."""
        ctx = parse_traceparent(traceparent) if traceparent else None
        if ctx is not None:
            trace_id, parent_id, sampled = ctx
            if not sampled:
                return NOOP_SPAN
        elif (self.sample_ratio >= 1.0
                or random.random() < self.sample_ratio):
            trace_id, parent_id = _new_trace_id(), None
        else:
            return NOOP_SPAN
        span = Span(self, name, trace_id, parent_id)
        self._swap(span)
        return span

    def end_request(self, span, status: int = 0,
                    route: str | None = None) -> None:
        if not span.sampled:
            return
        self._swap(None)
        if route:
            span.attrs["route"] = route
        span.attrs["http.status"] = status
        span.end("error" if status >= 500 or status == 0 else "ok")
        if self.slow_request_ms is not None:
            dur_ms = (clockmod.monotonic() - span.t_start) * 1000.0
            if dur_ms >= self.slow_request_ms:
                self._dump_slow(span.trace_id, route, dur_ms)

    def span(self, name: str):
        """Child of the calling thread's current span; NOOP_SPAN when
        the request is unsampled.  Use as a context manager."""
        cur = self.current()
        if not cur.sampled:
            return NOOP_SPAN
        return Span(self, name, cur.trace_id, cur.span_id)

    def child_span(self, parent, name: str):
        """Child of an explicit parent span — for work handed to other
        threads (scatter fan-out), where thread-local context does not
        follow."""
        if parent is None or not parent.sampled:
            return NOOP_SPAN
        return Span(self, name, parent.trace_id, parent.span_id)

    def record_span(self, name: str, trace_ctx: tuple[str, str] | None,
                    start_mono: float, end_mono: float,
                    attrs: dict | None = None,
                    status: str = "ok") -> None:
        """Retroactive span from stored monotonic stamps and a
        ``(trace_id, parent_span_id)`` context captured earlier (the
        batcher records queue-wait this way after the fact)."""
        if not trace_ctx:
            return
        self._record(name, trace_ctx[0], _new_span_id(), trace_ctx[1],
                     start_mono, end_mono, attrs or {}, status)

    # -- recording (best-effort, bounded) ------------------------------------

    def _record(self, name, trace_id, span_id, parent_id, start_mono,
                end_mono, attrs, status) -> None:
        try:
            # chaos seam: a raising recorder must degrade to a no-op +
            # counter, never fail the request being traced
            faults.fire("obs-trace-drop")
            span = {
                "name": name,
                "service": self.service,
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_id": parent_id,
                "start_ms": round(
                    (start_mono + self._mono_anchor) * 1000.0, 3),
                "duration_ms": round((end_mono - start_mono) * 1000.0, 3),
                "attrs": attrs,
                "status": status,
            }
            with self._lock:
                spans = self._traces.get(trace_id)
                if spans is None:
                    while len(self._traces) >= self.max_traces:
                        self._traces.popitem(last=False)
                    spans = self._traces[trace_id] = []
                if len(spans) < _MAX_SPANS_PER_TRACE:
                    spans.append(span)
        except Exception:  # noqa: BLE001 — observability is best-effort
            # under the lock: concurrent failing recorders must not
            # lose increments of the evidence counter
            with self._lock:
                self.record_failures += 1

    def _dump_slow(self, trace_id: str, route: str | None,
                   dur_ms: float) -> None:
        try:
            with self._lock:
                spans = list(self._traces.get(trace_id) or ())
            _log.warning(
                "SLOW REQUEST %.1f ms (threshold %d ms) route=%s "
                "trace=%s spans=%s", dur_ms, self.slow_request_ms,
                route, trace_id, json.dumps(spans))
        except Exception:  # noqa: BLE001 — best-effort
            with self._lock:
                self.record_failures += 1

    # -- read side -----------------------------------------------------------

    def spans_for(self, trace_id: str) -> list[dict]:
        """The finished spans of one trace from this process's ring
        (empty when unknown/evicted) — the wide-event log reads the
        just-finished request's spans through this."""
        with self._lock:
            return list(self._traces.get(trace_id) or ())

    def traces_snapshot(self, limit: int = 64) -> dict:
        """Newest ``limit`` finished traces, each a flat span list the
        caller reassembles into a tree via parent_id."""
        with self._lock:
            ids = list(self._traces)[-max(1, limit):]
            return {tid: list(self._traces[tid]) for tid in ids}


def tracer_from_config(config, service: str) -> Tracer | None:
    """Build the layer's tracer from ``oryx.obs.tracing.*``; None when
    tracing is disabled (every instrumentation point then costs one
    ``is None`` check)."""
    t = "oryx.obs.tracing"
    if not config.get_bool(f"{t}.enabled"):
        return None
    return Tracer(
        service,
        sample_ratio=config.get_double(f"{t}.sample-ratio"),
        max_traces=config.get_int(f"{t}.max-traces"),
        slow_request_ms=config.get_optional_int(f"{t}.slow-request-ms"))
