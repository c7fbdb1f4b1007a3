"""Bounded-producer admission for the write path (the durable-ack
contract's other half).

Counterpart of ``oryx_tpu/serving/ingest.py``, whole.

``send_input`` blocks its handler thread until the broker append
returns, so a 202 means the record is durable in the input topic.  The
missing half of that contract is overload: with the broker slow or the
write rate past what it sustains, un-gated ingest stacks blocked
handler threads without bound, an open-loop spiral.  This gate
sheds it, wrapping ONLY the ``send_input`` /
``send_input_many`` produce (never health, admin, or read routes —
those must stay open so operators can see into an overloaded tier):

- **max-inflight-sends** — a hard cap on concurrently executing broker
  appends across the process; in-flight count IS the producer queue
  depth, because each send holds its handler thread.
- **send-lag-high-ms** — *measured* send lag: an EWMA of recent append
  durations.  When the broker demonstrably takes longer than the
  threshold per append AND a send is already in flight, new writes
  shed at the door before they join the convoy.  With nothing in
  flight there is no convoy to join, so the request is admitted as
  the probe whose measurement re-opens (or re-confirms) the gate —
  a latched-open gate with no traffic to re-measure it would shed
  forever.

Both gates 0 (the shipped default) = disabled.  A shed is a fast
``503`` with ``Retry-After`` (``OryxServingException.headers``) and an
``ingest_sheds`` count — so the ingest contract becomes "202 means
durable in the input topic, 503 means retry — nothing in between".
"""

from __future__ import annotations

import threading

from ..api.serving import OryxServingException
from ..common import clock as clockmod

__all__ = ["IngestGate"]

# EWMA weight of the newest send sample (~last 10 sends dominate):
# reactive enough to open the gate within a burst, smooth enough that
# one slow append doesn't shed
_ALPHA = 0.2


class IngestGate:
    """``with gate.admitted(metrics, n):`` around the produce;
    constructed from ``oryx.serving.ingest.*``."""

    def __init__(self, config, metrics=None):
        i = "oryx.serving.ingest"
        self.max_inflight = config.get_int(f"{i}.max-inflight-sends")
        self.send_lag_high_ms = config.get_int(f"{i}.send-lag-high-ms")
        self.retry_after_sec = max(1, config.get_int(
            f"{i}.retry-after-sec"))
        self._metrics = metrics
        self._lock = threading.Lock()
        self.inflight = 0
        self.sheds = 0
        self._ewma_ms: float | None = None

    @property
    def enabled(self) -> bool:
        return self.max_inflight > 0 or self.send_lag_high_ms > 0

    def send_lag_ms(self) -> float | None:
        with self._lock:
            return None if self._ewma_ms is None \
                else round(self._ewma_ms, 3)

    def admitted(self, metrics=None, n: int = 1) -> "_Admission":
        """Admission around one produce of ``n`` records; raises the
        503-with-Retry-After OryxServingException on shed.  The send
        duration measured inside feeds the lag EWMA."""
        with self._lock:
            # the lag gate needs inflight > 0: with no send in flight
            # there is no convoy, and this request is the probe whose
            # measured duration re-opens a gate the EWMA latched
            shed = (self.max_inflight > 0
                    and self.inflight >= self.max_inflight) or \
                   (self.send_lag_high_ms > 0
                    and self.inflight > 0
                    and self._ewma_ms is not None
                    and self._ewma_ms > self.send_lag_high_ms)
            if shed:
                self.sheds += 1
            else:
                self.inflight += 1
        if shed:
            for m in (metrics, self._metrics):
                if m is not None:
                    # inc takes its own lock; called outside ours
                    m.inc("ingest_sheds")
                    break
            raise OryxServingException(
                503, "ingest overloaded; retry later",
                headers={"Retry-After": str(self.retry_after_sec)})
        return _Admission(self)

    def _finish(self, elapsed_ms: float) -> None:
        with self._lock:
            self.inflight -= 1
            self._ewma_ms = elapsed_ms if self._ewma_ms is None else \
                _ALPHA * elapsed_ms + (1.0 - _ALPHA) * self._ewma_ms

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "inflight": self.inflight,
                    "sheds": self.sheds,
                    "send_lag_ms": None if self._ewma_ms is None
                    else round(self._ewma_ms, 3),
                    "max_inflight_sends": self.max_inflight,
                    "send_lag_high_ms": self.send_lag_high_ms}


class _Admission:
    """Times the admitted produce; always releases, whatever raised."""

    def __init__(self, gate: IngestGate):
        self._gate = gate
        self._t0 = 0.0

    def __enter__(self) -> "_Admission":
        self._t0 = clockmod.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._gate._finish(
            (clockmod.monotonic() - self._t0) * 1000.0)
