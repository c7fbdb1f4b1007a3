"""Measured-queue-wait admission control for the scatter-gather router.

Counterpart of ``oryx_tpu/cluster/admission.py``, copied whole.

The r06 grid's unsustained rungs showed the failure shape of an
un-gated front end: past the device roofline, queues grow without
bound, every request's latency inherits the whole backlog, and
throughput COLLAPSES below what the hardware could sustain — the
classic open-loop overload spiral.  The honest degrade is to refuse
work the cluster demonstrably cannot finish: a fast ``503`` with a
``Retry-After`` header costs microseconds, keeps the admitted
requests' latency bounded, and gives well-behaved clients an explicit
backoff signal.

Two measured gates, both off by default (``oryx.cluster.admission.*``):

- **max-inflight** — a hard cap on concurrently executing data-plane
  requests at the router.  The scatter path blocks a handler thread
  per request, so in-flight count IS the router's queue depth.
- **queue-wait-high-ms** — the cluster's *measured* scoring queue wait
  (every shard envelope piggybacks the replica batcher's
  enqueue→dispatch EWMA; the scatter keeps the freshest value per
  replica, and the cluster signal is max over shards of min over each
  shard's replica group).  When even the best routing choice would
  queue longer than the threshold, new work is shed at the door.

Only routes marked ``admission=True`` (the scan/scatter data plane)
are gated; ``/ready``, ``/metrics`` and the admin surface stay open so
operators can see INTO an overloaded router.  Rejections count as
``admission_rejects`` on the router's metrics.
"""

from __future__ import annotations

import threading

__all__ = ["AdmissionController"]


class AdmissionController:
    """try_acquire()/release() around a request; constructed from
    ``oryx.cluster.admission.*`` (both gates 0 = disabled)."""

    def __init__(self, config, scatter, metrics=None):
        c = "oryx.cluster.admission"
        self.max_inflight = config.get_int(f"{c}.max-inflight")
        self.queue_wait_high_ms = config.get_int(
            f"{c}.queue-wait-high-ms")
        self.retry_after_sec = max(1, config.get_int(
            f"{c}.retry-after-sec"))
        self._scatter = scatter
        self._metrics = metrics
        self._lock = threading.Lock()
        self.inflight = 0
        self.rejected = 0

    @property
    def enabled(self) -> bool:
        return self.max_inflight > 0 or self.queue_wait_high_ms > 0

    def try_acquire(self) -> tuple[bool, int]:
        """(admitted, retry-after seconds).  Admitted callers MUST
        release()."""
        with self._lock:
            if self.max_inflight > 0 \
                    and self.inflight >= self.max_inflight:
                return self._reject_locked()
            self.inflight += 1
        if self.queue_wait_high_ms > 0:
            qw = self._scatter.cluster_queue_wait_ms()
            if qw is not None and qw > self.queue_wait_high_ms:
                with self._lock:
                    self.inflight -= 1
                    return self._reject_locked()
        return True, 0

    def _reject_locked(self) -> tuple[bool, int]:
        self.rejected += 1
        if self._metrics is not None:
            # inc takes its own lock; safe under ours (no inverse order)
            self._metrics.inc("admission_rejects")
        return False, self.retry_after_sec

    def release(self) -> None:
        with self._lock:
            self.inflight -= 1

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "inflight": self.inflight,
                    "rejected": self.rejected,
                    "max_inflight": self.max_inflight,
                    "queue_wait_high_ms": self.queue_wait_high_ms}
