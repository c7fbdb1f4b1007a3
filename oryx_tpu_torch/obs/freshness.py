"""Lambda freshness gauges: how stale is what each tier serves?

Counterpart of ``oryx_tpu/obs/freshness.py``, whole.

The lambda architecture's whole promise is bounded staleness — batch
recomputes, speed patches the gap — but until now nothing MEASURED the
gap.  Four signals close it, all registered as computed-on-read gauges
(lambda_rt/metrics.py ``gauge_fn``) or set per micro-batch, and all
named in docs/OBSERVABILITY.md's catalog:

- ``update_lag_records`` / ``input_lag_records`` — how far a consumer
  trails its topic head (replay-style consumers count records yielded
  vs the head; group consumers compare committed offsets).
- ``model_generation_age_sec`` — time since the tier last absorbed a
  MODEL/MODEL-REF publish: the batch layer's cadence made visible from
  the consuming side.
- ``ingest_to_servable_ms`` — end-to-end: the serving front end stamps
  every input record with a ``ts`` header at ingest
  (serving/framework.py ``send_input``), and the speed layer reports
  the oldest stamp in each micro-batch against the moment its UP
  deltas were published, i.e. the worst-case time from a client's
  ``/ingest`` to the update being servable.

Everything here is best-effort: a raising gauge fn reports null
(MetricsRegistry evaluates them under try/except), and records without
headers simply don't feed the end-to-end gauge.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

from ..common import clock as clockmod
from ..kafka.api import KEY_MODEL, KEY_MODEL_REF, KeyMessage

__all__ = ["UpdateStreamTap", "topic_lag_fn", "group_lag_fn",
           "oldest_ingest_ts_ms"]


class UpdateStreamTap:
    """Passive tap on an update-topic replay: counts records yielded
    and notes when a model generation (MODEL/MODEL-REF) goes by.

    Single-writer (the consumer thread), many readers (gauge
    evaluation) — plain attribute stores are atomic in CPython, so no
    lock.  ``wrap`` resets the count when the wrapped iterator starts,
    which is exactly the resubscribe-replays-from-zero contract of
    ``run_with_resubscribe`` + ``from_beginning=True``.
    """

    def __init__(self):
        self._count = 0
        self._last_model_mono: float | None = None

    def wrap(self, it: Iterable[KeyMessage]) -> Iterator[KeyMessage]:
        self._count = 0
        for km in it:
            self._count += 1
            if km.key in (KEY_MODEL, KEY_MODEL_REF):
                self._last_model_mono = clockmod.monotonic()
            yield km

    @property
    def consumed(self) -> int:
        return self._count

    def model_age_sec(self) -> float | None:
        """Seconds since the last model generation went by; None until
        one has."""
        t = self._last_model_mono
        return None if t is None else round(clockmod.monotonic() - t, 3)


def topic_lag_fn(broker_uri: str, topic: str,
                 consumed_fn: Callable[[], int]) -> Callable[[], int]:
    """Gauge fn: records between a from-the-beginning replay consumer
    and the topic head.  Clamped at 0 — a mid-resubscribe count reset
    must never report negative lag."""

    def fn() -> int:
        from ..kafka.inproc import resolve_broker
        latest = resolve_broker(broker_uri).latest_offsets(topic)
        return max(0, sum(latest) - consumed_fn())

    return fn


def group_lag_fn(broker_uri: str, topic: str,
                 group: str) -> Callable[[], int]:
    """Gauge fn: committed-offset lag of a group consumer (the speed
    and batch micro-batch drains) behind the topic head."""

    def fn() -> int:
        from ..kafka.inproc import resolve_broker
        broker = resolve_broker(broker_uri)
        latest = broker.latest_offsets(topic)
        committed = broker.get_offsets(group, topic)
        return sum(max(0, e - (c or 0))
                   for e, c in zip(latest, committed))

    return fn


def oldest_ingest_ts_ms(records: Iterable[KeyMessage]) -> int | None:
    """The smallest ``ts`` record header (ingest epoch ms) in a
    micro-batch — the record that has waited longest, so the gauge it
    feeds is worst-case freshness.  None when nothing carried a stamp
    (records produced outside the serving front end)."""
    oldest: int | None = None
    for km in records:
        h = km.headers
        if not h:
            continue
        ts = h.get("ts")
        if ts is None:
            continue
        try:
            t = int(ts)
        except (TypeError, ValueError):
            continue
        if oldest is None or t < oldest:
            oldest = t
    return oldest
