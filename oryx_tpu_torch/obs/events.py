"""Wide-event request log: one JSONL line per sampled request.

Counterpart of ``oryx_tpu/obs/events.py``, whole.  The tracer's rings
are in-memory and bounded — exactly right for "what
was that request doing five minutes ago", useless for offline tooling
once the ring ages out.  This module is the durable sibling: for every
SAMPLED request (and, regardless of sampling, every server-error and
every request past ``always-slow-ms``) one wide, flat JSON line lands
in a bounded, size-rotated file: route, status, latency, trace id, and
whatever the request's own spans already measured — batcher queue
wait, batch size, the kernel-route decision, shard fan-out counts.
The canonical field set is :data:`FIELDS` (linted against the
docs/OBSERVABILITY.md schema table); lines omit fields they have no
value for.

The hot path stays cheap: an unsampled, fast, successful request pays
``should_emit`` (three comparisons); with the log unconfigured the
dispatcher pays one attribute check.  Writes are strictly best-effort:
a full disk (chaos point ``obs-event-disk-full``) drops the line and
bumps ``event_write_failures`` — the request is long since answered
and must never feel it.

Files are ``events-<service>-<pid>.jsonl`` under ``oryx.obs.events.dir``
(per-process names, so replicas sharing a host never interleave), and
rotate at ``max-bytes`` keeping ``max-files`` generations.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..common import clock as clockmod
from ..resilience import faults

__all__ = ["FIELDS", "WideEventLog", "events_from_config"]

# the wide-event schema, linted against docs/OBSERVABILITY.md; lines
# carry a subset (a router line has shard fields, a replica line has
# batcher fields, an unsampled error line has neither).  The tail
# three: kernel_route may be ``ann``, ann_index_fallbacks/ingest_sheds
# ride as context fields (context_fn), and speed_shard stamps the
# sharded speed side-door's lines (static_fields)
FIELDS = ("ts_ms", "route", "status", "latency_ms", "trace_id",
          "sampled", "queue_wait_ms", "batch_size", "kernel_route",
          "shards_called", "shard_errors", "shards_merged",
          "ann_index_fallbacks", "ingest_sheds", "speed_shard")


def _derive_span_fields(spans) -> dict:
    """Pull the span-measured facts into flat fields: the request's
    OWN tier's spans only (a router derives fan-out, a replica derives
    its batcher split) — no cross-process join at write time."""
    out: dict = {}
    shards = errs = 0
    for s in spans or ():
        name = s.get("name")
        if name == "router.shard_call":
            shards += 1
            if s.get("status") == "error":
                errs += 1
        elif name == "serving.queue_wait":
            out["queue_wait_ms"] = round(max(
                out.get("queue_wait_ms", 0.0),
                float(s.get("duration_ms") or 0.0)), 3)
        elif name == "serving.device_execute":
            attrs = s.get("attrs") or {}
            if "batch_size" in attrs:
                out["batch_size"] = attrs["batch_size"]
            if "kernel_route" in attrs:
                out["kernel_route"] = attrs["kernel_route"]
        elif name == "router.merge":
            merged = (s.get("attrs") or {}).get("shards_merged")
            if merged is not None:
                out["shards_merged"] = merged
    if shards:
        out["shards_called"] = shards
        if errs:
            out["shard_errors"] = errs
    return out


class WideEventLog:
    """Bounded, size-rotated JSONL request log."""

    def __init__(self, directory: str, service: str,
                 max_bytes: int = 16 * 1024 * 1024, max_files: int = 4,
                 always_slow_ms: int | None = None, registry=None,
                 static_fields: dict | None = None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(
            directory, f"events-{service}-{os.getpid()}.jsonl")
        self.max_bytes = int(max_bytes)
        self.max_files = max(1, int(max_files))
        self.always_slow_ms = always_slow_ms
        self._registry = registry
        # per-process identity stamped on every line (the speed tier's
        # speed_shard id); merged before the context fn so dynamic
        # context can never clobber identity
        self.static_fields = dict(static_fields or {})
        # tier-wired callable -> extra fields for the CURRENT line
        # (serving adds ann_index_fallbacks, the router adds
        # ingest_sheds); best-effort, evaluated only on emitted lines
        self.context_fn = None
        self._lock = threading.Lock()
        self._f = None
        self._size = 0
        self._closed = False
        self.emitted = 0
        self.dropped = 0

    # -- gate (the per-request cost) -----------------------------------------

    def should_emit(self, status: int, latency_ms: float,
                    sampled: bool) -> bool:
        if sampled:
            return True
        if status >= 500 or status == 0:
            return True  # server faults always leave evidence
        return self.always_slow_ms is not None \
            and latency_ms >= self.always_slow_ms

    # -- write side ----------------------------------------------------------

    def emit(self, route: str, status: int, latency_ms: float,
             trace_id: str | None, spans=None) -> None:
        """Append one event line; NEVER raises (best-effort contract:
        drop + ``event_write_failures`` on any error, including the
        ``obs-event-disk-full`` chaos stand-in for ENOSPC)."""
        try:
            event = {"ts_ms": int(clockmod.now() * 1000), "route": route,
                     "status": status,
                     "latency_ms": round(latency_ms, 3)}
            if trace_id:
                event["trace_id"] = trace_id
                event["sampled"] = True
            else:
                event["sampled"] = False
            event.update(_derive_span_fields(spans))
            fn = self.context_fn
            if fn is not None:
                try:
                    event.update(fn() or {})
                except Exception:  # noqa: BLE001 — context is best-effort
                    pass
            if self.static_fields:
                event.update(self.static_fields)
            line = json.dumps(event, separators=(",", ":")) + "\n"
            data = line.encode("utf-8")
            with self._lock:
                if self._closed:
                    # a handler thread outliving close() must not
                    # resurrect the file handle (it would leak)
                    self.dropped += 1
                    return
                # chaos seam: a raising write (disk full) drops the
                # line, never the request
                faults.fire("obs-event-disk-full")
                if self._f is None:
                    self._f = open(self.path, "ab")
                    self._size = self._f.tell()
                elif self._size + len(data) > self.max_bytes:
                    self._rotate_locked()
                self._f.write(data)
                self._f.flush()
                self._size += len(data)
                self.emitted += 1
        except Exception:  # noqa: BLE001 — observability is best-effort
            # re-acquire: the with-block released on unwind, and a
            # bare += here would race concurrent droppers (lost
            # updates on the evidence counter — guarded-by lint)
            with self._lock:
                self.dropped += 1
            if self._registry is not None:
                try:
                    self._registry.inc("event_write_failures")
                except Exception:  # noqa: BLE001 — best-effort
                    pass

    def _rotate_locked(self) -> None:
        """events.jsonl -> .1 -> .2 ... oldest beyond max-files dies.
        Caller holds ``_lock`` (the ``_locked`` suffix contract)."""
        self._f.close()
        self._f = None
        oldest = f"{self.path}.{self.max_files - 1}"
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(self.max_files - 2, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        if self.max_files > 1:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.unlink(self.path)
        self._f = open(self.path, "ab")
        self._size = 0

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "emitted": self.emitted,
                    "dropped": self.dropped, "bytes": self._size}

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None


def events_from_config(config, service: str, registry=None,
                       static_fields: dict | None = None
                       ) -> WideEventLog | None:
    """Build the tier's event log from ``oryx.obs.events.*``; None when
    no directory is configured (the dispatcher then pays one attribute
    check per request)."""
    base = "oryx.obs.events"
    directory = config.get_optional_string(f"{base}.dir")
    if not directory:
        return None
    return WideEventLog(
        directory, service,
        max_bytes=config.get_int(f"{base}.max-bytes"),
        max_files=config.get_int(f"{base}.max-files"),
        always_slow_ms=config.get_optional_int(f"{base}.always-slow-ms"),
        registry=registry, static_fields=static_fields)
