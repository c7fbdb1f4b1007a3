"""Flight recorder — anomaly-triggered black-box capture.

Counterpart of ``oryx_tpu/obs/flight.py``, whole; its bundles carry the
device-time snapshot of the card's serve and measure brackets and, on a
host with a card, one key the reference's lack: ``device_memory``, each
card's memory statistics (``obs/profile.device_memory_stats``; absent
without a card, where the reference's would be empty too).

Live gauges tell the operator what is happening *now*; when an SLO
pages, the question is what happened in the 60 seconds *before*.  Each
process keeps bounded, allocation-cheap ring buffers of the recent
request stream:

- **events ring** — one compact tuple per request (the first five
  wide-event FIELDS from obs/events.py: ts_ms, route, status,
  latency_ms, trace_id), fed unconditionally by the HTTP dispatcher;
- **spans ring** — finished-span summaries of *sampled* requests
  (name, duration_ms, trace_id), so the bundle carries the stage
  anatomy of the traffic that was traced;
- **ticks ring** — coarse-cadence counter deltas plus a full gauge
  sample per tick, built from the :class:`MetricsRegistry` snapshot
  walkers — the "what was trending" axis the instantaneous rings
  cannot carry.

A *trigger* — SLO transition to ``page`` (wired via
``SloEngine.on_page``), a 5xx/status-0 burst, any chaos fault point
firing (``faults.add_fire_listener``), process atexit, or a manual
``POST /admin/flight/dump`` — atomically snapshots every ring plus the
resilience/breaker surface, the last SLO status, the device-time
accounting, and the diagnosis computed *at trigger time* into one
timestamped JSON bundle in the store (temp write + rename, the same
publish discipline as every other artifact).  The router fans a
cluster-wide dump out over the framed transport (scatter registry), so
one page yields one correlated bundle per live process, all sharing
the originating trigger id.

Debounce: local triggers within ``debounce-sec`` of the last dump are
counted (``flight_trigger_debounced``) and dropped — a page storm
yields ONE bundle.  A fanned-in trigger (explicit trigger id) bypasses
the window: a cluster-correlated capture must not be lost to a local
chaos dump moments earlier; same-id replays are deduped instead.

Chaos seams: ``flight-dump-disk-full`` (ENOSPC mid-bundle — the
partial temp file is discarded, ``flight_dump_failures`` counts it,
the process is unaffected) and ``flight-trigger-storm`` (duplicate
mode doubles a trigger; the debounce window must collapse the pair to
one bundle).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from collections import deque

from ..common import clock as clockmod
from ..common import store
from ..resilience import faults
from ..resilience.policy import resilience_snapshot
from .events import FIELDS
from .profile import device_memory_stats

__all__ = ["RING_EVENT_FIELDS", "RING_SPAN_FIELDS", "BUNDLE_FIELDS",
           "FlightRecorder", "flight_from_config"]

# ring tuple layouts, reusing the wide-event schema prefix so a bundle
# row and an events.jsonl line name the same facts the same way
RING_EVENT_FIELDS = FIELDS[:5]
RING_SPAN_FIELDS = ("name", "duration_ms", "trace_id")

# top-level bundle keys, linted against the docs/OBSERVABILITY.md
# catalog by the diagnose-catalog pass (a renamed key must take its
# documentation with it)
BUNDLE_FIELDS = ("trigger_id", "trigger_reason", "trigger_detail",
                 "ts_ms", "service", "pid", "flight_events",
                 "flight_spans", "flight_ticks", "counters", "gauges",
                 "routes", "resilience", "slo", "device_time",
                 "diagnosis", "debounced_triggers")

# distinguishes same-service recorders sharing a pid (in-process
# multi-replica tests); monotone, process-global
_INSTANCE_LOCK = threading.Lock()
_INSTANCE_SEQ = 0


def _next_instance() -> int:
    global _INSTANCE_SEQ
    with _INSTANCE_LOCK:
        _INSTANCE_SEQ += 1
        return _INSTANCE_SEQ


def _safe(fn):
    """Best-effort bundle section: a raising collector yields None,
    never a lost bundle."""
    try:
        return fn()
    except Exception:  # noqa: BLE001 — forensics are best-effort
        return None


class FlightRecorder:
    """Per-process black box: lock-free rings on the hot path, an
    atomic JSON bundle on trigger.

    The request-path cost is :meth:`observe_request` — two ring
    appends (GIL-atomic ``deque.append``), one clock read, and a
    tick-due comparison; no locks, no allocation beyond the row tuple.
    Everything heavier (counter walking, gauge evaluation, dump I/O)
    happens on the coarse tick or at trigger time.
    """

    def __init__(self, service: str, registry=None, *, dir: str,
                 slo=None, accountant=None, diagnose_fn=None,
                 ring_events: int = 512, ring_spans: int = 128,
                 ring_ticks: int = 120, tick_sec: float = 5.0,
                 debounce_sec: float = 30.0, burst_errors: int = 8,
                 burst_window_sec: float = 10.0,
                 dump_on_exit: bool = True,
                 clock=None, wall=None):
        self.service = service
        self.dir = dir
        self._registry = registry
        self._slo = slo
        self._accountant = accountant
        self._diagnose_fn = diagnose_fn
        self.tick_sec = float(tick_sec)
        self.debounce_sec = float(debounce_sec)
        self.burst_errors = int(burst_errors)
        self.burst_window_sec = float(burst_window_sec)
        # injectable clocks (test determinism); None = the process clock
        self._clock = clock
        self._wall_fn = wall
        # hot-path rings: GIL-atomic appends, snapshot tolerates racing
        self._events_ring = deque(maxlen=int(ring_events))  # guarded-by: none — lock-free ring, append is GIL-atomic
        self._spans_ring = deque(maxlen=int(ring_spans))  # guarded-by: none — lock-free ring, append is GIL-atomic
        self._ticks_ring = deque(maxlen=int(ring_ticks))  # guarded-by: none — appended by the single tick winner
        self._lock = threading.Lock()
        self._next_tick = self._mono()  # guarded-by: _lock
        self._last_counters: dict = {}
        self._err_times: deque = deque()
        self._last_dump_t: float | None = None
        self._seen_ids: deque = deque(maxlen=64)
        self._debounced = 0
        self.dumps = 0  # guarded-by: _lock
        self.dump_failures = 0  # guarded-by: _lock
        self.last_dump: dict | None = None  # guarded-by: _lock
        self._instance = _next_instance()
        # re-entrancy fuse: a chaos seam firing inside our own dump
        # (store-write, flight-dump-disk-full) must not recurse
        self._tls = threading.local()
        # set once at wiring time by the router: fan_out(tid, reason)
        # scatters POST /admin/flight/dump to every live replica
        self.fan_out = None  # guarded-by: none — written once before traffic
        # pin ONE bound-method object: remove_fire_listener matches by
        # identity, and each `self._on_fault_fired` access would mint
        # a fresh bound method that never matches at close()
        self._fault_listener = self._on_fault_fired
        faults.add_fire_listener(self._fault_listener)
        self._dump_on_exit = dump_on_exit
        if dump_on_exit:
            atexit.register(self._atexit_dump)

    # -- clocks ---------------------------------------------------------------

    def _mono(self) -> float:
        return self._clock() if self._clock is not None \
            else clockmod.monotonic()

    def _wall(self) -> float:
        return self._wall_fn() if self._wall_fn is not None \
            else clockmod.now()

    # -- hot path -------------------------------------------------------------

    def observe_request(self, route: str, status: int,
                        latency_ms: float, trace_id: str | None = None,
                        spans=None) -> None:
        """Record one finished request into the rings; never raises.
        Called from the dispatcher's finally block for EVERY request —
        this is the 10 µs-budget path."""
        try:
            now = self._mono()
            self._events_ring.append(
                (int(self._wall() * 1000), route, status,
                 round(latency_ms, 3), trace_id))
            if spans:
                ring = self._spans_ring
                for s in spans:
                    ring.append((s.get("name"),
                                 round(float(s.get("duration_ms")
                                             or 0.0), 3), trace_id))
            if now >= self._next_tick:
                self._tick(now)
            if status >= 500 or status == 0:
                self._observe_error(now)
        except Exception:  # noqa: BLE001 — the recorder never breaks serving
            pass

    def _observe_error(self, now: float) -> None:
        with self._lock:
            times = self._err_times
            times.append(now)
            while times and now - times[0] > self.burst_window_sec:
                times.popleft()
            burst = len(times) >= self.burst_errors
            if burst:
                times.clear()
        if burst:
            self.trigger("error-burst",
                         {"errors": self.burst_errors,
                          "window_sec": self.burst_window_sec})

    def _tick(self, now: float) -> None:
        """Advance the coarse ring: counter deltas + a gauge sample.
        Gauge fns are evaluated OUTSIDE the recorder lock (an SLO burn
        gauge may page and re-enter :meth:`trigger`)."""
        with self._lock:
            if now < self._next_tick:
                return  # another thread won the tick
            self._next_tick = now + self.tick_sec
        counters = {}
        gauges = {}
        if self._registry is not None:
            counters = _safe(self._registry.counters_snapshot) or {}
            gauges = _safe(self._registry.gauges_snapshot) or {}
        with self._lock:
            last = self._last_counters
            deltas = {k: v - last.get(k, 0)
                      for k, v in counters.items()
                      if v != last.get(k, 0)}
            self._last_counters = counters
        self._ticks_ring.append(
            {"t": round(now, 3), "counter_deltas": deltas,
             "gauges": gauges})

    # -- triggers -------------------------------------------------------------

    def _on_fault_fired(self, point: str, mode: str) -> None:
        """Every consumed chaos fault is a trigger — except the
        recorder's own seams, which would recurse."""
        if point.startswith("flight-"):
            return
        self.trigger("chaos-fault", {"point": point, "mode": mode})

    def _atexit_dump(self) -> None:
        with contextlib.suppress(Exception):
            self.trigger("atexit")

    def trigger(self, reason: str, detail: dict | None = None,
                trigger_id: str | None = None) -> dict:
        """Request a dump; never raises.  Local triggers (no id)
        debounce against the last dump; fanned-in triggers (explicit
        id) dedupe by id but bypass the window — see module docs."""
        try:
            if getattr(self._tls, "busy", False):
                return {"dumped": False, "reentrant": True}
            storm = None
            with contextlib.suppress(Exception):
                # chaos seam: duplicate mode doubles the trigger; the
                # debounce window must collapse the pair to one bundle
                storm = faults.fire("flight-trigger-storm")
            out = self._trigger_once(reason, detail, trigger_id)
            if storm == "duplicate":
                self._trigger_once(reason, detail, trigger_id)
            return out
        except Exception:  # noqa: BLE001 — triggers ride alerting paths
            return {"dumped": False, "error": True}

    def _trigger_once(self, reason: str, detail: dict | None,
                      trigger_id: str | None) -> dict:
        now = self._mono()
        with self._lock:
            if trigger_id is not None and trigger_id in self._seen_ids:
                return {"dumped": False, "duplicate": True,
                        "trigger_id": trigger_id}
            if trigger_id is None and self._last_dump_t is not None \
                    and now - self._last_dump_t < self.debounce_sec:
                self._debounced += 1
                debounced_total = self._debounced
                tid = None
            else:
                tid = trigger_id or (
                    f"ft-{int(self._wall() * 1000)}"
                    f"-{os.getpid()}-{self._instance}")
                self._seen_ids.append(tid)
                self._last_dump_t = now
        if tid is None:
            if self._registry is not None:
                self._registry.inc("flight_trigger_debounced")
            return {"dumped": False, "debounced": True,
                    "debounced_total": debounced_total}
        self._tls.busy = True
        try:
            path = self._dump(tid, reason, detail)
        finally:
            self._tls.busy = False
        out = {"dumped": path is not None, "trigger_id": tid,
               "reason": reason, "path": path}
        fan = self.fan_out
        if fan is not None and trigger_id is None and path is not None:
            # originating process only: fanned-in triggers never re-fan
            out["fanned_out"] = _safe(lambda: fan(tid, reason))
        return out

    # -- the bundle -----------------------------------------------------------

    def _bundle(self, tid: str, reason: str,
                detail: dict | None) -> dict:
        ticks = list(self._ticks_ring)
        reg = self._registry
        bundle = {
            "trigger_id": tid,
            "trigger_reason": reason,
            "trigger_detail": detail,
            "ts_ms": int(self._wall() * 1000),
            "service": self.service,
            "pid": os.getpid(),
            "flight_events": {"fields": list(RING_EVENT_FIELDS),
                              "rows": [list(r)
                                       for r in self._events_ring]},
            "flight_spans": {"fields": list(RING_SPAN_FIELDS),
                             "rows": [list(r)
                                      for r in self._spans_ring]},
            "flight_ticks": ticks,
            "counters": (_safe(reg.counters_snapshot) or {})
            if reg is not None else {},
            # gauges come from the newest tick, never live: a page
            # callback holds the SLO engine's non-reentrant lock, and
            # evaluating its exported gauges here would deadlock
            "gauges": (ticks[-1].get("gauges") if ticks else None),
            "routes": (_safe(reg.snapshot) or {})
            if reg is not None else {},
            "resilience": _safe(resilience_snapshot),
            "slo": _safe(self._slo.last_status)
            if self._slo is not None else None,
            "device_time": _safe(self._accountant.snapshot)
            if self._accountant is not None else None,
            "debounced_triggers": self._debounced,
        }
        devices = _safe(device_memory_stats)
        if devices:
            bundle["device_memory"] = devices
        if self._diagnose_fn is not None:
            bundle["diagnosis"] = _safe(
                lambda: self._diagnose_fn(bundle))
        return bundle

    def _dump(self, tid: str, reason: str,
              detail: dict | None) -> str | None:
        tmp = None
        try:
            data = json.dumps(self._bundle(tid, reason, detail),
                              sort_keys=True, default=str).encode()
            fname = (f"flight-{self.service}-{os.getpid()}"
                     f"-{self._instance}-{tid}.json")
            store.mkdirs(self.dir)
            tmp = store.join(self.dir, f".{fname}.tmp")
            final = store.join(self.dir, fname)
            with store.open_write(tmp) as fh:
                fh.write(data[:256])
                # chaos seam: ENOSPC mid-bundle — the partial temp
                # file below is discarded, never published
                faults.fire(
                    "flight-dump-disk-full",
                    error=lambda: OSError(28,
                                          "injected ENOSPC mid-bundle"))
                fh.write(data[256:])
            store.rename(tmp, final)
        except Exception:  # noqa: BLE001 — a failed dump must not cascade
            if tmp is not None:
                with contextlib.suppress(Exception):
                    store.delete_recursively(tmp)
            with self._lock:
                self.dump_failures += 1
            if self._registry is not None:
                self._registry.inc("flight_dump_failures")
            return None
        with self._lock:
            self.dumps += 1
            self.last_dump = {"trigger_id": tid, "reason": reason,
                              "path": final,
                              "ts_ms": int(self._wall() * 1000)}
        if self._registry is not None:
            self._registry.inc("flight_dumps")
        return final

    # -- introspection / lifecycle --------------------------------------------

    def status(self) -> dict:
        """The ``GET /admin/flight`` view."""
        with self._lock:
            return {
                "armed": True,
                "service": self.service,
                "dir": self.dir,
                "rings": {"events": len(self._events_ring),
                          "spans": len(self._spans_ring),
                          "ticks": len(self._ticks_ring)},
                "dumps": self.dumps,
                "dump_failures": self.dump_failures,
                "debounced": self._debounced,
                "debounce_sec": self.debounce_sec,
                "last_dump": dict(self.last_dump)
                if self.last_dump else None,
            }

    def close(self) -> None:
        faults.remove_fire_listener(self._fault_listener)
        if self._dump_on_exit:
            with contextlib.suppress(Exception):
                atexit.unregister(self._atexit_dump)


def flight_from_config(config, service: str, registry=None,
                       slo=None, accountant=None,
                       diagnose_fn=None) -> FlightRecorder | None:
    """Build the tier's recorder from ``oryx.obs.flight.*``; None when
    no directory is configured — the shipped default, so production
    opts in and the hot path pays one attribute check.  When no
    ``diagnose_fn`` is given the bundles embed the standard rule
    engine's verdict (obs/diagnose.py)."""
    base = "oryx.obs.flight"
    directory = config.get_optional_string(f"{base}.dir")
    if not directory:
        return None
    if diagnose_fn is None:
        from .diagnose import diagnose_bundle
        diagnose_fn = diagnose_bundle
    return FlightRecorder(
        service, registry,
        dir=store.join(directory, service),
        slo=slo, accountant=accountant, diagnose_fn=diagnose_fn,
        ring_events=config.get_int(f"{base}.ring-events"),
        ring_spans=config.get_int(f"{base}.ring-spans"),
        ring_ticks=config.get_int(f"{base}.ring-ticks"),
        tick_sec=config.get_double(f"{base}.tick-sec"),
        debounce_sec=config.get_double(f"{base}.debounce-sec"),
        burst_errors=config.get_int(f"{base}.burst-errors"),
        burst_window_sec=config.get_double(
            f"{base}.burst-window-sec"),
        dump_on_exit=config.get_bool(f"{base}.dump-on-exit"))
