"""Cross-region update-topic mirroring.

Counterpart of ``oryx_tpu/cluster/mirror.py``.  The update topic
(MODEL/MODEL-REF/UP in one ordered log) is the lambda architecture's
single source of truth, so geo-distribution needs one new moving part:
a **mirror** process per inbound link (``python -m oryx_tpu_torch
mirror``, supervised like every other role) that tails a *source*
region's update topic and replays it into the *destination* region's
topic.  Each region runs its own router, replicas and speed layer over
its own topics and serves every read locally; fold-in writes converge
through the mirror, since identical UP records applied to identical
state yield identical factors.  The mirror never touches the card.

Exactly-once-effective replay
-----------------------------

- **Origin headers.**  Every mirrored record carries ``origin-region``
  / ``origin-partition`` / ``origin-offset`` record headers.  A record
  that already carries them (multi-hop) keeps them: a record's identity
  is where it was born, not the link it arrived on.
- **Loop prevention.**  A record whose ``origin-region`` names the
  destination region is dropped (``mirror_loop_drops``), so mirrors
  A⇄B never ping-pong.  Replica heartbeats (``HB``) are their own
  region's control plane and are dropped too
  (``mirror_heartbeat_drops``).
- **The checkpoint and dedup fence.**  A durable high-watermark per
  (origin, partition) lives in ``mirror-checkpoint.json`` under
  ``checkpoint-dir`` (tmp + rename), written after each replayed batch.
  A crash between the replay and the checkpoint re-reads records on
  restart, so recovery scans the destination topic from the
  checkpoint's ``dest_scanned`` marks and advances each watermark past
  every mirrored record found there.  Re-read records at or below the
  fence are skipped (``mirror_dedup_skips``).

Bounded, measured staleness
---------------------------

``mirror_lag_records`` (source head minus replayed position) and
``cross_region_staleness_ms`` are exported on the mirror's side-door
ObsServer.  A drained batch whose records carry ``ts`` headers yields
an exact record-age sample; between drains the gauge adds the time
since the mirror last confirmed it was caught up, which keeps climbing
through a partitioned link (the poll seam ``mirror-link-partition``).
As an ``oryx.obs.slo`` objective of ``kind = "gauge"`` the bound
becomes a burn-rate alert.
"""

from __future__ import annotations

import json
import logging
import threading

from ..common import clock as clockmod
from ..common import store
from ..common.config import Config
from ..kafka import utils as kafka_utils
from ..kafka.api import KeyMessage
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..lambda_rt.metrics import MetricsRegistry
from ..obs import (engine_from_config, flight_from_config,
                   tracer_from_config)
from ..obs.server import ObsServer
from ..resilience import faults
from ..resilience.policy import (CircuitBreaker, ResilientTopicProducer,
                                 Retry)
from .membership import KEY_HEARTBEAT

_log = logging.getLogger(__name__)

__all__ = ["MirrorLayer", "MirrorCheckpoint", "origin_of",
           "H_ORIGIN_REGION", "H_ORIGIN_PARTITION", "H_ORIGIN_OFFSET"]

# record headers carried by every mirrored record (kafka/api.py):
# where the record was BORN — preserved untouched across further hops,
# so (origin-region, origin-partition, origin-offset) is a globally
# unique record identity whatever path it travelled
H_ORIGIN_REGION = "origin-region"
H_ORIGIN_PARTITION = "origin-partition"
H_ORIGIN_OFFSET = "origin-offset"


def origin_of(km: KeyMessage, source_region: str,
              partition: int, offset: int) -> tuple[str, int, int]:
    """A record's birth coordinates: its own origin headers when it was
    already mirrored once, else (source region, partition, offset) —
    the position the mirror read it at."""
    h = km.headers or {}
    try:
        if H_ORIGIN_REGION in h:
            return (str(h[H_ORIGIN_REGION]),
                    int(h.get(H_ORIGIN_PARTITION, 0)),
                    int(h[H_ORIGIN_OFFSET]))
    except (TypeError, ValueError, KeyError):
        pass  # malformed origin headers: treat as born at the source
    return source_region, partition, offset


class MirrorCheckpoint:
    """The mirror's durable state, one JSON document in the store
    (common/store):

    - ``source``: next source-topic offset to read, per partition —
      where the tail resumes;
    - ``watermarks``: highest ``origin-offset`` replayed into the
      destination, per ``"origin|partition"`` — the dedup fence;
    - ``dest_scanned``: destination-topic offsets already examined by
      recovery, per partition — the next recovery scan is incremental.

    Written atomically (tmp + rename) after each replayed batch.  A
    crash between a batch's sends and its checkpoint write loses only
    the in-memory watermark advance; :meth:`recover` re-derives it from
    the destination log itself (see the module docstring)."""

    FILE = "mirror-checkpoint.json"

    def __init__(self, checkpoint_dir: str):
        store.mkdirs(checkpoint_dir)
        self.path = store.join(checkpoint_dir, self.FILE)
        self.source: dict[int, int] = {}
        self.watermarks: dict[tuple[str, int], int] = {}
        self.dest_scanned: dict[int, int] = {}
        self.load()

    def load(self) -> None:
        if not store.exists(self.path):
            return
        try:
            with store.open_read(self.path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError):
            _log.warning("Unreadable mirror checkpoint at %s; recovery "
                         "will re-derive the fence from the destination "
                         "log", self.path, exc_info=True)
            return
        self.source = {int(k): int(v)
                       for k, v in (doc.get("source") or {}).items()}
        self.dest_scanned = {int(k): int(v) for k, v
                             in (doc.get("dest_scanned") or {}).items()}
        self.watermarks = {}
        for k, v in (doc.get("watermarks") or {}).items():
            region, _, part = k.rpartition("|")
            self.watermarks[(region, int(part))] = int(v)

    def save(self) -> None:
        doc = {
            "source": {str(k): v for k, v in self.source.items()},
            "watermarks": {f"{r}|{p}": v
                           for (r, p), v in self.watermarks.items()},
            "dest_scanned": {str(k): v
                             for k, v in self.dest_scanned.items()},
        }
        tmp = self.path + ".tmp"
        with store.open_write(tmp, "wb") as f:
            f.write(json.dumps(doc, sort_keys=True).encode("utf-8"))
        store.rename(tmp, self.path)

    # -- the fence -----------------------------------------------------------

    def behind_fence(self, origin: str, partition: int,
                     offset: int) -> bool:
        wm = self.watermarks.get((origin, partition))
        return wm is not None and offset <= wm

    def advance_fence(self, origin: str, partition: int,
                      offset: int) -> None:
        key = (origin, partition)
        if offset > self.watermarks.get(key, -1):
            self.watermarks[key] = offset


class MirrorLayer:
    """start()/await_()/close() around the replay loop — the same
    lifecycle contract as the other layers, so ``python -m
    oryx_tpu_torch mirror`` runs supervised (deploy/main.py)."""

    def __init__(self, config: Config,
                 clock: clockmod.Clock | None = None):
        self.config = config
        # the injectable clock seam: the staleness-gauge tests pin
        # their windows on a ManualClock instead of real sleeps
        self._clock = clock if clock is not None else clockmod.get()
        r = "oryx.cluster.region"
        self.region = config.get_optional_string(f"{r}.name")
        if not self.region:
            raise ValueError(
                "mirror requires oryx.cluster.region.name — the "
                "destination region's identity (loop prevention keys "
                "on it)")
        m = f"{r}.mirror"
        self.source_broker = config.get_optional_string(
            f"{m}.source-broker")
        if not self.source_broker:
            raise ValueError(
                "mirror requires oryx.cluster.region.mirror."
                "source-broker — the remote region's update topic")
        self.source_topic = config.get_optional_string(
            f"{m}.source-topic") or config.get_string(
            "oryx.update-topic.message.topic")
        self.source_region = config.get_string(f"{m}.source-region")
        checkpoint_dir = config.get_optional_string(
            f"{m}.checkpoint-dir")
        if not checkpoint_dir:
            raise ValueError(
                "mirror requires oryx.cluster.region.mirror."
                "checkpoint-dir — the durable high-watermark store the "
                "exactly-once-effective fence lives in")
        self.poll_interval_sec = config.get_int(
            f"{m}.poll-interval-ms") / 1000.0
        self.max_batch_records = config.get_int(
            f"{m}.max-batch-records")
        self.dest_broker = config.get_string("oryx.update-topic.broker")
        self.dest_topic = config.get_string(
            "oryx.update-topic.message.topic")
        if (self.source_broker == self.dest_broker
                and self.source_topic == self.dest_topic):
            raise ValueError(
                "mirror source and destination are the same topic — "
                "a self-mirror would double every record")
        faults.configure_from_config(config)
        self.checkpoint = MirrorCheckpoint(checkpoint_dir)
        # replay sends run behind retry + breaker:
        # a transient destination-broker failure retries with backoff,
        # a sustained one opens the breaker and the loop backs off
        # without losing its position — nothing is checkpointed past
        # an unsent record
        self._producer = ResilientTopicProducer(
            InProcTopicProducer(self.dest_broker, self.dest_topic),
            retry=Retry.from_config("mirror-replay", config),
            breaker=CircuitBreaker.from_config("mirror-replay-dest",
                                               config))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # staleness clocks (single-writer loop thread, many readers —
        # plain attribute stores are atomic in CPython).  Seeded at
        # construction: a mirror that has NEVER confirmed sync (e.g.
        # started into an already-partitioned link) must report
        # staleness climbing from its start, not a forever-0
        self._caught_up_mono: float = self._clock.monotonic()
        # None until the source head has been OBSERVED at least once: a
        # mirror restarted into a dead link must report unknown (null),
        # never a constructor-seeded 0 that reads as "caught up"
        self._last_lag: int | None = None
        self._last_batch_staleness_ms: int | None = None
        self.link_failures = 0
        self.metrics = MetricsRegistry()
        self.metrics.gauge_fn("mirror_lag_records", self._lag_gauge)
        self.metrics.gauge_fn("cross_region_staleness_ms",
                              self._staleness_gauge)
        self.tracer = tracer_from_config(config, "mirror")
        # the staleness bound as a burn-rate alert: register a
        # kind="gauge" objective over cross_region_staleness_ms under
        # oryx.obs.slo.objectives.* and pages fire while the region
        # falls behind (obs/slo.py)
        self.slo_engine = engine_from_config(config, self.metrics)
        if self.slo_engine is not None:
            self.metrics.gauge_fn("slo_burn_rate",
                                  self.slo_engine.burn_gauge)
            self.metrics.gauge_fn("slo_error_budget_remaining",
                                  self.slo_engine.budget_gauge)
        # flight recorder (obs/flight.py; None until the config gate
        # opens): a staleness page or link-fault in this region leaves
        # a bundle on the mirror's own side door
        self.flight = flight_from_config(config, "mirror", self.metrics,
                                         slo=self.slo_engine)
        if self.flight is not None and self.slo_engine is not None:
            flight = self.flight
            self.slo_engine.on_page = lambda name, st: flight.trigger(
                "slo-page", {"objective": name,
                             "burn_5m": st.get("burn_5m")})
        self.obs_server = ObsServer(config, self.metrics, self.tracer,
                                    extra_context={
                                        "region_info": self.status,
                                        # /admin/slo serves the
                                        # staleness objective's alert
                                        # state on the same side door
                                        "slo": self.slo_engine,
                                        "flight": self.flight})

    # -- gauges --------------------------------------------------------------

    def _lag_gauge(self) -> int | None:
        """Source head minus replayed position.  Reads the source
        broker directly (like obs/freshness.topic_lag_fn); when the
        link is down the LAST OBSERVED lag is held instead of
        reporting nothing, and a mirror that has never reached the
        source at all reports None (unknown) — a partition, or a
        restart into one, must never read as 'caught up'."""
        try:
            latest = resolve_broker(self.source_broker).latest_offsets(
                self.source_topic)
            self._last_lag = sum(
                max(0, e - self.checkpoint.source.get(p, 0))
                for p, e in enumerate(latest))
        except Exception:  # noqa: BLE001 — link down: hold last value
            pass
        return self._last_lag

    def _staleness_gauge(self) -> int:
        """Milliseconds the destination region may be behind the
        source.  When the last drained batch carried ``ts`` headers the
        base is that batch's exact worst record age (measured, not
        modeled); on top of it rides the time since the mirror last
        CONFIRMED it was caught up — which keeps climbing through a
        partitioned link, when no measurement can arrive at all (the
        clock is seeded at construction, so a mirror started INTO a
        partition climbs from its start)."""
        since_sync = int(
            (self._clock.monotonic() - self._caught_up_mono) * 1000)
        base = self._last_batch_staleness_ms or 0
        return base + since_sync

    def status(self) -> dict:
        """The /admin/region block on the mirror's ObsServer."""
        return {
            "role": "mirror",
            "source_region": self.source_region,
            "source_broker": self.source_broker,
            "source_topic": self.source_topic,
            "dest_topic": self.dest_topic,
            "link_failures": self.link_failures,
            "source_positions": dict(self.checkpoint.source),
            "watermarks": {f"{r}|{p}": v for (r, p), v
                           in sorted(self.checkpoint.watermarks.items())},
        }

    # -- recovery ------------------------------------------------------------

    def recover(self) -> int:
        """Finish an interrupted replay's bookkeeping: scan the
        DESTINATION topic from the checkpoint's ``dest_scanned`` marks
        and advance every (origin, partition) watermark past the
        mirrored records actually found — sends that landed after the
        last checkpoint write (the crash window) re-enter the fence.
        Never rewinds; a clean shutdown's scan is a no-op.  Returns the
        number of mirrored records examined."""
        broker = resolve_broker(self.dest_broker)
        kafka_utils.maybe_create_topic(self.dest_broker, self.dest_topic)
        ends = broker.latest_offsets(self.dest_topic)
        starts = [self.checkpoint.dest_scanned.get(p, 0)
                  for p in range(len(ends))]
        examined = 0
        for km in broker.read_ranges(self.dest_topic, starts, ends):
            h = km.headers or {}
            if H_ORIGIN_REGION not in h:
                continue  # locally-born record: not mirror bookkeeping
            try:
                self.checkpoint.advance_fence(
                    str(h[H_ORIGIN_REGION]),
                    int(h.get(H_ORIGIN_PARTITION, 0)),
                    int(h[H_ORIGIN_OFFSET]))
                examined += 1
            except (TypeError, ValueError):
                continue  # malformed headers: not fence material
        for p, e in enumerate(ends):
            self.checkpoint.dest_scanned[p] = max(
                self.checkpoint.dest_scanned.get(p, 0), e)
        if examined:
            _log.info("Mirror recovery advanced the dedup fence over "
                      "%d mirrored record(s) found in the destination "
                      "log", examined)
        self.checkpoint.save()
        return examined

    # -- the replay ----------------------------------------------------------

    def _replay_one(self, km: KeyMessage, partition: int,
                    offset: int) -> bool:
        """Classify and (maybe) replay one source record; returns True
        when it was sent to the destination."""
        if km.key == KEY_HEARTBEAT:
            # a foreign fleet's heartbeats would pollute the local
            # router's membership with unreachable URLs
            self.metrics.inc("mirror_heartbeat_drops")
            return False
        origin, o_part, o_off = origin_of(km, self.source_region,
                                          partition, offset)
        if origin == self.region:
            # loop prevention: this record was born HERE and came back
            # through the opposite mirror — A⇄B must never ping-pong
            self.metrics.inc("mirror_loop_drops")
            return False
        if self.checkpoint.behind_fence(origin, o_part, o_off):
            # the dedup fence: a crash between replay and checkpoint
            # re-reads records the destination log already holds
            self.metrics.inc("mirror_dedup_skips")
            return False
        headers = dict(km.headers or {})
        # write the COMPUTED birth coordinates: origin_of already
        # preserved valid existing headers, and overwriting normalizes
        # a malformed set (which fell back to source coordinates) into
        # something the fence can key on
        headers[H_ORIGIN_REGION] = origin
        headers[H_ORIGIN_PARTITION] = str(o_part)
        headers[H_ORIGIN_OFFSET] = str(o_off)
        self._producer.send(km.key, km.message, headers=headers)
        self.checkpoint.advance_fence(origin, o_part, o_off)
        self.metrics.inc("mirror_records_replayed")
        return True

    def poll_once(self) -> int:
        """One micro-batch: read up to ``max_batch_records`` per source
        partition past the checkpoint, replay, then checkpoint.
        Returns the number of records replayed (not merely read).
        Raises on a dead link — the caller owns backoff."""
        # chaos seam: the inter-region link is partitioned — every
        # poll fails until the fault clears, and the staleness gauges
        # must climb the whole time
        faults.fire("mirror-link-partition",
                    error=lambda: ConnectionError(
                        "mirror link partitioned"))
        broker = resolve_broker(self.source_broker)
        ends = broker.latest_offsets(self.source_topic)
        starts, capped = [], []
        for p, e in enumerate(ends):
            s = self.checkpoint.source.get(p, 0)
            starts.append(s)
            capped.append(min(e, s + self.max_batch_records))
        if all(c <= s for s, c in zip(starts, capped)):
            # fully drained: stamp the caught-up confirmation the
            # staleness gauge measures from
            self._caught_up_mono = self._clock.monotonic()
            self._last_batch_staleness_ms = 0
            return 0
        replayed = 0
        oldest_ts: int | None = None
        t_drain = self._clock.time()
        # per-partition replay preserves each partition's record order
        # (Kafka's guarantee — all the convergence argument needs)
        for p in range(len(ends)):
            if capped[p] <= starts[p]:
                continue
            batch = broker.read_ranges(
                self.source_topic,
                [starts[i] if i == p else 0 for i in range(len(ends))],
                [capped[i] if i == p else 0 for i in range(len(ends))])
            for i, km in enumerate(batch):
                if self._replay_one(km, p, starts[p] + i):
                    replayed += 1
                    ts = (km.headers or {}).get("ts")
                    if ts is not None:
                        try:
                            t = int(ts)
                            if oldest_ts is None or t < oldest_ts:
                                oldest_ts = t
                        except (TypeError, ValueError):
                            pass
            self.checkpoint.source[p] = capped[p]
        if oldest_ts is not None:
            # exact measured staleness of this batch: how old its
            # oldest record (by its `ts` stamp) was when it became
            # visible in the destination region
            self._last_batch_staleness_ms = max(
                0, int(t_drain * 1000) - oldest_ts)
        # chaos seam: die AFTER the batch's sends but BEFORE the
        # checkpoint write — the exact window the dedup fence exists
        # for (recovery must not duplicate a single fold-in effect)
        faults.fire("mirror-crash-mid-replay")
        # sends before this checkpoint are below the destination head:
        # the next recovery scan may start past them
        try:
            self.checkpoint.dest_scanned = {
                p: e for p, e in enumerate(
                    resolve_broker(self.dest_broker).latest_offsets(
                        self.dest_topic))}
        except Exception:  # noqa: BLE001 — scan mark is an optimization
            pass
        self.checkpoint.save()
        if all(self.checkpoint.source.get(p, 0) >= e
               for p, e in enumerate(ends)):
            self._caught_up_mono = self._clock.monotonic()
        return replayed

    def _loop(self) -> None:
        """Deterministic fixed-interval polling with per-failure
        accounting.  A failed poll (dead link, dest breaker open)
        counts, logs, and waits ONE poll interval — not a compounding
        backoff: the staleness gauge is the pressure valve, and a
        healed link must resume within one interval, bounded.  stop()
        interrupts any
        wait immediately (Event.wait)."""
        while not self._stop.is_set():
            try:
                drained = self.poll_once()
            except Exception:  # noqa: BLE001 — link down: hold position
                self.link_failures += 1
                self.metrics.inc("mirror_link_failures")
                if self.link_failures in (1, 10) \
                        or self.link_failures % 100 == 0:
                    _log.warning("mirror poll failed (%d so far); "
                                 "holding position, staleness climbing",
                                 self.link_failures, exc_info=True)
                self._clock.wait(self._stop, self.poll_interval_sec)
                continue
            if drained == 0:
                self._clock.wait(self._stop, self.poll_interval_sec)
            # a full batch replays again immediately: catch-up after a
            # healed partition must run at link speed, not poll speed

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        _log.info("Starting mirror %s -> %s (%s @ %s -> %s @ %s)",
                  self.source_region, self.region, self.source_topic,
                  self.source_broker, self.dest_topic, self.dest_broker)
        self.obs_server.start()
        self.recover()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="MirrorReplay")
        self._thread.start()

    def await_(self) -> None:
        while self._thread and self._thread.is_alive():
            self._thread.join(1.0)

    def close(self) -> None:
        self._stop.set()
        if self.flight is not None:
            self.flight.close()
        self.obs_server.close()
        if self._thread:
            self._thread.join(10.0)
        try:
            self.checkpoint.save()
        except Exception:  # noqa: BLE001 — best-effort final flush
            _log.exception("mirror checkpoint flush on close failed")
        self._producer.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
