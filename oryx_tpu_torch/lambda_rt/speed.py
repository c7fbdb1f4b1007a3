"""The speed layer: incremental model updates from micro-batches.

Counterpart of ``oryx_tpu/lambda_rt/speed.py`` (reference:
SpeedLayer.java:58-221 — a consumer thread replays the update topic
from offset 0 into the model manager (:107-137), while the input topic
is drained in micro-batches whose derived deltas are published with key
"UP" (SpeedLayerUpdate.java:37-65)).  The model manager is the class of
``oryx.speed.model-manager-class`` (a class of this package), built on
``device`` (None means ``cuda``).  A micro-batch reads the input
partitions from the layer's committed group offsets to their ends,
publishes every delta through a producer that retries with backoff,
and only then commits the ends: a failed publish costs redelivery,
never loss (at least once).

Sharded operation: with ``oryx.speed.shard = "i/N"`` (``python -m
oryx_tpu_torch speed --shard i/N``) a worker still consumes the whole
input and update topics — the fold-in needs the whole catalog's
Gramians and every user vector — but its model manager folds only the
events whose item lies on the worker's murmur2 ring slot, and all N
workers publish into the one update topic.  Each worker has its own
consumer group (``-{i}x{N}``).

Crash safety (lambda_rt/speed_checkpoint.py): with
``oryx.speed.checkpoint-dir`` set, each micro-batch stages its derived
update bytes durably before publishing (under ``shard-{i}-of-{N}``),
stamps every publish with (shard, batch, seq) headers, and commits the
input offsets atomically after the publishes.  ``start()`` first
resolves a batch an earlier incarnation staged: it scans the update
topic from the last ``dest_scanned`` mark, republishes only the staged
records that never landed, byte for byte, and counts the others as
``speed_shard_dedup_skips`` — a kill between publish and commit reads
the batch again but folds it once.  Unset, the worker keeps the group
offsets' at-least-once contract.

Observability, as in the reference: the layer is headless, so its
freshness gauges — input and update consumer lag, model generation age,
micro-batch duration and records, and the end-to-end
``ingest_to_servable_ms`` measured from the ``ts`` record headers the
serving front end stamps — answer on the side-door ``ObsServer`` at
``oryx.obs.metrics-port``.  A record carrying a sampled ``traceparent``
header gets a retroactive ``speed.fold_in`` span under its originating
trace.  The update consumer skips the serving cluster's heartbeats, as
the reference's does (:213-217).  With the checkpoint, the side door
also serves ``speed_checkpoint_age_sec``.
"""

from __future__ import annotations

import logging
import threading

from ..cluster.membership import without_heartbeats
from ..cluster.sharding import parse_shard_spec
from ..common import clock as clockmod
from ..common import compile_cache, store
from ..common.config import Config
from ..common.device import bound, thread_card
from ..common.lang import load_instance, logging_call
from ..kafka import utils as kafka_utils
from ..kafka.api import KEY_UP, KeyMessage
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..obs import (events_from_config, flight_from_config, freshness,
                   tracer_from_config)
from ..obs.server import ObsServer
from ..obs.trace import parse_traceparent
from ..resilience import faults
from ..resilience.policy import (ResilientTopicProducer, Retry,
                                 run_with_resubscribe)
from . import speed_checkpoint
from .metrics import MetricsRegistry
from .speed_checkpoint import SpeedCheckpoint

_log = logging.getLogger(__name__)

__all__ = ["SpeedLayer"]


class SpeedLayer:
    """start()/await_()/close() around the update-topic consumer and the
    micro-batch loop."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.id = config.get_optional_string("oryx.id")
        self.input_broker = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_broker = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string(
            "oryx.update-topic.message.topic")
        self.generation_interval_sec = config.get_int(
            "oryx.speed.streaming.generation-interval-sec")
        # ring-sharded fold-in: "i/N" gives this worker slice i of the
        # murmur2 ring; absent means the single worker
        shard_spec = config.get_optional_string("oryx.speed.shard")
        self.shard_index, self.shard_count = (
            parse_shard_spec(shard_spec) if shard_spec else (0, 1))
        self.shard_tag = f"{self.shard_index}/{self.shard_count}"
        manager_class = config.get_string("oryx.speed.model-manager-class")
        self.model_manager = load_instance(manager_class, config, device)
        # the card the layer's consumer and micro-batch threads make
        # current
        self.thread_card = thread_card(device)
        # each worker owns its consumer group: every worker reads the
        # whole input topic and folds its own item slices
        self._group = f"OryxGroup-SpeedLayer-{self.id or 'default'}" + (
            f"-{self.shard_index}x{self.shard_count}" if shard_spec else "")
        self._stop = threading.Event()
        self._consume_thread: threading.Thread | None = None
        self._batch_thread: threading.Thread | None = None
        faults.configure_from_config(config)
        # a transiently failing UP publish retries with backoff; offsets
        # advance only after every delta of the micro-batch is published
        self._producer = ResilientTopicProducer(
            InProcTopicProducer(self.update_broker, self.update_topic),
            retry=Retry.from_config("speed-publish", config))
        # the durable micro-batch fence (speed_checkpoint.py); unset
        # means the group offsets' at-least-once contract
        ckpt_dir = config.get_optional_string("oryx.speed.checkpoint-dir")
        self.checkpoint: SpeedCheckpoint | None = None
        if ckpt_dir:
            self.checkpoint = SpeedCheckpoint(store.join(
                ckpt_dir, f"shard-{self.shard_index}-of-{self.shard_count}"))
        self._last_ckpt_mono: float | None = None
        self.dedup_skips = 0
        # the last micro-batch: input records, updates published, seconds
        self.last_micro_batch: dict | None = None
        # the freshness surface, read through the side door
        self.metrics = MetricsRegistry()
        self.tracer = tracer_from_config(config, "speed")
        self._update_tap = freshness.UpdateStreamTap()
        self.metrics.gauge_fn(
            "update_lag_records",
            freshness.topic_lag_fn(self.update_broker, self.update_topic,
                                   lambda: self._update_tap.consumed))
        self.metrics.gauge_fn("model_generation_age_sec",
                              self._update_tap.model_age_sec)
        self.metrics.gauge_fn(
            "input_lag_records",
            freshness.group_lag_fn(self.input_broker, self.input_topic,
                                   self._group))
        if self.checkpoint is not None:
            self.metrics.gauge_fn("speed_checkpoint_age_sec",
                                  self._checkpoint_age_sec)
        # wide-event log (obs/events.py; None = disabled): the side
        # door's lines carry the shard coordinate
        self.events = events_from_config(
            config, "speed", self.metrics,
            static_fields={"speed_shard": self.shard_tag})
        # flight recorder (obs/flight.py; None until the config gate
        # opens): a chaos fault in this worker leaves a bundle
        self.flight = flight_from_config(config, "speed", self.metrics)
        self.obs_server = ObsServer(config, self.metrics, self.tracer,
                                    extra_context={
                                        "events": self.events,
                                        "flight": self.flight,
                                    })

    def _checkpoint_age_sec(self) -> float | None:
        """Seconds since the durable fence last advanced; None until its
        first save in this process."""
        last = self._last_ckpt_mono
        if last is None:
            return None
        return round(max(0.0, clockmod.monotonic() - last), 3)

    def start(self) -> None:
        _log.info("Starting speed layer %s (micro-batch %ds)",
                  self.shard_tag, self.generation_interval_sec)
        self.obs_server.start()
        compile_cache.enable_from_config(self.config)
        # create the input topic at its configured partition count before
        # any lazy access can freeze it at one partition
        kafka_utils.maybe_create_topic(
            self.input_broker, self.input_topic,
            partitions=kafka_utils.input_topic_partitions(self.config))
        # resolve a batch an earlier incarnation staged before any new
        # micro-batch runs: recovery republishes staged bytes, it never
        # derives them again
        if self.checkpoint is not None:
            try:
                self._recover()
            except Exception:  # noqa: BLE001 — broker down at start
                _log.exception("Speed recovery failed; the staged batch "
                               "stays pending and resolves before the "
                               "next micro-batch")
        # model state = the whole update topic replayed from offset 0
        # (reference: auto.offset.reset=smallest, SpeedLayer.java:113)
        self._consume_thread = threading.Thread(
            target=bound(logging_call(self._consume_updates,
                                      "speed-consume"), self.thread_card),
            daemon=True, name="SpeedLayerConsume")
        self._consume_thread.start()
        self._batch_thread = threading.Thread(
            target=bound(logging_call(self._micro_batch_loop,
                                      "speed-batch"), self.thread_card),
            daemon=True, name="SpeedLayerBatch")
        self._batch_thread.start()

    def await_(self) -> None:
        while self._batch_thread and self._batch_thread.is_alive():
            self._batch_thread.join(1.0)

    def close(self) -> None:
        # stop, join the workers, and only then close the manager and
        # the producer: a micro-batch in flight must never race them
        self._stop.set()
        for t in (self._consume_thread, self._batch_thread):
            if t:
                t.join(10.0)
        self.model_manager.close()
        if self.flight is not None:
            self.flight.close()
        if self.events is not None:
            self.events.close()
        self.obs_server.close()
        self._producer.close()

    @property
    def consuming(self) -> bool:
        """True while the update consumer thread runs."""
        return self._consume_thread is not None \
            and self._consume_thread.is_alive()

    def _consume_updates(self) -> None:
        broker = resolve_broker(self.update_broker)
        # serving-cluster heartbeats ride the same update topic: control
        # plane, filtered before the model manager.  The freshness tap
        # counts the raw records (heartbeats included), to compare with
        # the topic head's offsets
        run_with_resubscribe(
            lambda: self.model_manager.consume(without_heartbeats(
                self._update_tap.wrap(
                    broker.consume(self.update_topic, from_beginning=True,
                                   stop=self._stop)))),
            stop=self._stop, what="speed update consumer", log=_log)

    def _note_micro_batch(self, new_data: list[KeyMessage],
                          n_updates: int, t_start: float) -> None:
        """Per-micro-batch freshness gauges, and retroactive fold-in
        spans for the records whose ``traceparent`` header carries a
        sampled trace; best-effort, after the commit."""
        now = clockmod.monotonic()
        self.metrics.set_gauge("micro_batch_duration_ms",
                               round((now - t_start) * 1000.0, 3))
        self.metrics.set_gauge("micro_batch_records", len(new_data))
        oldest = freshness.oldest_ingest_ts_ms(new_data)
        if oldest is not None:
            # the worst case of the batch: the longest a record waited
            # between its /ingest and its deltas becoming servable
            self.metrics.set_gauge(
                "ingest_to_servable_ms",
                max(0, int(clockmod.now() * 1000) - oldest))
        if self.tracer is None:
            return
        for km in new_data:
            ctx = parse_traceparent((km.headers or {}).get("traceparent"))
            if ctx is None or not ctx[2]:
                continue
            self.tracer.record_span(
                "speed.fold_in", (ctx[0], ctx[1]), t_start, now,
                {"batch_records": len(new_data), "updates": n_updates})

    # -- the durable fence ---------------------------------------------------

    def _recover(self) -> None:
        """Resolve a staged, uncommitted micro-batch against the update
        topic (speed_checkpoint.recover_pending): staged records found
        there are skipped, missing ones republished byte for byte."""
        kafka_utils.maybe_create_topic(self.update_broker, self.update_topic)
        dest = resolve_broker(self.update_broker)
        ends = dest.latest_offsets(self.update_topic)
        republished, deduped = speed_checkpoint.recover_pending(
            self.checkpoint, self.shard_tag,
            lambda starts, e: dest.read_ranges(self.update_topic, starts, e),
            ends,
            lambda msg, headers: self._producer.send(KEY_UP, msg,
                                                     headers=headers))
        self._last_ckpt_mono = clockmod.monotonic()
        if deduped:
            self.dedup_skips += deduped
            self.metrics.inc("speed_shard_dedup_skips", deduped)
        if republished or deduped:
            # the group offsets mirror the recovered fence, so that the
            # input-lag gauge agrees with the durable state
            try:
                in_broker = resolve_broker(self.input_broker)
                in_broker.set_offsets(self._group, self.input_topic,
                                      self._checkpoint_pos(in_broker))
            except Exception:  # noqa: BLE001 — gauge bookkeeping only
                _log.exception("Group-offset mirror after recovery failed")

    def _checkpoint_pos(self, broker) -> list[int]:
        """The checkpoint's input fence, one offset per partition (0
        where it has none)."""
        n = len(broker.latest_offsets(self.input_topic))
        return [int(self.checkpoint.input.get(p, 0)) for p in range(n)]

    def _publish_batch(self, in_broker, updates: list[str],
                       ends: list[int]) -> int:
        """Publish one derived micro-batch and advance the fence: with
        the checkpoint, stage, publish, commit; without it, publish,
        then commit the group offsets."""
        up_headers = {"ts": str(int(clockmod.now() * 1000))}
        if self.checkpoint is None:
            for update in updates:
                # chaos seam: UP delta publish failure — the offsets
                # must not advance past an unpublished delta
                faults.fire("speed-publish")
                self._producer.send(KEY_UP, update, headers=up_headers)
            in_broker.set_offsets(self._group, self.input_topic, ends)
            return len(updates)
        # the durable intent before the first publish: recovery replays
        # these bytes and never derives them again against a model the
        # update consumer has moved
        batch = self.checkpoint.stage_batch(ends, updates, up_headers)
        for seq, update in enumerate(updates):
            faults.fire("speed-publish")
            self._producer.send(
                KEY_UP, update,
                headers=speed_checkpoint.stamp_headers(
                    up_headers, self.shard_tag, batch, seq))
        # chaos seam: die after the publishes, before the commit — the
        # window the staged batch and the update-topic scan exist for
        faults.fire("speed-crash-mid-batch")
        dest_ends = None
        try:
            dest_ends = resolve_broker(self.update_broker).latest_offsets(
                self.update_topic)
        except Exception:  # noqa: BLE001 — the scan mark is best effort:
            pass  # a stale one only lengthens the next scan
        self.checkpoint.commit_batch(ends, dest_ends=dest_ends)
        self._last_ckpt_mono = clockmod.monotonic()
        try:
            # the group offsets mirror the fence for the input-lag gauge
            in_broker.set_offsets(self._group, self.input_topic, ends)
        except Exception:  # noqa: BLE001 — gauge bookkeeping only
            _log.exception("Group-offset mirror after commit failed")
        return len(updates)

    # -- the micro-batch loop ------------------------------------------------

    def _init_pos(self, broker) -> list[int]:
        """The checkpoint's fence, else the group's committed offsets (a
        fresh group starts at the partitions' ends).  With the
        checkpoint, that start is pinned durably before the first
        micro-batch, so a worker killed before its first commit resumes
        there instead of at the moved head."""
        if self.checkpoint is not None and self.checkpoint.input:
            return self._checkpoint_pos(broker)
        latest = broker.latest_offsets(self.input_topic)
        pos = [p if p is not None else latest[i]
               for i, p in enumerate(broker.get_offsets(
                   self._group, self.input_topic))]
        if self.checkpoint is not None and self.checkpoint.pending is None:
            self.checkpoint.commit_batch(pos)
            self._last_ckpt_mono = clockmod.monotonic()
            try:
                # mirrored so that the input-lag gauge counts from here
                broker.set_offsets(self._group, self.input_topic, pos)
            except Exception:  # noqa: BLE001 — gauge bookkeeping only
                _log.exception("Group-offset mirror of the initial "
                               "fence failed")
        return pos

    def _run_batch(self, broker, pos: list[int]) -> list[int]:
        """One micro-batch: read [pos, ends), derive, publish, commit.
        Returns the new position (``pos`` when there was no input)."""
        if self.checkpoint is not None \
                and self.checkpoint.pending is not None:
            # an earlier attempt staged a batch and never committed it
            # (a publish failed mid-batch): finish it from its staged
            # bytes, the in-process form of crash recovery
            self._recover()
            return self._checkpoint_pos(broker)
        ends = broker.latest_offsets(self.input_topic)
        if all(e <= p for e, p in zip(ends, pos)):
            return pos
        t_batch = clockmod.monotonic()
        new_data: list[KeyMessage] = broker.read_ranges(
            self.input_topic, pos, ends)
        updates = list(self.model_manager.build_updates(new_data))
        _log.info("Micro-batch of %d records: %d updates built in %.3f s "
                  "(%s remote events skipped in all)", len(new_data),
                  len(updates), clockmod.monotonic() - t_batch,
                  getattr(self.model_manager, "skipped_remote_events", 0))
        n_updates = self._publish_batch(broker, updates, ends)
        self.last_micro_batch = {
            "records": len(new_data), "updates": n_updates,
            "seconds": clockmod.monotonic() - t_batch}
        self._note_micro_batch(new_data, n_updates, t_batch)
        return ends

    def _micro_batch_loop(self) -> None:
        broker = resolve_broker(self.input_broker)
        pos = None
        while not self._stop.is_set():
            if pos is None:
                try:
                    pos = self._init_pos(broker)
                except Exception:  # noqa: BLE001 — broker down at start
                    _log.exception("Micro-batch position init failed")
                    self._stop.wait(self.generation_interval_sec)
                    continue
            self._stop.wait(self.generation_interval_sec)
            if self._stop.is_set():
                break  # closing: never start a batch the join won't see
            try:
                pos = self._run_batch(broker, pos)
            except Exception:  # noqa: BLE001 — a micro-batch failure is
                _log.exception("Micro-batch failed")  # survivable
                # the offsets stay where they were: the next interval
                # reads the same input again

    def run_one_micro_batch(self) -> None:
        """Process the pending input once, synchronously, from the
        checkpoint's fence, else the group's committed offsets (0 for a
        fresh group)."""
        broker = resolve_broker(self.input_broker)
        if self.checkpoint is not None and self.checkpoint.input:
            pos = self._checkpoint_pos(broker)
        else:
            pos = [p or 0 for p in broker.get_offsets(self._group,
                                                      self.input_topic)]
        self._run_batch(broker, pos)
