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

Observability, as in the reference: the layer is headless, so its
freshness gauges — input and update consumer lag, model generation age,
micro-batch duration and records, and the end-to-end
``ingest_to_servable_ms`` measured from the ``ts`` record headers the
serving front end stamps — answer on the side-door ``ObsServer`` at
``oryx.obs.metrics-port``.  A record carrying a sampled ``traceparent``
header gets a retroactive ``speed.fold_in`` span under its originating
trace.  The update consumer skips the serving cluster's heartbeats, as
the reference's does (:213-217).

Not part of this package yet, each refused with an error naming its
key: the durable micro-batch checkpoint and its dedup fence
(``oryx.speed.checkpoint-dir``) and the sharded speed layer
(``oryx.speed.shard`` other than ``0/1``).
"""

from __future__ import annotations

import logging
import threading

from ..app.als.speed import check_shard
from ..cluster.membership import without_heartbeats
from ..common import clock as clockmod
from ..common import compile_cache
from ..common.config import Config, refuse_configured
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
from .metrics import MetricsRegistry

_log = logging.getLogger(__name__)

__all__ = ["SpeedLayer"]


class SpeedLayer:
    """start()/await_()/close() around the update-topic consumer and the
    micro-batch loop."""

    def __init__(self, config: Config, device=None):
        refuse_configured(config, ("oryx.speed.checkpoint-dir",),
                          "the speed checkpoint is not part of this "
                          "package yet")
        shard_spec = check_shard(config)
        self.config = config
        self.id = config.get_optional_string("oryx.id")
        self.input_broker = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_broker = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string(
            "oryx.update-topic.message.topic")
        self.generation_interval_sec = config.get_int(
            "oryx.speed.streaming.generation-interval-sec")
        manager_class = config.get_string("oryx.speed.model-manager-class")
        self.model_manager = load_instance(manager_class, config, device)
        # the reference's group name, "-0x1" included for an explicit
        # "0/1" shard
        self._group = f"OryxGroup-SpeedLayer-{self.id or 'default'}" + (
            "-0x1" if shard_spec else "")
        self._stop = threading.Event()
        self._consume_thread: threading.Thread | None = None
        self._batch_thread: threading.Thread | None = None
        faults.configure_from_config(config)
        # a transiently failing UP publish retries with backoff; offsets
        # advance only after every delta of the micro-batch is published
        self._producer = ResilientTopicProducer(
            InProcTopicProducer(self.update_broker, self.update_topic),
            retry=Retry.from_config("speed-publish", config))
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
        # wide-event log (obs/events.py; None = disabled): the side
        # door's lines carry the shard coordinate
        self.events = events_from_config(
            config, "speed", self.metrics,
            static_fields={"speed_shard": "0/1"})
        # flight recorder (obs/flight.py; None until the config gate
        # opens): a chaos fault in this worker leaves a bundle
        self.flight = flight_from_config(config, "speed", self.metrics)
        self.obs_server = ObsServer(config, self.metrics, self.tracer,
                                    extra_context={
                                        "events": self.events,
                                        "flight": self.flight,
                                    })

    def start(self) -> None:
        _log.info("Starting speed layer (micro-batch %ds)",
                  self.generation_interval_sec)
        self.obs_server.start()
        compile_cache.enable_from_config(self.config)
        # create the input topic at its configured partition count before
        # any lazy access can freeze it at one partition
        kafka_utils.maybe_create_topic(
            self.input_broker, self.input_topic,
            partitions=kafka_utils.input_topic_partitions(self.config))
        # model state = the whole update topic replayed from offset 0
        # (reference: auto.offset.reset=smallest, SpeedLayer.java:113)
        self._consume_thread = threading.Thread(
            target=logging_call(self._consume_updates, "speed-consume"),
            daemon=True, name="SpeedLayerConsume")
        self._consume_thread.start()
        self._batch_thread = threading.Thread(
            target=logging_call(self._micro_batch_loop, "speed-batch"),
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

    def _publish_batch(self, in_broker, updates: list[str],
                       ends: list[int]) -> int:
        """Publish one derived micro-batch, then commit the input ends."""
        up_headers = {"ts": str(int(clockmod.now() * 1000))}
        for update in updates:
            # chaos seam: UP delta publish failure — the offsets must
            # not advance past an unpublished delta
            faults.fire("speed-publish")
            self._producer.send(KEY_UP, update, headers=up_headers)
        # chaos seam: die after the publishes, before the commit (the
        # reference arms it on its checkpoint path): the batch is read
        # and published again at the next start
        faults.fire("speed-crash-mid-batch")
        in_broker.set_offsets(self._group, self.input_topic, ends)
        return len(updates)

    # -- the micro-batch loop ------------------------------------------------

    def _init_pos(self, broker) -> list[int]:
        """The group's committed offsets; a fresh group starts at the
        partitions' ends."""
        latest = broker.latest_offsets(self.input_topic)
        return [p if p is not None else latest[i]
                for i, p in enumerate(broker.get_offsets(
                    self._group, self.input_topic))]

    def _run_batch(self, broker, pos: list[int]) -> list[int]:
        """One micro-batch: read [pos, ends), derive, publish, commit.
        Returns the new position (``pos`` when there was no input)."""
        ends = broker.latest_offsets(self.input_topic)
        if all(e <= p for e, p in zip(ends, pos)):
            return pos
        t_batch = clockmod.monotonic()
        new_data: list[KeyMessage] = broker.read_ranges(
            self.input_topic, pos, ends)
        updates = list(self.model_manager.build_updates(new_data))
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
        group's committed offsets (0 for a fresh group)."""
        broker = resolve_broker(self.input_broker)
        pos = [p or 0
               for p in broker.get_offsets(self._group, self.input_topic)]
        self._run_batch(broker, pos)
