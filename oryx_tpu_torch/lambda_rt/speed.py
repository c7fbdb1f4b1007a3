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

Not part of this package yet, each refused with an error naming its
key: the durable micro-batch checkpoint and its dedup fence
(``oryx.speed.checkpoint-dir``), the sharded speed layer
(``oryx.speed.shard`` other than ``0/1``), and the side-door metrics
server, freshness gauges, tracing, event log and flight recorder
(``oryx.obs.metrics-port`` and the rest of ``batch.OBS_KEYS``).
"""

from __future__ import annotations

import logging
import threading
import time

from ..app.als.speed import check_shard
from ..common.config import Config, refuse_configured
from ..common.lang import load_instance, logging_call
from ..kafka import utils as kafka_utils
from ..kafka.api import KEY_UP, KeyMessage
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..resilience import faults
from ..resilience.policy import (ResilientTopicProducer, Retry,
                                 run_with_resubscribe)
from .batch import OBS_KEYS

_log = logging.getLogger(__name__)

__all__ = ["SpeedLayer"]


class SpeedLayer:
    """start()/await_()/close() around the update-topic consumer and the
    micro-batch loop."""

    def __init__(self, config: Config, device=None):
        refuse_configured(config, OBS_KEYS,
                          "the speed layer's observability surface is not "
                          "part of this package yet")
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

    def start(self) -> None:
        _log.info("Starting speed layer (micro-batch %ds)",
                  self.generation_interval_sec)
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
        self._producer.close()

    @property
    def consuming(self) -> bool:
        """True while the update consumer thread runs."""
        return self._consume_thread is not None \
            and self._consume_thread.is_alive()

    def _consume_updates(self) -> None:
        broker = resolve_broker(self.update_broker)
        run_with_resubscribe(
            lambda: self.model_manager.consume(broker.consume(
                self.update_topic, from_beginning=True, stop=self._stop)),
            stop=self._stop, what="speed update consumer", log=_log)

    def _publish_batch(self, in_broker, updates: list[str],
                       ends: list[int]) -> int:
        """Publish one derived micro-batch, then commit the input ends."""
        up_headers = {"ts": str(int(time.time() * 1000))}
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
        t_batch = time.monotonic()
        new_data: list[KeyMessage] = broker.read_ranges(
            self.input_topic, pos, ends)
        updates = list(self.model_manager.build_updates(new_data))
        n_updates = self._publish_batch(broker, updates, ends)
        self.last_micro_batch = {
            "records": len(new_data), "updates": n_updates,
            "seconds": time.monotonic() - t_batch}
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
