"""The batch layer: periodic model-rebuild generations over all data.

Counterpart of ``oryx_tpu/lambda_rt/batch.py`` (reference:
BatchLayer.java:48-206 — per generation interval: run the update over
(new, past) data (BatchUpdateFunction.java:50-171), persist the new
data (SaveToHDFSFunction), commit the offsets (UpdateOffsetsFn), and
TTL-delete old data and models (DeleteOldDataFn)).  A host-side
generation loop hands the data to the configured ``BatchLayerUpdate``
(a class of this package), whose training runs on ``device`` (None
means ``cuda``).  The layer serves no public HTTP: its freshness gauges
(``input_lag_records``, ``batch_generation_age_sec`` and the last
generation's duration and records), traces and flight recorder answer
on the side-door ``ObsServer`` at ``oryx.obs.metrics-port``, as the
reference's do.
"""

from __future__ import annotations

import logging
import threading
import time

from ..common import compile_cache
from ..common.config import Config
from ..common.device import bound, thread_card
from ..common.lang import load_instance
from ..kafka import utils as kafka_utils
from ..kafka.api import KeyMessage
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..obs import flight_from_config, freshness, tracer_from_config
from ..obs.server import ObsServer
from ..resilience import faults
from . import data_store
from .metrics import MetricsRegistry

_log = logging.getLogger(__name__)

__all__ = ["BatchLayer"]


class BatchLayer:
    """start()/await_()/close() around the generation loop.  ``device``
    (None means ``cuda``) goes to the update class, which trains there."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.id = config.get_optional_string("oryx.id")
        self.input_broker = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")
        self.update_broker = config.get_optional_string(
            "oryx.update-topic.broker")
        self.update_topic = config.get_optional_string(
            "oryx.update-topic.message.topic")
        self.generation_interval_sec = config.get_int(
            "oryx.batch.streaming.generation-interval-sec")
        self.data_dir = config.get_string("oryx.batch.storage.data-dir")
        self.model_dir = config.get_string("oryx.batch.storage.model-dir")
        self.max_age_data_hours = config.get_int(
            "oryx.batch.storage.max-age-data-hours")
        self.max_age_model_hours = config.get_int(
            "oryx.batch.storage.max-age-model-hours")
        update_class = config.get_string("oryx.batch.update-class")
        self.update_instance = load_instance(update_class, config, device)
        # the card the generation thread makes current
        self.thread_card = thread_card(device)
        self._group = f"OryxGroup-BatchLayer-{self.id or 'default'}"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # config-staged chaos (oryx.resilience.faults.*); empty = no-op
        faults.configure_from_config(config)
        # the last generation's count of new input records
        self.last_generation_records = 0
        # the freshness surface, read through the side door: the batch
        # cadence seen from the producing side (the consuming layers
        # report their own model_generation_age_sec)
        self.metrics = MetricsRegistry()
        self._last_generation_mono: float | None = None
        self.metrics.gauge_fn(
            "input_lag_records",
            freshness.group_lag_fn(self.input_broker, self.input_topic,
                                   self._group))
        self.metrics.gauge_fn("batch_generation_age_sec",
                              self._generation_age_sec)
        # flight recorder (obs/flight.py; None until the config gate
        # opens): a chaos fault mid-generation leaves a bundle
        self.flight = flight_from_config(config, "batch", self.metrics)
        self.obs_server = ObsServer(config, self.metrics,
                                    tracer_from_config(config, "batch"),
                                    extra_context={"flight": self.flight})

    def _generation_age_sec(self) -> float | None:
        t = self._last_generation_mono
        return None if t is None else round(time.monotonic() - t, 3)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        _log.info("Starting batch layer (generation interval %ds)",
                  self.generation_interval_sec)
        self.obs_server.start()
        compile_cache.enable_from_config(self.config)
        # create the input topic at its configured partition count before
        # any lazy access can freeze it at one partition
        kafka_utils.maybe_create_topic(
            self.input_broker, self.input_topic,
            partitions=kafka_utils.input_topic_partitions(self.config))
        self._thread = threading.Thread(
            target=bound(self._loop, self.thread_card), daemon=True,
            name="BatchLayer")
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

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_one_generation()
            except Exception:  # noqa: BLE001 — a generation failure must
                _log.exception("Generation failed")  # not kill the layer
            self._stop.wait(self.generation_interval_sec)

    # -- one generation ------------------------------------------------------

    def _recover_offsets(self, broker) -> None:
        """Crash recovery: complete an interrupted offset commit.

        Each generation file carries the input end offsets it covers in
        its header (the same atomic rename as the data).  When the
        newest saved generation ends past the committed offsets, the
        previous process died between its save and its commit: those
        records are durable as past data already, so the commit is
        advanced to the saved ends instead of reading them again as new
        input.  It never rewinds."""
        saved = data_store.last_saved_offsets(self.data_dir)
        ends = (saved or {}).get(self.input_topic)
        if not ends:
            return
        committed = broker.get_offsets(self._group, self.input_topic)
        if len(committed) != len(ends):
            return  # partition layout changed: offsets not comparable
        merged = [max(e, c if c is not None else 0)
                  for e, c in zip(ends, committed)]
        if merged != [c if c is not None else 0 for c in committed]:
            _log.warning(
                "Recovering interrupted offset commit for %s: %s -> %s",
                self.input_topic, committed, merged)
            broker.set_offsets(self._group, self.input_topic, merged)
            broker.flush()

    def run_one_generation(self) -> None:
        """Drain new input, run the update over (new, past), persist the
        new input, then commit the offsets and apply the TTLs: the commit
        order gives at-least-once with idempotent overwrite (the
        reference's semantics)."""
        timestamp_ms = int(time.time() * 1000)
        t_gen = time.monotonic()
        broker = resolve_broker(self.input_broker)
        self._recover_offsets(broker)
        # per-partition offsets; the first run reads each partition from
        # the beginning, the partitions drain concurrently
        starts = [s if s is not None else 0
                  for s in broker.get_offsets(self._group, self.input_topic)]
        ends = broker.latest_offsets(self.input_topic)
        new_data: list[KeyMessage] = broker.read_ranges(
            self.input_topic, starts, ends)
        past_data = data_store.read_all_data(self.data_dir)

        producer = None
        if self.update_broker and self.update_topic:
            producer = InProcTopicProducer(self.update_broker,
                                           self.update_topic)
        _log.info("Running update at %d: %d new, %d past records",
                  timestamp_ms, len(new_data), len(past_data))
        # the update runs before the generation is persisted (the
        # reference's output order, BatchLayer.java:111-130): a failed
        # update leaves neither a data file nor committed offsets, so the
        # retry sees exactly the same (new, past) split
        self.update_instance.run_update(timestamp_ms, new_data, past_data,
                                        self.model_dir, producer)
        # chaos seam: die after the model was published but before the
        # generation is durable — the retry must reprocess the same input
        faults.fire("batch-crash-after-update")
        data_store.save_generation(self.data_dir, timestamp_ms, new_data,
                                   end_offsets={self.input_topic: ends})
        # chaos seam: die between the durable save and the offset
        # commit — the window _recover_offsets exists for
        faults.fire("batch-crash-before-commit")
        # offsets commit only after the update completed (at-least-once)
        broker.set_offsets(self._group, self.input_topic, ends)
        broker.flush()
        faults.fire("batch-crash-after-commit")

        data_store.delete_old_data(self.data_dir, self.max_age_data_hours)
        data_store.delete_old_models(self.model_dir, self.max_age_model_hours)
        self.last_generation_records = len(new_data)
        # freshness bookkeeping only after the generation fully landed
        self._last_generation_mono = time.monotonic()
        self.metrics.set_gauge(
            "batch_generation_duration_ms",
            round((self._last_generation_mono - t_gen) * 1000.0, 3))
        self.metrics.set_gauge("batch_generation_records", len(new_data))
