"""The serving layer: the HTTP API over an in-memory model fed by the
update topic.

Counterpart of ``oryx_tpu/lambda_rt/serving.py`` (reference:
ServingLayer.java:58-339, ModelManagerListener.java:63-250 — the
input producer, and the update-topic consumer from offset 0 feeding
``modelManager.consume``; OryxApplication.java:41-98 — resources from
the configured modules).  The layer loads its model manager from
``oryx.serving.model-manager-class`` (a class of this package), replays
the update topic from offset 0 on a thread, and serves the framework
routes plus those of ``oryx.serving.application-resources`` through
``HttpApp`` and the ``TopNBatcher``.  Unless ``read-only`` is set, a
configured input topic is created at start with
``oryx.input-topic.partitions`` partitions, and ``/pref`` and
``/ingest`` append to it through a producer with retry and a circuit
breaker, behind the ingest admission gate.  The observability surface is the
reference's: the metrics registry behind ``/metrics``, device-time
accounting, the freshness and model-load gauges, and, each behind its
``oryx.obs.*`` gate, tracing, the SLO engine, the wide-event log, the
flight recorder and ``/admin/profile``.  Not part of this package yet:
TLS and authentication (a configured keystore, user name or password
raises) and the serving cluster (``oryx.cluster.enabled`` raises: the
``/shard/*`` routes, heartbeats, the frame transport and the result
cache).
"""

from __future__ import annotations

import importlib
import logging
import threading

from ..common import compile_cache
from ..common.config import refuse_configured
from ..common.lang import load_instance, logging_call
from ..kafka import utils as kafka_utils
from ..kafka.inproc import InProcTopicProducer, resolve_broker
from ..obs import (DeviceTimeAccountant, engine_from_config,
                   events_from_config, flight_from_config, freshness,
                   install_process_accountant, tracer_from_config)
from ..obs import profile as profile_mod
from ..resilience import faults
from ..resilience.policy import (CircuitBreaker, ResilientTopicProducer,
                                 Retry, run_with_resubscribe)
from ..serving.batcher import TopNBatcher
from ..serving.ingest import IngestGate
from .http import HttpApp, Route, make_server
from .metrics import MetricsRegistry

_log = logging.getLogger(__name__)

__all__ = ["ServingLayer", "UNPORTED_CLUSTER_KEYS"]

# keys of the reference's layer whose features this package does not
# have yet: each raises by name rather than being quietly ignored
UNPORTED_CLUSTER_KEYS = ("oryx.cluster.enabled",)


class ServingLayer:
    """start()/await_()/close() around the HTTP server and the model
    consumer.  ``port`` overrides ``oryx.serving.api.port`` (0 picks a
    free one); ``device`` (None means ``cuda``) goes to the model
    manager, which builds its models there."""

    def __init__(self, config, port: int | None = None, device=None):
        self.config = config
        api = "oryx.serving.api"
        for key in ("keystore-file", "user-name", "password"):
            if config.get_optional_string(f"{api}.{key}") is not None:
                raise ValueError(f"{api}.{key}: TLS and authentication are "
                                 f"not part of this package yet")
        refuse_configured(config, UNPORTED_CLUSTER_KEYS,
                          "the serving cluster (/shard routes, heartbeats, "
                          "frame transport) is not part of this package yet")
        self.port = port if port is not None else config.get_int(
            f"{api}.port")
        self.read_only = config.get_bool(f"{api}.read-only")
        self.context_path = config.get_string(f"{api}.context-path")
        self.input_broker = config.get_optional_string(
            "oryx.input-topic.broker")
        self.input_topic = config.get_optional_string(
            "oryx.input-topic.message.topic")
        self.update_broker = config.get_optional_string(
            "oryx.update-topic.broker")
        self.update_topic = config.get_optional_string(
            "oryx.update-topic.message.topic")
        self.no_init_topics = config.get_bool("oryx.serving.no-init-topics")
        self.min_model_load_fraction = config.get_double(
            "oryx.serving.min-model-load-fraction")
        manager_class = config.get_string("oryx.serving.model-manager-class")
        self.model_manager = load_instance(manager_class, config, device)

        self._stop = threading.Event()
        self._consume_thread: threading.Thread | None = None
        self._server = None
        self._server_thread: threading.Thread | None = None

        faults.configure_from_config(config)
        # the write path: a dead input broker degrades /pref and /ingest
        # to fast 503s through the breaker, whose half-open probe
        # restores them without a restart
        self.input_producer = None
        if not self.read_only and self.input_broker and self.input_topic:
            if not self.no_init_topics:
                kafka_utils.maybe_create_topic(
                    self.input_broker, self.input_topic,
                    partitions=kafka_utils.input_topic_partitions(config))
            self.input_producer = ResilientTopicProducer(
                InProcTopicProducer(self.input_broker, self.input_topic),
                retry=Retry.from_config("serving-input-send", config),
                breaker=CircuitBreaker.from_config("serving-input", config))
        # write-path admission (both gates 0 = off): 503 + Retry-After
        # around the produce only, never a silently dropped record
        self.ingest_gate = IngestGate(config)
        if not self.ingest_gate.enabled:
            self.ingest_gate = None
        idle_ms = config.get_int(f"{api}.batch-idle-wait-ms")
        # sampled tracing (obs/trace.py; None = disabled): the request
        # span starts at the HTTP dispatcher, the batcher splits
        # queue-wait from device-execute under it
        self.tracer = tracer_from_config(config, "serving")
        self.metrics = MetricsRegistry()
        # continuous device-time accounting (obs/device_time.py): the
        # batcher books serve-class brackets, the kernel router books
        # its measure-class sweeps through the process-level hook
        self.device_time = DeviceTimeAccountant(self.metrics)
        install_process_accountant(self.device_time)
        self.top_n_batcher = TopNBatcher(
            max_batch=config.get_int(f"{api}.max-batch"),
            pipeline=config.get_int(f"{api}.scoring-pipeline-depth"),
            idle_wait_s=None if idle_ms < 0 else idle_ms / 1000.0,
            tracer=self.tracer, accountant=self.device_time)
        self._register_gauges()
        # SLO burn-rate engine (obs/slo.py; None = disabled): evaluated
        # lazily whenever the gauges are read, alert state at /admin/slo
        self.slo_engine = engine_from_config(config, self.metrics)
        if self.slo_engine is not None:
            self.metrics.gauge_fn("slo_burn_rate",
                                  self.slo_engine.burn_gauge)
            self.metrics.gauge_fn("slo_error_budget_remaining",
                                  self.slo_engine.budget_gauge)
        # wide-event request log (obs/events.py; None = disabled)
        self.events = events_from_config(config, "serving", self.metrics)
        if self.events is not None and hasattr(self.model_manager,
                                               "model_load_s"):
            # a request served while the ANN index had failed closed
            # carries the fallback count
            mgr = self.model_manager

            def _event_context() -> dict:
                n = int(getattr(mgr, "ann_index_fallbacks", 0) or 0)
                return {"ann_index_fallbacks": n} if n else {}

            self.events.context_fn = _event_context
        # flight recorder (obs/flight.py; None until oryx.obs.flight.dir
        # opens the gate): black-box rings + anomaly-triggered bundles
        self.flight = flight_from_config(
            config, "serving", self.metrics, slo=self.slo_engine,
            accountant=self.device_time)
        if self.flight is not None and self.slo_engine is not None:
            flight = self.flight
            # a page transition -> one debounced bundle; the callback
            # runs with the SLO lock held and trigger() never re-enters
            # the engine (the bundle reads last_status, lock-free)
            self.slo_engine.on_page = lambda name, st: flight.trigger(
                "slo-page", {"objective": name,
                             "burn_5m": st.get("burn_5m")})
        self.app = HttpApp(
            self._discover_routes(),
            context={
                "model_manager": self.model_manager,
                "input_producer": self.input_producer,
                "ingest_gate": self.ingest_gate,
                "config": config,
                "min_model_load_fraction": self.min_model_load_fraction,
                "top_n_batcher": self.top_n_batcher,
                "metrics": self.metrics,
                "tracer": self.tracer,
                "slo": self.slo_engine,
                "events": self.events,
                "flight": self.flight,
                "device_time": self.device_time,
            },
            read_only=self.read_only,
            context_path=self.context_path,
            request_deadline_ms=config.get_int(
                "oryx.resilience.request-deadline-ms"))

    def _register_gauges(self) -> None:
        """The freshness gauges (update-consumer lag and model generation
        age, from a passive tap on the replay) and the model-load and
        ANN-index gauges of a manager that has them."""
        self._update_tap = freshness.UpdateStreamTap()
        if self.update_broker and self.update_topic:
            self.metrics.gauge_fn(
                "update_lag_records",
                freshness.topic_lag_fn(self.update_broker,
                                       self.update_topic,
                                       lambda: self._update_tap.consumed))
            self.metrics.gauge_fn("model_generation_age_sec",
                                  self._update_tap.model_age_sec)
        if hasattr(self.model_manager, "model_load_s"):
            mgr = self.model_manager
            self.metrics.gauge_fn(
                "model_load_s", lambda: float(mgr.model_load_s))
            self.metrics.gauge_fn(
                "model_slice_bytes", lambda: float(mgr.model_slice_bytes))
            self.metrics.gauge_fn(
                "slice_load_fallbacks",
                lambda: float(mgr.slice_load_fallbacks))
            self.metrics.gauge_fn(
                "ann_index_bytes",
                lambda: float(getattr(mgr, "ann_index_bytes", 0)))
            self.metrics.gauge_fn(
                "ann_index_fallbacks",
                lambda: float(getattr(mgr, "ann_index_fallbacks", 0)))

    def _discover_routes(self) -> list[Route]:
        """The framework routes plus the ``ROUTES`` of every module named
        in ``oryx.serving.application-resources`` (modules of this
        package)."""
        from ..serving import framework as framework_resources
        routes: list[Route] = list(framework_resources.ROUTES)
        resources = self.config.get_optional_string(
            "oryx.serving.application-resources")
        package = __name__.split(".")[0]
        if resources:
            for module_name in resources.split(","):
                module_name = module_name.strip()
                if module_name.split(".")[0] != package:
                    raise ValueError(
                        f"application resource {module_name!r} is not "
                        f"part of {package}")
                module = importlib.import_module(module_name)
                routes.extend(getattr(module, "ROUTES"))
        return routes

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        # the kernels this layer's model builds at first use load from
        # oryx.compile-cache-dir when an earlier process built them
        compile_cache.enable_from_config(self.config)
        if self.update_broker and self.update_topic:
            if not self.no_init_topics:
                kafka_utils.maybe_create_topic(self.update_broker,
                                               self.update_topic)
            # model state = full update-topic replay from offset 0
            # (reference: ModelManagerListener.java:126)
            self._consume_thread = threading.Thread(
                target=logging_call(self._consume_updates,
                                    "serving-consume"),
                daemon=True, name="ServingLayerConsume")
            self._consume_thread.start()
        if self.config.get_optional_string("oryx.obs.profile-dir"):
            # /admin/profile captures on a handler's thread
            profile_mod.prime()
        self._server = make_server(self.app, self.port)
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ServingLayerHTTP")
        self._server_thread.start()
        _log.info("Serving layer listening on port %d", self.port)

    def _consume_updates(self) -> None:
        # a failure mid-tail resubscribes with backoff and replays from
        # offset 0: recovery is the cold-start path
        broker = resolve_broker(self.update_broker)
        # the freshness tap counts the raw records, to compare with the
        # topic head's offsets
        run_with_resubscribe(
            lambda: self.model_manager.consume(self._update_tap.wrap(
                broker.consume(self.update_topic, from_beginning=True,
                               stop=self._stop))),
            stop=self._stop, what="serving update consumer", log=_log)

    @property
    def consuming(self) -> bool:
        """True while the update consumer thread runs."""
        return self._consume_thread is not None \
            and self._consume_thread.is_alive()

    def await_(self) -> None:
        while self._server_thread and self._server_thread.is_alive():
            self._server_thread.join(1.0)

    def close(self) -> None:
        self._stop.set()
        if self._server:
            self._server.shutdown()
            self._server.server_close()
        self.top_n_batcher.close()
        if self.flight is not None:
            self.flight.close()
        if self.events is not None:
            self.events.close()
        self.model_manager.close()
        if self.input_producer:
            self.input_producer.close()
        for t in (self._consume_thread, self._server_thread):
            if t:
                t.join(10.0)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
