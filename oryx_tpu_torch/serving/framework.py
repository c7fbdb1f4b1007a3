"""Framework-level serving resources: model gating, readiness, the error
page, ``/metrics`` and the ``/admin/*`` routes, and the input-topic
write shared by ``/pref`` and ``/ingest``.

Counterpart of ``oryx_tpu/serving/framework.py`` (reference:
Ready.java:34 — 200/503 against min-model-load-fraction;
AbstractOryxResource.java:52-96 — model gating and sendInput;
ErrorResource.java:36 — the error page), whole.
"""

from __future__ import annotations

import zlib
from typing import Any

from ..api.serving import OryxServingException
from ..common import clock as clockmod
from ..lambda_rt.http import (HtmlResponse, Request, Route, TextResponse,
                              render_error_page)
from ..obs.server import ADMIN_ROUTES, prometheus_response
from ..resilience.policy import CircuitOpenError, resilience_snapshot

__all__ = ["ROUTES", "get_serving_model", "send_input", "send_input_many"]


def get_serving_model(req: Request) -> Any:
    """The current model, or 503 until enough is loaded."""
    model = req.context["model_manager"].get_model()
    if model is not None:
        fraction = model.get_fraction_loaded()
        if fraction >= req.context["min_model_load_fraction"]:
            return model
    raise OryxServingException(503, "Model not available yet")


def send_input(req: Request, line: str) -> None:
    send_input_many(req, [line])


def send_input_many(req: Request, lines: list[str]) -> None:
    """Durably append ``lines`` to the input topic in one pipelined
    produce.  A normal return means every record is in the input topic;
    a broker fault or an open breaker maps to 503 (retry), never a
    silent partial write, and no input topic to 403.  The ingest gate
    (serving/ingest.py) sheds here, on the write path only."""
    producer = req.context.get("input_producer")
    if producer is None:
        raise OryxServingException(403, "no input topic configured")
    # per-record headers: `ts` stamps the ingest wall clock, from which
    # the speed layer measures ingest-to-servable freshness; a sampled
    # request's `traceparent` lets the fold-in that makes each record
    # servable join its trace
    headers = {"ts": str(int(clockmod.now() * 1000))}
    tracer = req.context.get("tracer")
    if tracer is not None:
        cur = tracer.current()
        if cur.sampled:
            headers["traceparent"] = cur.traceparent()
    # key = hash of the message, so identical records land in the same
    # partition (reference: AbstractOryxResource.sendInput :68 sends
    # Integer.toHexString(message.hashCode()))
    entries = [(format(zlib.crc32(line.encode("utf-8")), "x"), line,
                dict(headers)) for line in lines]
    gate = req.context.get("ingest_gate")
    try:
        if gate is not None:
            with gate.admitted(req.context.get("metrics"), n=len(entries)):
                _produce(producer, entries)
        else:
            _produce(producer, entries)
    except OryxServingException:
        raise  # the gate's shed (503 + Retry-After) passes through
    except CircuitOpenError as e:
        # the broker is presumed down: fast 503s until the breaker's
        # half-open probe restores the write path
        raise OryxServingException(503, f"input unavailable: {e}") from e
    except Exception as e:  # noqa: BLE001 — any broker fault degrades
        raise OryxServingException(
            503, f"input send failed: {e}") from e


def _produce(producer, entries: list[tuple[str, str, dict]]) -> None:
    if len(entries) == 1:
        key, line, headers = entries[0]
        producer.send(key, line, headers=headers)
    else:
        producer.send_many(entries)


def _ready(req: Request):
    get_serving_model(req)
    return None  # empty 204 once a model is servable


def _error(req: Request):
    """The addressable form of the error page every errored request
    gets, from the status, URI and message in the query string
    (reference: ErrorResource.java:36)."""
    code = req.q1("code", "")
    status = int(code) if code and code.isdigit() else 200
    payload, ctype = render_error_page(
        status, req.q1("uri"), req.q1("message"),
        req.headers.get("Accept", ""))
    if ctype.startswith("text/html"):
        return status, HtmlResponse(payload.decode())
    return status, TextResponse(payload.decode())


def _metrics(req: Request):
    """Per-route request counts, error counts and latency percentiles,
    the batcher's pacing state, the model's own metrics (the streaming
    top-k's fallbacks, the kernel route), the resilience counters, the
    freshness gauges and the device-time accounting; the Prometheus,
    OpenMetrics and mergeable-JSON forms by ``?format=``."""
    registry = req.context.get("metrics")
    if registry is None:
        raise OryxServingException(404, "metrics not enabled")
    prom = prometheus_response(req, registry)
    if prom is not None:
        return prom
    manager = req.context["model_manager"]
    model = manager.get_model()
    out = {
        "routes": registry.snapshot(),
        "model_fraction_loaded":
            model.get_fraction_loaded() if model is not None else 0.0,
    }
    batcher = req.context.get("top_n_batcher")
    if batcher is not None:
        out["scoring_batcher"] = batcher.stats()
    counters = registry.counters_snapshot()
    if counters:
        out["counters"] = counters
    if getattr(manager, "shard_count", 1) > 1 \
            or hasattr(manager, "generation"):
        cluster = {"generation": getattr(manager, "generation", 0)}
        if getattr(manager, "shard_count", 1) > 1:
            cluster.update(shard=manager.shard_index,
                           of=manager.shard_count,
                           skipped_remote_items=getattr(
                               manager, "skipped_remote_items", 0))
        out["cluster"] = cluster
    # named retry / circuit-breaker counters (resilience/policy.py)
    out["resilience"] = resilience_snapshot()
    # a serving model may contribute its own gauges (the ALS model's
    # streaming top-k fallbacks and its kernel route)
    app_metrics = getattr(model, "metrics", None)
    if callable(app_metrics):
        out["model_metrics"] = app_metrics()
    # the poison updates and corrupt model documents the manager refused
    rejected_updates = getattr(manager, "rejected_updates", None)
    if rejected_updates is not None:
        out["model_integrity"] = {
            "rejected_updates": rejected_updates,
            "rejected_models": getattr(manager, "rejected_models", 0),
        }
    # the freshness gauges (obs/freshness.py), evaluated on read
    gauges = registry.gauges_snapshot()
    if gauges:
        out["freshness"] = gauges
    tracer = req.context.get("tracer")
    if tracer is not None:
        out["obs"] = {"trace_record_failures": tracer.record_failures}
    # which kernel route owned the card, and how busy it is
    acct = req.context.get("device_time")
    if acct is not None:
        out["device_time"] = acct.snapshot()
    return out


ROUTES = [
    Route("GET", "/ready", _ready),
    Route("GET", "/error", _error),
    Route("GET", "/metrics", _metrics),
    # /admin/{traces,tail,slo,region,flight,diagnose,profile} and
    # POST /admin/flight/dump (obs/server.py); each 404s until its
    # config gate opens, and profile and dump are mutating routes
    *ADMIN_ROUTES,
]
