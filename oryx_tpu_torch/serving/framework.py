"""Framework-level serving resources: model gating, readiness, the error
page, and the input-topic write shared by ``/pref`` and ``/ingest``.

Counterpart of ``oryx_tpu/serving/framework.py`` (reference:
Ready.java:34 — 200/503 against min-model-load-fraction;
AbstractOryxResource.java:52-96 — model gating and sendInput;
ErrorResource.java:36 — the error page).  The metrics and admin routes
wait for a later slice, and so does the ``traceparent`` record header.
"""

from __future__ import annotations

import time
import zlib
from typing import Any

from ..api.serving import OryxServingException
from ..lambda_rt.http import (HtmlResponse, Request, Route, TextResponse,
                              render_error_page)
from ..resilience.policy import CircuitOpenError

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
    # per-record header: `ts` stamps the ingest wall clock, from which
    # the speed layer measures ingest-to-servable freshness
    headers = {"ts": str(int(time.time() * 1000))}
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


ROUTES = [
    Route("GET", "/ready", _ready),
    Route("GET", "/error", _error),
]
