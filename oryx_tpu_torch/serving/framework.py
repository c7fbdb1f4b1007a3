"""Framework-level serving resources: model gating and readiness.

Counterpart of ``oryx_tpu/serving/framework.py``, cut down to
``get_serving_model`` and ``/ready`` (reference: Ready.java:34 — 200/503
against min-model-load-fraction; AbstractOryxResource.getServingModel
:76-96).  The metrics, admin and ingest routes wait for later slices.
"""

from __future__ import annotations

from typing import Any

from ..api.serving import OryxServingException
from ..lambda_rt.http import Request, Route

__all__ = ["ROUTES", "get_serving_model"]


def get_serving_model(req: Request) -> Any:
    """The current model, or 503 until enough is loaded."""
    model = req.context["model_manager"].get_model()
    if model is not None:
        fraction = model.get_fraction_loaded()
        if fraction >= req.context["min_model_load_fraction"]:
            return model
    raise OryxServingException(503, "Model not available yet")


def _ready(req: Request):
    get_serving_model(req)
    return None  # empty 204 once a model is servable


ROUTES = [
    Route("GET", "/ready", _ready),
]
