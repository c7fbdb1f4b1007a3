"""The clustering routes.

Counterpart of ``oryx_tpu/serving/clustering.py`` (reference:
Assign.java:52 — GET /assign/{datum} and the POSTed batch; Add.java:43 —
a datum onto the input topic; DistanceToNearest.java:40), with the
reference's console page.
"""

from __future__ import annotations

from ..api.serving import OryxServingException
from ..app.kmeans.common import features_from_tokens
from ..common import text as text_utils
from ..lambda_rt.http import Request, Route
from . import console
from .framework import get_serving_model, send_input

__all__ = ["ROUTES"]


def _tokens(datum: str) -> list[str]:
    if not datum:
        raise OryxServingException(400, "Data is needed to cluster")
    return text_utils.parse_delimited(datum, ",")


def _lines(req: Request) -> list[str]:
    return [ln.strip() for ln in req.body.decode().splitlines()
            if ln.strip()]


def _assign_get(req: Request):
    model = get_serving_model(req)
    try:
        return str(model.nearest_cluster_id(_tokens(req.params["datum"])))
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))


def _assign_post(req: Request):
    """Assignment of every POSTed line in one product on the device."""
    model = get_serving_model(req)
    rows = [_tokens(ln) for ln in _lines(req)]
    try:
        return [str(i) for i in model.nearest_cluster_ids(rows)]
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))


def _add(req: Request):
    get_serving_model(req)  # 503 until a model is loaded
    datum = req.params["datum"]
    if not datum:
        raise OryxServingException(400, "Data is needed")
    send_input(req, datum)
    return None


def _add_post(req: Request):
    get_serving_model(req)
    for line in _lines(req):
        send_input(req, line)
    return None


def _distance_to_nearest(req: Request):
    model = get_serving_model(req)
    try:
        vec = features_from_tokens(_tokens(req.params["datum"]),
                                   model.input_schema)
        _, dist = model.closest_cluster(vec)
    except (ValueError, KeyError) as e:
        raise OryxServingException(400, str(e))
    return str(dist)


ROUTES = [
    Route("GET", "/assign/{datum}", _assign_get),
    Route("POST", "/assign", _assign_post),
    Route("GET", "/add/{datum}", _add),
    Route("POST", "/add", _add_post),
    Route("GET", "/distanceToNearest/{datum}", _distance_to_nearest),
    console.console_route("k-means Clustering", [
        console.Endpoint("/assign/{0}", ("datum (CSV)",)),
        console.Endpoint("/distanceToNearest/{0}", ("datum (CSV)",)),
        console.Endpoint("/add/{0}", ("datum (CSV)",)),
        console.Endpoint("/ready"),
    ]),
]
