"""ALS serving REST resources: the routes that go through the request
batcher.

Counterpart of ``oryx_tpu/serving/als.py`` (reference:
app/oryx-app-serving/.../serving/als/Recommend.java:74-113,
RecommendToMany.java:57, KnownItems.java:35, DTO IDValue), cut down to
``/recommend/{userID}``, ``/recommendToMany/{userIDs:+}`` and
``/knownItems/{userID}``.

howMany/offset behaviour follows Recommend: compute howMany+offset
results, return the slice [offset, offset+howMany).
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from ..api.serving import OryxServingException
from ..app.als.serving_model import ALSServingModel
from ..lambda_rt.http import Request, Route
from .framework import get_serving_model

__all__ = ["ROUTES", "IDValue"]


@dataclasses.dataclass
class IDValue:
    """Response DTO (reference: IDValue.java:21, HasCSV)."""

    id: str
    value: float

    def to_csv(self) -> str:
        return f"{self.id},{self.value}"

    def to_json_fragment(self) -> str:
        # hand-built: json.encoder C-escapes the id; float repr IS the
        # JSON float form for finite scores; non-finite scores keep
        # json.dumps' spelling, which repr would break
        v = float(self.value)
        if not math.isfinite(v):
            return json.dumps({"id": self.id, "value": v},
                              separators=(",", ":"))
        return f'{{"id":{json.dumps(self.id)},"value":{v!r}}}'


def _als_model(req: Request) -> ALSServingModel:
    model = get_serving_model(req)
    if not isinstance(model, ALSServingModel):
        raise OryxServingException(503, "Model not available yet")
    return model


def _how_many_offset(req: Request) -> tuple[int, int]:
    how_many = req.q_int("howMany", 10)
    offset = req.q_int("offset", 0)
    if how_many <= 0:
        raise OryxServingException(400, "howMany must be positive")
    if offset < 0:
        raise OryxServingException(400, "offset must be non-negative")
    return how_many, offset


def _slice(pairs: list[tuple[str, float]], how_many: int,
           offset: int) -> list[IDValue]:
    return [IDValue(i, v) for i, v in pairs[offset:offset + how_many]]


def _check_exists(cond: bool, what: str) -> None:
    if not cond:
        raise OryxServingException(404, what)


def _rescorer(model: ALSServingModel, hook: str, req: Request, *args):
    provider = model.rescorer_provider
    if provider is None:
        return None
    return getattr(provider, hook)(*args, req.q_list("rescorerParams"))


def _dot_top_n(req: Request, model: ALSServingModel, how_many: int,
               user_vector: np.ndarray, exclude: set[str],
               rescorer) -> list[tuple[str, float]]:
    """Dot-product top-N, coalesced with concurrent requests through the
    app-scope TopNBatcher unless a rescorer plugin forces the exact
    single-request path."""
    batcher = req.context.get("top_n_batcher")
    if batcher is not None and rescorer is None:
        # the front-end deadline rides into the batcher queue: expired
        # work is shed as 503 instead of occupying a device dispatch
        return batcher.top_n(model, how_many, user_vector, exclude,
                             deadline=req.deadline)
    if req.deadline is not None:
        req.deadline.check("top_n")
    return model.top_n(how_many, user_vector=user_vector, exclude=exclude,
                       rescorer=rescorer)


def _recommend(req: Request):
    model = _als_model(req)
    user_id = req.params["userID"]
    how_many, offset = _how_many_offset(req)
    consider_known = (req.q1("considerKnownItems", "false") == "true")
    user_vector = model.get_user_vector(user_id)
    _check_exists(user_vector is not None, user_id)
    exclude = set() if consider_known else model.get_known_items(user_id)
    rescorer = _rescorer(model, "get_recommend_rescorer", req, user_id)
    pairs = _dot_top_n(req, model, how_many + offset, user_vector,
                       exclude, rescorer)
    return _slice(pairs, how_many, offset)


def _recommend_to_many(req: Request):
    model = _als_model(req)
    user_ids = req.params["userIDs"].split("/")
    how_many, offset = _how_many_offset(req)
    consider_known = (req.q1("considerKnownItems", "false") == "true")
    vectors, exclude = [], set()
    for uid in user_ids:
        v = model.get_user_vector(uid)
        if v is not None:
            vectors.append(v)
            if not consider_known:
                exclude |= model.get_known_items(uid)
    _check_exists(bool(vectors), str(user_ids))
    mean_vector = np.mean(vectors, axis=0)
    rescorer = _rescorer(model, "get_recommend_rescorer", req, user_ids[0])
    pairs = _dot_top_n(req, model, how_many + offset, mean_vector,
                       exclude, rescorer)
    return _slice(pairs, how_many, offset)


def _known_items(req: Request):
    model = _als_model(req)
    return sorted(model.get_known_items(req.params["userID"]))


ROUTES = [
    Route("GET", "/recommend/{userID}", _recommend),
    Route("GET", "/recommendToMany/{userIDs:+}", _recommend_to_many),
    Route("GET", "/knownItems/{userID}", _known_items),
]
